"""Evaluation capture in the port (``algos/ppo._eval_capture`` /
``_eval_capture_poses``, the envs' ``scene_pose``, the video frame's
camera and primitives) against the JAX package's, on the CPU:

* ``scene_pose`` of grasp_cube and open_drawer on identical random states
  (rot / pos atol 1e-5: one FK in f32);
* the pose files of a 4-env × 5-step captured evaluation (grasp_cube,
  fixed reset, the same f32 MLP weights in both runners): the same files,
  keys, shapes and success flags, values within 1e-4 (five control steps
  of a freely moving arm, re-associated f32 sums);
* the video frame: ``raymarch.render_rgb`` of one env's primitives (the
  tensor fields sliced, the bool ``ground`` kept) at the video camera
  against the JAX package's ``render_rgb`` on the same prims, both through
  the unculled exact march, at 32×64: colours within 1e-4 on 99.5 % of
  pixels (a pixel at a segment's edge may take the neighbour's colour)."""

import os
import random
from types import SimpleNamespace

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import _torch_port as tp
from partmanip_tpu import config as jconfig
from partmanip_tpu_torch import config as tconfig
from partmanip_tpu_torch.algos import ppo as tppo
from partmanip_tpu_torch.utils import convert

E = 4


def _states(name, rs, tenv):
    """Random robot and object states near the envs' defaults, as numpy."""
    D = tenv.default_dof.shape[0]
    robot = {"qpos": (np.tile(tenv.default_dof, (E, 1)) + rs.uniform(-0.3, 0.3, (E, D))),
             "qvel": np.zeros((E, D)), "root_pos": rs.uniform(-0.1, 0.1, (E, 3)),
             "root_quat": np.tile([0.0, 0, 0, 1], (E, 1))}
    q = rs.normal(size=(E, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    if name == "grasp_cube":
        part = {"pos": rs.uniform(-0.2, 0.2, (E, 3)), "quat": q,
                "linvel": np.zeros((E, 3)), "angvel": np.zeros((E, 3))}
    else:
        Do = tenv.scene.obj_tree.dof_mask.shape[-1]
        part = {"qpos": rs.uniform(0, 0.2, (E, Do)), "qvel": np.zeros((E, Do)),
                "root_pos": rs.uniform(-0.7, -0.5, (E, 3)), "root_quat": q}
    f32 = lambda d: {k: np.asarray(v, np.float32) for k, v in d.items()}
    return f32(robot), f32(part)


@pytest.mark.parametrize("name", ["grasp_cube", "open_drawer"])
def test_scene_pose_matches_jax(tmp_path, name):
    from partmanip_tpu.envs.grasp_cube import GraspCubeEnv as JCube
    from partmanip_tpu.envs.open_drawer import OpenDrawerEnv as JDrawer
    from partmanip_tpu.sim import engine as jengine
    from partmanip_tpu.sim.types import FreeBodyState as JBody, TreeState as JTree
    from partmanip_tpu_torch.envs.grasp_cube import GraspCubeEnv as TCube
    from partmanip_tpu_torch.envs.open_drawer import OpenDrawerEnv as TDrawer
    from partmanip_tpu_torch.sim import engine as tengine
    from partmanip_tpu_torch.sim.types import FreeBodyState, TreeState
    flags = ["--taskcfg", name, "--algo.num_envs", str(E)]
    if name == "open_drawer":
        flags += ["--task.asset.num_objects", "2", "--task.asset.assetRoot", str(tmp_path)]
    jcfg, jsp = jconfig.process_cfgs(list(flags))
    tcfg, tsp = tconfig.process_cfgs(list(flags))
    random.seed(1)
    jenv = (JCube if name == "grasp_cube" else JDrawer)(jcfg["task"], jsp)
    random.seed(1)
    tenv = (TCube if name == "grasp_cube" else TDrawer)(tcfg["task"], tsp, device="cpu")
    robot, part = _states(name, np.random.RandomState(2), tenv)
    jt = lambda cls, d: cls(**{k: jnp.asarray(v) for k, v in d.items()})
    tt = lambda cls, d: cls(**{k: torch.as_tensor(v) for k, v in d.items()})
    if name == "grasp_cube":
        jsim = jengine.SceneState(robot=jt(JTree, robot), body=jt(JBody, part))
        tsim = tengine.SceneState(robot=tt(TreeState, robot), body=tt(FreeBodyState, part))
    else:
        jsim = jengine.SceneState(robot=jt(JTree, robot), obj=jt(JTree, part))
        tsim = tengine.SceneState(robot=tt(TreeState, robot), obj=tt(TreeState, part))
    want = jax.jit(lambda s: jenv.scene_pose(SimpleNamespace(sim=s)))(jsim)
    got = tenv.scene_pose(SimpleNamespace(sim=tsim))
    assert set(got) == {"rot", "pos"}
    assert got["rot"].shape == (E, 12, 3, 3) and got["pos"].shape == (E, 12, 3)
    for k in ("rot", "pos"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got["pos"][:, -1].numpy(),
                                  part["pos" if name == "grasp_cube" else "root_pos"])


def _capture_flags(root):
    return ["--taskcfg", "grasp_cube", "--algocfg", "ppo", "--algo.num_envs", str(E),
            "--task.maxEpisodeLength", "5", "--algo.model.network.hid_dim", "16", "16",
            "--algo.tricks.use_state_norm", "--save_pose", "--test_only",
            "--log.mode", "screen", "--log.log_root", str(root), "--exp_name", "cap_seed3"]


def test_eval_capture_poses_match_jax(tmp_path):
    """The JAX runner's ``_eval_capture_poses`` (a jitted scan) and the
    port's, the port holding the JAX runner's initial weights."""
    import train
    import train_torch
    from partmanip_tpu.utils.logger import Logger as JLogger
    from partmanip_tpu_torch.utils.logger import Logger as TLogger

    def cfgs(module, root):
        cfg, sp = module.process_cfgs(_capture_flags(root))
        cfg["task"]["random_reset"] = False
        cfg["algo"]["model"]["network"]["dtype"] = "f32"
        return cfg, sp

    jcfg, jsp = cfgs(jconfig, tmp_path / "jax")
    jsp = jsp._replace(use_fused=False)
    jrun = train.make_runner(train.make_env(jcfg, jsp), jcfg,
                             JLogger(jcfg, "cap_seed3", "grasp_cube", "ppo"))
    jts, jstate = jrun.init_state(3)
    jrun._eval_capture_poses(jts, jstate)

    tcfg, tsp = cfgs(tconfig, tmp_path / "port")
    trun = train_torch.make_runner(train_torch.make_env(tcfg, tsp, "cpu"), tcfg,
                                   TLogger(tcfg, "cap_seed3", "grasp_cube", "ppo"))
    tts, tstate = trun.init_state(3)
    trun.ac.load_state_dict({**trun.ac.state_dict(), **convert.actor_critic_from_jax(
        tp.jax_params_to_numpy(jts.params))})
    trun._eval_capture_poses(tts, tstate)

    jdir = tmp_path / "jax" / "scene_pose" / "grasp_cube_ppo" / "cap_seed3" / "Iter0"
    tdir = tmp_path / "port" / "scene_pose" / "grasp_cube_ppo" / "cap_seed3" / "Iter0"
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir)) == [f"{i}.npy" for i in range(5)]
    moved = 0.0
    for i in range(5):
        want = np.load(jdir / f"{i}.npy", allow_pickle=True).item()
        got = np.load(tdir / f"{i}.npy", allow_pickle=True).item()
        assert set(got) == set(want) == {"rot", "pos", "state", "action", "success"}
        for k in want:
            assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got["success"], want["success"])
        for k in ("rot", "pos", "state", "action"):
            np.testing.assert_allclose(got[k], want[k], atol=1e-4, rtol=0, err_msg=f"{i} {k}")
        moved = max(moved, float(np.abs(got["pos"] - np.load(
            tdir / "0.npy", allow_pickle=True).item()["pos"]).max()))
    assert moved > 1e-3, "the arm did not move in the captured episode"


def test_video_frame_matches_jax_render_rgb(tmp_path):
    """``ppo.video_prims`` slices one env out of the scene (tensor fields
    only, ``ground`` kept) and ``render_rgb`` at ``ppo.video_camera`` shades
    it as the JAX package does."""
    from partmanip_tpu.envs import vision as jvision
    from partmanip_tpu.ops import raymarch as jray
    from partmanip_tpu_torch.ops import raymarch as tray
    jenv, _, _, tenv, _ = tp.make_envs(["--taskcfg", "grasp_cube", "--algo.num_envs", str(E)])
    robot, part = _states("grasp_cube", np.random.RandomState(4), tenv)
    part["pos"][:, 2] = 0.025
    sim = convert.scene_state_from_numpy({"robot": robot, "body": part, "anchors": {
        "point": np.zeros((E, 18, 3), np.float32), "body": -np.ones((E, 18), np.int32)}})
    env_id = min(3, E - 1)
    prims = tppo.video_prims(tenv, sim, env_id)
    assert prims.ground is True and prims.sphere_center.shape[0] == 1
    poses, intr, h, w = tppo.video_camera(tenv, (32, 64))
    depth = tray.render_depth(prims, poses, intr, h, w, cull=False)
    got = tray.render_rgb(prims, poses, intr, h, w, depth=depth)[0, 0].numpy()
    jp = jvision.scene_prims(jenv, tp.numpy_scene_to_jax(tp.jax_scene_to_numpy(sim)))
    jp = jp._replace(**{k: v[env_id:env_id + 1] for k, v in jp._asdict().items()
                        if not isinstance(v, bool)})
    want = np.asarray(jray.render_rgb(jp, poses, intr, h, w))[0, 0]
    assert got.shape == want.shape == (h, w, 3)
    close = np.abs(got - want).max(-1) <= 1e-4
    assert close.mean() >= 0.995, f"{close.mean():.4f} of the pixels agree"
    assert (want.max(-1) > 0).mean() > 0.05, "the frame shows nothing"
