"""The TSDF observations of the port's envs (``partmanip_tpu_torch/envs/
vision.py`` ``mesh_tsdf``, ``depth_tsdf``; the tasks' ``_init_vision`` /
``_vision_obs``) against the JAX package's, at res 8, 2 envs and 3 views
of 36×64 (``im_scale`` 8), on the same scene states: the port's env resets
and steps on the CPU, and the JAX env's ``vision.render_obs`` reads the
same states.  ``depth_tsdf`` renders with the exact unculled march on both
sides (``coarse_to_fine`` and ``cull`` off: the JAX package's CPU renderer
has neither).

Tolerances:
* ``mesh_tsdf``: 1e-5 (the box distance rounds in another order, ≈ 1e-6 m,
  divided by ``sdf_trunc`` ≥ 0.25 m at res 8);
* ``depth_tsdf``: 1e-5 on every voxel whose views agree between the
  packages on hit / miss and on validity (depth within ≈ 1e-6 m over
  ``sdf_trunc``); a voxel that reads a pixel whose ray hits in one package
  and misses in the other (or crosses the validity cut) may differ more,
  and at most 1 % of the seen voxels may be such; at least 60 % of the
  seen voxels equal exactly, and every voxel no view sees reads 1.0 on
  both sides;
* ``raymarch.scene_sdf`` over the full 50³ grid of one env: 2e-6 m."""

import random

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import _torch_vision as tv
from partmanip_tpu import config as jconfig
from partmanip_tpu.envs import vision as jvision
from partmanip_tpu.envs.grasp_cube import GraspCubeEnv as JCube
from partmanip_tpu.envs.open_drawer import OpenDrawerEnv as JDrawer
from partmanip_tpu.ops import raymarch as jraymarch
from partmanip_tpu.sim import contact as jcontact
from partmanip_tpu.sim import engine as jengine
from partmanip_tpu.sim.types import FreeBodyState, TreeState
from partmanip_tpu_torch import config as tconfig
from partmanip_tpu_torch.envs import vision as tvision
from partmanip_tpu_torch.envs.grasp_cube import GraspCubeEnv as TCube
from partmanip_tpu_torch.envs.open_drawer import OpenDrawerEnv as TDrawer
from partmanip_tpu_torch.ops import raymarch as traymarch
from partmanip_tpu_torch.utils import convert

E, RES = 2, 8
ENVS = {"grasp_cube": (JCube, TCube), "open_drawer": (JDrawer, TDrawer)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with tv.one_torch_thread():
        yield


def _flags(task, mode, root, *extra):
    f = ["--taskcfg", task, "--algocfg", "dagger", "--algo.num_envs", str(E),
         "--algo.obs_mode", mode, "--task.obs_mode.tsdf.resolution", str(RES),
         "--task.maxEpisodeLength", "3", *extra]
    if task == "open_drawer":
        f += ["--task.asset.num_objects", "3", "--task.asset.assetRoot", str(root)]
    return f


def _envs(task, mode, root, *extra):
    """(JAX env, port env on the CPU) from the same flags and cabinets, the
    render at 1/8 size, exact and unculled."""
    out = []
    for module, cls in zip((jconfig, tconfig), ENVS[task]):
        cfg, sp = module.process_cfgs(_flags(task, mode, root, *extra))
        cfg["task"]["im_scale"] = 8
        cfg["task"]["cam"]["coarse_to_fine"] = False
        random.seed(tv.OBJ_SEED)
        out.append(cls(cfg["task"], sp) if module is jconfig
                   else cls(cfg["task"], sp, device="cpu"))
    if out[1].vision_rig is not None:
        out[1].vision_rig.cull = False
    return out


def _jax_scene(sim):
    """The port's SceneState as the JAX package's."""
    d = convert.scene_state_to_numpy(sim)
    tree = lambda t: TreeState(**{k: jnp.asarray(v) for k, v in t.items()})
    return jengine.SceneState(
        robot=tree(d["robot"]), obj=tree(d["obj"]) if "obj" in d else None,
        body=FreeBodyState(**{k: jnp.asarray(v) for k, v in d["body"].items()})
        if "body" in d else None,
        anchors=jcontact.AnchorState(point=jnp.asarray(d["anchors"]["point"]),
                                     body=jnp.asarray(d["anchors"]["body"], jnp.int32)))


def _views_agree(jenv, tenv, sim):
    """Per voxel [E, res³]: whether some view sees it (in either package),
    and whether some view's pixel hits in one package and misses in the
    other, or is valid for the voxel in one and not in the other."""
    rig, jrig, spec = tenv.vision_rig, jenv.vision_rig, tenv.vision_rig.tsdf_spec
    with torch.no_grad():
        dt = tvision.render_depth(rig, tvision.scene_prims(tenv, sim)).numpy()
    dj = np.asarray(jraymarch.render_depth(
        jvision.scene_prims(jenv, _jax_scene(sim)), jrig.poses, jrig.intrinsic,
        jrig.im_h, jrig.im_w, coarse_to_fine=False))
    E, V = dt.shape[:2]
    lin = np.broadcast_to(spec.pix_y.astype(np.int64) * spec.im_w + spec.pix_x,
                          (E,) + spec.pix_x.shape)
    read = [np.take_along_axis(d.reshape(E, V, -1), lin, 2) for d in (dj, dt)]
    valid = [spec.valid[None] & (g > 0) & (g - spec.pix_z[None] >= -spec.sdf_trunc)
             for g in read]
    hit_flip = spec.valid[None] & ((read[0] > 0) != (read[1] > 0))
    return ((valid[0] | valid[1]).any(1),
            (hit_flip | (valid[0] != valid[1])).any(1))


@pytest.mark.parametrize("task", ["open_drawer", "grasp_cube"])
@pytest.mark.parametrize("mode", ["mesh_tsdf", "depth_tsdf"])
def test_observation_matches_the_jax_env(tmp_path, task, mode):
    jenv, tenv = _envs(task, mode, tmp_path)
    acts = np.random.RandomState(5).uniform(-1, 1, (2, E, tenv.num_actions)).astype(np.float32)
    with torch.no_grad():
        state, obs = tenv.reset(tenv.init_state(tenv.make_generator(3)))
        trace = [(state.sim, obs)]
        for a in acts:
            state, obs, *_ = tenv.step(state, torch.as_tensor(a), train=False)
            trace.append((state.sim, obs))
    render = jax.jit(lambda sim: jvision.render_obs(jenv, jenv.vision_rig, sim)[mode])
    prop = 25 if task == "grasp_cube" else 0
    assert tenv.num_obs[mode] == jenv.num_obs[mode] == RES ** 3 + prop
    for t, (sim, obs) in enumerate(trace):
        got = obs[mode].numpy()
        assert got.shape == (E, RES ** 3 + prop) and got.dtype == np.float32
        want = np.asarray(render(_jax_scene(sim)))
        vol = got[:, :RES ** 3]
        assert (np.abs(vol) <= 1.0).all()
        if prop:
            np.testing.assert_array_equal(got[:, RES ** 3:], obs["proprio_state"].numpy())
        err = np.abs(vol - want)
        if mode == "mesh_tsdf":
            assert err.max() <= 1e-5, (t, err.max())
        else:
            seen, flipped = _views_agree(jenv, tenv, sim)
            n_seen = int(seen.sum())
            assert n_seen > 0.3 * seen.size        # the cameras see the scene
            assert (vol[~seen] == 1.0).all() and (want[~seen] == 1.0).all()
            assert err[~flipped].max() <= 1e-5, (t, err[~flipped].max())
            outliers = int((flipped & (err > 1e-5)).sum())
            assert outliers <= 0.01 * n_seen, (t, outliers, n_seen)
            exact = int((seen & (err == 0)).sum())
            assert exact >= 0.6 * n_seen, (t, exact, n_seen)
    if mode == "mesh_tsdf":          # surfaces within the truncation, and free space
        assert (vol < 0.5).any() and (vol > 0.9).any()


@pytest.mark.parametrize("task", ["open_drawer", "grasp_cube"])
def test_obs_sizes_with_and_without_proprio(tmp_path, task):
    """``num_obs`` of the TSDF modes as the JAX env has it, with the YAML's
    ``add_proprio_obs`` and with it flipped off; with a state learn mode the
    port keeps the YAML's size (the JAX grasp_cube adds the proprio dims
    though its observation concatenates none, ROADMAP Queue C)."""
    for mode in ("mesh_tsdf", "depth_tsdf"):
        for extra in ((), ("--algo.add_proprio_obs",)):
            jenv, tenv = _envs(task, mode, tmp_path, *extra)
            assert tenv.num_obs[mode] == jenv.num_obs[mode], (mode, extra)
            assert tenv.vision_rig.grid_points.shape == (RES ** 3, 3)
            np.testing.assert_array_equal(tenv.vision_rig.grid_points.numpy(),
                                          np.asarray(jenv.vision_rig.grid_points))
            assert tenv.vision_rig.sdf_trunc == jenv.vision_rig.sdf_trunc
    jenv, tenv = _envs(task, "normal_state", tmp_path, "--algo.model.network.name", "MLP")
    assert tenv.vision_rig is None
    state_dims = {"grasp_cube": 37, "open_drawer": 53}[task]
    assert tenv.num_obs["normal_state"] == state_dims
    assert jenv.num_obs["normal_state"] == state_dims + (25 if task == "grasp_cube" else 0)


def test_scene_sdf_on_the_full_grid():
    """``raymarch.scene_sdf`` of one open_drawer env's primitives (robot
    spheres, 25 cabinet boxes, the ground) at the 125,000 voxel centres of
    the YAML's 2 m, 50³ volume, in the chunks ``mesh_tsdf`` queries."""
    from partmanip_tpu_torch.ops import tsdf as ttsdf
    rs = np.random.RandomState(2)
    S, G = 18, 25
    q = rs.randn(1, G, 4).astype(np.float32)
    prims = dict(sphere_center=rs.uniform(-0.8, 0.8, (1, S, 3)).astype(np.float32),
                 sphere_radius=rs.uniform(0.02, 0.08, (1, S)).astype(np.float32),
                 box_pos=rs.uniform(-0.8, 0.8, (1, G, 3)).astype(np.float32),
                 box_quat=q / np.linalg.norm(q, axis=-1, keepdims=True),
                 box_half=rs.uniform(0.01, 0.3, (1, G, 3)).astype(np.float32),
                 box_mask=(rs.rand(1, G) < 0.8).astype(np.float32))
    spec = ttsdf.make_tsdf_spec(np.eye(4, dtype=np.float32)[None], np.eye(3), 8, 8, size=2.0,
                                resolution=50, origin=(-1, -1, 0.05))
    rig = type("Rig", (), {"grid_points": torch.as_tensor(spec.world_points),
                           "sdf_trunc": spec.sdf_trunc})()
    tp = traymarch.ScenePrims(**{k: torch.as_tensor(v) for k, v in prims.items()})
    jp = jraymarch.ScenePrims(**{k: jnp.asarray(v) for k, v in prims.items()})
    want = np.asarray(jax.jit(lambda p: jraymarch.scene_sdf(jp, p))(
        jnp.asarray(spec.world_points)[None]))
    got = traymarch.scene_sdf(tp, rig.grid_points[None]).numpy()
    assert want.shape == got.shape == (1, 125_000)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
    assert (want < 0).mean() > 0.01 and (want > 0).mean() > 0.5
    obs = tvision.mesh_tsdf(rig, tp).numpy()
    np.testing.assert_allclose(obs, np.clip(want / spec.sdf_trunc, -1, 1), rtol=0, atol=1e-5)


def test_other_vision_modes_still_raise(tmp_path):
    """Every vision mode is ported; open_drawer.yaml gives no size for the
    image modes, so those refuse, naming the key (the JAX package's DAgger
    fails at ``env.num_obs[mode]``), and a mode no package knows raises
    ``NotImplementedError`` at its first observation, as the JAX
    package's."""
    for task, mode in (("open_drawer", "rgb_img"), ("open_drawer", "depth_img")):
        cfg, sp = tconfig.process_cfgs(_flags(task, mode, tmp_path))
        with pytest.raises(ValueError, match=f"no key obs_mode.{mode}"):
            ENVS[task][1](cfg["task"], sp, device="cpu")
    cfg, sp = tconfig.process_cfgs(_flags("grasp_cube", "depth_img", tmp_path))
    cfg["task"].update(learn_input_mode="depth_voxel", im_scale=8)
    cfg["task"]["obs_mode"]["depth_voxel"] = 10
    env = ENVS["grasp_cube"][1](cfg["task"], sp, device="cpu")
    with pytest.raises(NotImplementedError, match="depth_voxel"):
        env.reset(env.init_state(env.make_generator(0)))
