"""The remaining vision observations of the port's envs (``envs/vision.py``
``depth_img``, ``rgb_img``, ``depth_sparse``; the tasks' ``_init_vision``)
against the JAX package's, on the same scene states: the port's env resets
and steps on the CPU with 2 envs, and the JAX env's ``vision.render_obs``
(jitted) reads the same states.  Both render with the exact unculled march
(``coarse_to_fine`` and ``cull`` off: the JAX package's CPU renderer has
neither).  The image modes render one 72×128 view whatever ``im_scale``
says; depth_sparse renders 3 views of 36×64 (``im_scale`` 8) into a res-16
volume.

Tolerances (the two marches evaluate the box distance in other operation
orders, ≈ 1e-6 m apart):
* ``depth_img``: no pixel that hits in one package and misses in the
  other; where both hit, 99.9 % of pixels within 1e-5 m and every pixel
  within 1e-3 m (a ray whose distance lies within rounding of the march's
  ``eps`` stops one step earlier in one package, and that step is shorter
  than ``eps``);
* ``rgb_img``: 1e-4 at every pixel whose depths agree within 1e-5 m (the
  shading of hit points ≈ 1e-6 m apart), in [0, 1] at the others; black
  on both sides where both miss;
* ``depth_sparse``: the near-surface masks of the two packages' volumes
  equal, so the picks are the same voxels: coordinates equal exactly, the
  TSDF values there within 1e-5."""

import random

import numpy as np
import jax
import pytest
import torch

import _torch_vision as tv
from partmanip_tpu import config as jconfig
from partmanip_tpu.envs import vision as jvision
from partmanip_tpu.envs.grasp_cube import GraspCubeEnv as JCube
from partmanip_tpu.envs.open_drawer import OpenDrawerEnv as JDrawer
from partmanip_tpu.ops import raymarch as jraymarch
from partmanip_tpu.ops import tsdf as jtsdf
from partmanip_tpu.sim import contact as jcontact
from partmanip_tpu.sim import engine as jengine
from partmanip_tpu.sim.types import FreeBodyState, TreeState
from partmanip_tpu_torch import config as tconfig
from partmanip_tpu_torch.envs import vision as tvision
from partmanip_tpu_torch.envs.grasp_cube import GraspCubeEnv as TCube
from partmanip_tpu_torch.envs.open_drawer import OpenDrawerEnv as TDrawer
from partmanip_tpu_torch.ops import tsdf as ttsdf
from partmanip_tpu_torch.utils import convert

E, RES = 2, 16
ENVS = {"grasp_cube": (JCube, TCube), "open_drawer": (JDrawer, TDrawer)}
FAR = 100.0


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with tv.one_torch_thread():
        yield


def _jax_scene(sim):
    """The port's SceneState as the JAX package's."""
    import jax.numpy as jnp
    d = convert.scene_state_to_numpy(sim)
    tree = lambda t: TreeState(**{k: jnp.asarray(v) for k, v in t.items()})
    return jengine.SceneState(
        robot=tree(d["robot"]), obj=tree(d["obj"]) if "obj" in d else None,
        body=FreeBodyState(**{k: jnp.asarray(v) for k, v in d["body"].items()})
        if "body" in d else None,
        anchors=jcontact.AnchorState(point=jnp.asarray(d["anchors"]["point"]),
                                     body=jnp.asarray(d["anchors"]["body"], jnp.int32)))


def _envs(task, mode, root):
    out = []
    for module, cls in zip((jconfig, tconfig), ENVS[task]):
        flags = ["--taskcfg", task, "--algocfg", "dagger", "--algo.num_envs", str(E),
                 "--algo.obs_mode", mode, "--task.obs_mode.tsdf.resolution", str(RES),
                 "--task.maxEpisodeLength", "3"]
        if task == "open_drawer":
            flags += ["--task.asset.num_objects", "3", "--task.asset.assetRoot", str(root)]
        cfg, sp = module.process_cfgs(flags)
        cfg["task"]["im_scale"] = 8
        cfg["task"]["cam"]["coarse_to_fine"] = False
        random.seed(tv.OBJ_SEED)
        out.append(cls(cfg["task"], sp) if module is jconfig
                   else cls(cfg["task"], sp, device="cpu"))
    out[1].vision_rig.cull = False
    return out


def _trace(tenv, steps=2):
    """(scene state, observation) after the reset and each of ``steps``
    seeded random steps of the port's env."""
    acts = np.random.RandomState(5).uniform(-1, 1, (steps, E, tenv.num_actions))
    with torch.no_grad():
        state, obs = tenv.reset(tenv.init_state(tenv.make_generator(3)))
        trace = [(state.sim, obs)]
        for a in acts.astype(np.float32):
            state, obs, *_ = tenv.step(state, torch.as_tensor(a), train=False)
            trace.append((state.sim, obs))
    return trace


@pytest.mark.parametrize("mode", ["depth_img", "rgb_img"])
def test_image_observations_match_the_jax_env(tmp_path, mode):
    jenv, tenv = _envs("grasp_cube", mode, tmp_path)
    size = 72 * 128 * (3 if mode == "rgb_img" else 1)
    assert tenv.num_obs[mode] == jenv.num_obs[mode] == size + 25
    rig = tenv.vision_rig
    assert (rig.num_view, rig.im_h, rig.im_w) == (1, 72, 128)
    render = jax.jit(lambda sim: jvision.render_obs(jenv, jenv.vision_rig, sim)[mode])
    depth_of = jax.jit(lambda sim: jraymarch.render_depth(
        jvision.scene_prims(jenv, sim), jenv.vision_rig.poses, jenv.vision_rig.intrinsic,
        72, 128))
    for sim, obs in _trace(tenv):
        got = obs[mode].numpy()
        assert got.shape == (E, size + 25) and got.dtype == np.float32
        np.testing.assert_array_equal(got[:, size:], obs["proprio_state"].numpy())
        got = got[:, :size]
        want = np.asarray(render(_jax_scene(sim)))
        jd = np.asarray(depth_of(_jax_scene(sim))).reshape(E, -1)
        with torch.no_grad():
            td = tvision.render_depth(rig, tvision.scene_prims(tenv, sim)).reshape(E, -1)
        both = (jd < FAR) & (td.numpy() < FAR)
        assert ((jd < FAR) != (td.numpy() < FAR)).sum() == 0 and both.mean() > 0.5
        agree = both & (np.abs(jd - td.numpy()) <= 1e-5)
        assert agree.sum() >= 0.999 * both.sum()
        if mode == "depth_img":
            np.testing.assert_allclose(got[agree], want[agree], rtol=0, atol=1e-5)
            np.testing.assert_allclose(got[both], want[both], rtol=0, atol=1e-3)
            np.testing.assert_array_equal(got[~both], FAR)
        else:           # channel-first: pixel p of channel c at c·H·W + p
            got, want = got.reshape(E, 3, -1), want.reshape(E, 3, -1)
            hit, same = (np.repeat(m[:, None], 3, 1) for m in (both, agree))
            np.testing.assert_allclose(got[same], want[same], rtol=0, atol=1e-4)
            assert ((got >= 0) & (got <= 1)).all()
            assert (got[~hit] == 0).all() and (want[~hit] == 0).all()
            assert (got[hit] > 0).mean() > 0.9


def test_sparse_voxel_observation_matches_the_jax_env(tmp_path):
    jenv, tenv = _envs("open_drawer", "depth_sparse", tmp_path)
    assert tenv.num_obs["depth_sparse"] == jenv.num_obs["depth_sparse"] == 4096
    rig, spec = tenv.vision_rig, tenv.vision_rig.tsdf_spec
    render = jax.jit(lambda sim: jvision.render_obs(jenv, jenv.vision_rig, sim)["depth_sparse"])
    jvol_of = jax.jit(lambda sim: jtsdf.integrate(jenv.vision_rig.tsdf_spec, jraymarch.render_depth(
        jvision.scene_prims(jenv, sim), jenv.vision_rig.poses, jenv.vision_rig.intrinsic,
        rig.im_h, rig.im_w)))
    for sim, obs in _trace(tenv):
        got = obs["depth_sparse"].numpy().reshape(E, 1024, 4)
        want = np.asarray(render(_jax_scene(sim))).reshape(E, 1024, 4)
        with torch.no_grad():
            tvol = ttsdf.integrate(spec, tvision.render_depth(rig, tvision.scene_prims(tenv, sim)))
        jvol = np.asarray(jvol_of(_jax_scene(sim)))
        near = lambda v: (np.abs(v) < 0.2).reshape(E, -1)
        np.testing.assert_array_equal(near(tvol.numpy()), near(jvol))
        assert near(jvol).sum(1).min() > 20
        np.testing.assert_array_equal(got[..., :3], want[..., :3])
        np.testing.assert_allclose(got[..., 3], want[..., 3], rtol=0, atol=1e-5)
        assert (np.abs(got[..., 3]) <= 1).all()
