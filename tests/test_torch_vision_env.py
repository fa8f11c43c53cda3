"""The open_drawer ``depth_pc`` slice as a whole: the port's env on the CPU
(plain raymarcher, plain FPS) against the JAX package's env, at 2 envs,
3 views of 36×64 (``im_scale`` 8) and the exact unculled march on both sides
(the JAX package's CPU renderer has no coarse-to-fine and no cone culling:
the port's rig sets ``cull`` off), over the reset and two
scripted steps from the same cabinet placements.

The JAX side is jitted once into ``tests/golden_torch/vision_depth_pc.npz``
by ``tests/golden_torch/make_vision_golden.py`` (about 40 s of compiles that
each test run would otherwise repeat).  Tolerances:

* scene states to 1e-5 (qpos; two control steps of f32 re-association);
* depth images of those states: 99.9 % of pixels within 1e-4 m and 1e-4 m
  where both hit (``tests/test_vision.py`` asks 98 % within 1e-3 and 1e-2);
* the point cloud pipeline (unproject, crop, FPS) on the JAX env's depth
  reproduces the JAX env's observation exactly;
* the env's observation: 99 % of the 1024 points of every env within 1e-4 m
  of the JAX env's (an FPS pick may flip on a last-bit tie), the state
  observation within 1e-5."""

import random

import numpy as np
import pytest
import torch

import _torch_vision as tv
from partmanip_tpu_torch import config as tconfig
from partmanip_tpu_torch.envs import vision
from partmanip_tpu_torch.envs.open_drawer import OpenDrawerEnv
from partmanip_tpu_torch.ops import tsdf

STEPS = range(tv.N_STEPS + 1)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with tv.one_torch_thread():
        yield


@pytest.fixture(scope="module")
def golden():
    return dict(np.load(tv.GOLDEN))


@pytest.fixture(scope="module")
def rollout(tmp_path_factory):
    cfg, sp = tconfig.process_cfgs(tv.flags(tmp_path_factory.mktemp("assets")))
    tv.small_cfg(cfg)
    random.seed(tv.OBJ_SEED)
    env = OpenDrawerEnv(cfg["task"], sp, device="cpu")
    env.vision_rig.cull = False          # the JAX env's CPU (XLA) renderer does not cull
    draws = tv.draws()
    acts = tv.actions(env.num_actions)
    with torch.no_grad():
        state = env.init_state(env.make_generator(0), draws)
        state, obs = env.reset(state, draws)
        trace = [(obs, state.sim)]
        for t in range(tv.N_STEPS):
            state, obs, *_ = env.step(state, torch.as_tensor(acts[t]), train=False)
            trace.append((obs, state.sim))
    return env, trace


def test_rig_and_observation_sizes(rollout):
    env, trace = rollout
    rig = env.vision_rig
    assert (rig.num_view, rig.im_h, rig.im_w, rig.coarse_to_fine, rig.cull) == \
        (3, 36, 64, False, False)
    assert env.num_obs["depth_pc"] == 3072
    for obs, _ in trace:
        assert obs["depth_pc"].shape == (tv.E, 3072) and obs["depth_pc"].dtype == torch.float32
        assert bool(torch.isfinite(obs["depth_pc"]).all())


@pytest.mark.parametrize("step", STEPS)
def test_depth_images_of_the_same_scene(rollout, golden, step):
    env, trace = rollout
    sim = trace[step][1]
    np.testing.assert_allclose(sim.robot.qpos.numpy(), golden["sim/robot/qpos"][step],
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(sim.obj.qpos.numpy(), golden["sim/obj/qpos"][step],
                               atol=1e-5, rtol=0)
    got = vision.render_depth(env.vision_rig, vision.scene_prims(env, sim)).numpy()
    want = golden["depth"][step]
    assert got.shape == want.shape == (tv.E, 3, 36, 64)
    err = np.abs(got - want)
    assert (err <= 1e-4).mean() >= 0.999, (err <= 1e-4).mean()
    both = (got < 99.0) & (want < 99.0)
    assert both.mean() > 0.9 and err[both].max() <= 1e-4


@pytest.mark.parametrize("step", STEPS)
def test_point_cloud_pipeline_on_the_jax_depth(rollout, golden, step):
    env, _ = rollout
    pc = tsdf.depth_to_pointcloud(env.vision_rig.tsdf_spec,
                                  torch.as_tensor(golden["depth"][step]), k=1024)
    np.testing.assert_array_equal(pc.reshape(tv.E, -1).numpy(), golden["depth_pc"][step])


@pytest.mark.parametrize("step", STEPS)
def test_env_observation(rollout, golden, step):
    obs, _ = rollout[1][step]
    got = obs["depth_pc"].numpy().reshape(tv.E, -1, 3)
    want = golden["depth_pc"][step].reshape(tv.E, -1, 3)
    close = np.abs(got - want).max(-1) <= 1e-4            # [E, 1024]
    assert close.mean(axis=1).min() >= 0.99, close.mean(axis=1)
    live = np.abs(got).sum(-1) > 0
    assert live.mean(axis=1).min() > 0.5                   # the scene, not the origin
    np.testing.assert_allclose(obs["normal_state"].numpy(), golden["normal_state"][step],
                               atol=1e-5, rtol=0)
