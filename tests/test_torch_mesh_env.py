"""The mesh-handle open_drawer slice as a whole: the port's
``OpenDrawerEnv`` with ``--task.asset.mesh_handle`` against the JAX
package's, through ``process_cfgs`` of both, at 6 envs and 2 cabinets.

* merged configs equal key by key (the flag reaches both);
* same initial ``EnvState`` (cabinet poses injected as numpy on both sides
  instead of the two frameworks' random draws) → ``reset`` obs to 1e-5,
  then three scripted ``env.step``s (actions from a numpy seed): obs and
  reward to 1e-3 (tests/test_torch_drawer_env.py's tolerances: a control
  step is 8 inner steps of effort-clamped drives on f32 re-association
  seeds), reset flags, progress, success and the per-object success bitmap
  exact, everything finite.

The port's env is built first into a fresh asset root and bakes the grids
(on the CPU); the JAX env reads those caches after the same
``random.seed``."""

import random

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import _torch_vision as tv

from partmanip_tpu import config as jconfig
from partmanip_tpu.envs.open_drawer import OpenDrawerEnv as JEnv
from partmanip_tpu_torch import config as tconfig
from partmanip_tpu_torch.envs.open_drawer import OpenDrawerEnv as TEnv

E = 6
N_STEPS = 3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One PyTorch thread: the bakes and the plain steps are many small ops,
    which spin-wait under the test run's several workers when each op is
    split over every core (tests/_torch_vision.py)."""
    with tv.one_torch_thread():
        yield


@pytest.fixture(scope="module")
def envs(tmp_path_factory):
    flags = ["--taskcfg", "open_drawer", "--algocfg", "ppo", "--algo.num_envs", str(E),
             "--task.asset.num_objects", "2", "--task.maxEpisodeLength", "10",
             "--task.asset.mesh_handle",
             "--task.asset.assetRoot", str(tmp_path_factory.mktemp("assets"))]
    jcfg, jsp = jconfig.process_cfgs(list(flags))
    tcfg, tsp = tconfig.process_cfgs(list(flags))
    random.seed(7)
    tenv = TEnv(tcfg["task"], tsp, device="cpu")
    random.seed(7)
    jenv = JEnv(jcfg["task"], jsp)

    rs = np.random.RandomState(21)
    dxyz = rs.uniform(-0.05, 0.05, (E, 3)).astype(np.float32)
    yaw = rs.uniform(-np.pi / 12, np.pi / 12, E).astype(np.float32)

    def injected_root(rng, n):
        from partmanip_tpu.ops import rotations as jrot
        base = jnp.tile(jnp.asarray([-0.6, 0.0, 0.5]), (n, 1))
        a = jnp.asarray(yaw)
        dq = jnp.stack([jnp.zeros(n), jnp.zeros(n), jnp.sin(a), jnp.cos(a)], -1)
        q0 = jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0, 0.0]), (n, 4))
        return base + jnp.asarray(dxyz), jrot.quat_mul(q0, dq)
    jenv._random_obj_root = injected_root
    return dict(jenv=jenv, tenv=tenv, jcfg=jcfg, tcfg=tcfg, draws=(dxyz, yaw))


@pytest.fixture(scope="module")
def rollout(envs):
    jenv, tenv, draws = envs["jenv"], envs["tenv"], envs["draws"]
    jstate = jenv.init_state(jax.random.PRNGKey(0))
    tstate = tenv.init_state(tenv.make_generator(0), draws)
    jstate, jobs = jax.jit(jenv.reset)(jstate)
    jstep = jax.jit(lambda s, a: jenv.step(s, a, train=True))
    acts = np.random.RandomState(5).uniform(-1, 1, (N_STEPS, E, 10)).astype(np.float32)
    rec = lambda o, r, st: dict(
        obs=np.array(o), rew=np.array(r), reset=np.array(st.reset_buf),
        progress=np.array(st.progress), success=np.array(st.success),
        task=np.array(st.task_state))
    with torch.no_grad():
        tstate, tobs = tenv.reset(tstate, draws)
        jtrace = [dict(obs=np.array(jobs["normal_state"]))]
        ttrace = [dict(obs=tobs["normal_state"].numpy())]
        for t in range(N_STEPS):
            jstate, jobs, jrew, _, _ = jstep(jstate, jnp.asarray(acts[t]))
            tstate, tobs, trew, _, _ = tenv.step(tstate, torch.as_tensor(acts[t]),
                                                 train=True)
            jtrace.append(rec(jobs["normal_state"], jrew, jstate))
            ttrace.append(rec(tobs["normal_state"], trew, tstate))
    return dict(jtrace=jtrace, ttrace=ttrace, tstate=tstate)


def test_merged_configs_are_equal(envs):
    assert envs["jcfg"] == envs["tcfg"]
    assert envs["tcfg"]["task"]["asset"]["mesh_handle"] is True
    assert envs["tenv"].scene.obj_grids is not None


def test_reset_observation(rollout):
    got, want = rollout["ttrace"][0]["obs"], rollout["jtrace"][0]["obs"]
    assert got.shape == (E, 53) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("t", range(1, N_STEPS + 1))
def test_step(rollout, t):
    got, want = rollout["ttrace"][t], rollout["jtrace"][t]
    np.testing.assert_allclose(got["obs"], want["obs"], atol=1e-3, rtol=0)
    np.testing.assert_allclose(got["rew"], want["rew"], atol=1e-3, rtol=0)
    for k in ("reset", "progress", "success", "task"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert np.isfinite(got["obs"]).all() and np.isfinite(got["rew"]).all()
    sim = rollout["tstate"].sim
    assert bool(torch.isfinite(sim.obj.qpos).all() and torch.isfinite(sim.robot.qvel).all())
