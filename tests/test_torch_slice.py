"""The slice as a whole: the grasp_cube evaluation rollout of the port
against the JAX package, through ``process_cfgs`` of both.

* merged configs equal key by key;
* same initial ``EnvState`` (cube poses injected as numpy on both sides
  instead of the two frameworks' random draws) → ``reset`` obs to 1e-5, then
  three ``env.step``s with the same JAX-initialised policy carried across by
  ``actor_critic_from_jax``: obs / reward to 1e-3, reset flags and progress
  exact;
* longer horizons are chaotic under the effort clamp and are not compared
  pointwise: the committed golden trace ``tests/golden/grasp_cube_*.npy`` is
  replayed through the port (protocol of tests/test_golden_trajectory.py);
* the CLI end to end, checkpoint resume and the refusals of what is not
  ported are in ``test_torch_cli.py``.

The network dtype is set to f32 on the merged dicts: neither CLI has a
``--algo.model.network.dtype`` flag (the YAML has no such key)."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from partmanip_tpu.models.actor_critic import ActorCritic as JActorCritic
from partmanip_tpu_torch.models.actor_critic import ActorCritic as TActorCritic
from partmanip_tpu_torch.sim import engine as tengine
from partmanip_tpu_torch.utils import convert

import _torch_port as tp

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
E = 4
FLAGS = ["--taskcfg", "grasp_cube", "--algocfg", "ppo", "--algo.num_envs", str(E),
         "--algo.model.network.hid_dim", "32", "32",
         "--task.maxEpisodeLength", "10"]
N_STEPS = 3


def _deep_diff(a, b, path=""):
    if isinstance(a, dict) and isinstance(b, dict):
        out = [f"{path}{k}: only on one side" for k in set(a) ^ set(b)]
        for k in set(a) & set(b):
            out += _deep_diff(a[k], b[k], f"{path}{k}.")
        return out
    return [] if a == b and type(a) is type(b) else [f"{path[:-1]}: {a!r} != {b!r}"]


@pytest.fixture(scope="module")
def rollout():
    """reset + N_STEPS eval steps through both packages from the same cube
    poses with the same policy; everything the tests compare, as numpy."""
    jenv, jcfg, jsp, tenv, tcfg = tp.make_envs(FLAGS)
    for cfg in (jcfg, tcfg):
        cfg["algo"]["model"]["network"]["dtype"] = "f32"

    rs = np.random.RandomState(21)
    dxy = rs.uniform(-0.15, 0.15, (E, 2)).astype(np.float32)
    yaw = rs.uniform(-np.pi, np.pi, E).astype(np.float32)

    def injected_root(rng, n):
        base = jnp.tile(jnp.asarray(jenv.obj_default_root[:3]), (n, 1))
        a = jnp.asarray(yaw)
        return (base.at[:, :2].add(jnp.asarray(dxy)),
                jnp.stack([jnp.zeros(n), jnp.zeros(n), jnp.sin(a), jnp.cos(a)], -1))
    jenv._random_obj_root = injected_root

    # the policy: JAX-initialised weights, carried across as numpy
    jac = JActorCritic(37, jenv.num_actions, jcfg["algo"]["model"])
    params = jac.init(jax.random.PRNGKey(2))
    # scale the policy head up so the actions move the arm visibly
    head = f"Dense_{len(params.actor['params']) - 1}"
    params.actor["params"][head]["kernel"] = \
        params.actor["params"][head]["kernel"] * 60.0
    tac = TActorCritic(37, tenv.num_actions, tcfg["algo"]["model"])
    tac.load_state_dict(
        convert.actor_critic_from_jax(tp.jax_params_to_numpy(params)))

    canon = lambda t: jax.tree.map(lambda x: x.astype(x.dtype), t)
    jstate = jenv.init_state(jax.random.PRNGKey(0))
    init_np = tp.jax_env_state_to_numpy(jstate)
    jstate, jobs = jax.jit(jenv.reset)(jstate)
    jstate = canon(jstate)
    jstep = jax.jit(lambda s, a: jenv.step(s, a, train=False))

    draws = (dxy, yaw)
    tstate = tenv.init_state(tenv.make_generator(0), draws)
    tinit_np = convert.env_state_to_numpy(tstate)
    physics_calls = []
    real_step = tengine.physics_step

    def counting_step(*a, **k):
        physics_calls.append(1)
        return real_step(*a, **k)

    tengine.physics_step = counting_step
    try:
        with torch.no_grad():
            tstate, tobs = tenv.reset(tstate, draws)
            jtrace, ttrace = [], []
            jo, to = jobs["normal_state"], tobs["normal_state"]
            rec = lambda o, r, st, ex: dict(
                obs=np.array(o), rew=np.array(r), reset=np.array(st.reset_buf),
                progress=np.array(st.progress), success=np.array(st.success),
                extras=sorted(ex))
            jtrace.append(dict(obs=np.array(jo)))
            ttrace.append(dict(obs=to.numpy()))
            for _ in range(N_STEPS):
                ja = jac.act(params, jo)
                ta = tac.act(to)
                jstate, jobs, jrew, _, jex = jstep(jstate, ja)
                tstate, tobs, trew, _, tex = tenv.step(tstate, ta, train=False)
                jo, to = jobs["normal_state"], tobs["normal_state"]
                jtrace.append(dict(rec(jo, jrew, jstate, jex), act=np.array(ja)))
                ttrace.append(dict(rec(to, trew, tstate, tex), act=ta.numpy()))
    finally:
        tengine.physics_step = real_step
    return dict(jcfg=jcfg, tcfg=tcfg, jsp=jsp, tsp=tenv.scene.params,
                init=(init_np, tinit_np), jtrace=jtrace, ttrace=ttrace,
                physics_calls=len(physics_calls))


def test_merged_configs_are_equal(rollout):
    assert _deep_diff(rollout["jcfg"], rollout["tcfg"]) == []
    assert rollout["jsp"]._asdict() == rollout["tsp"]._asdict()
    assert rollout["tcfg"]["algo"]["num_envs"] == E
    assert rollout["tcfg"]["algo"]["model"]["network"]["hid_dim"] == [32, 32]
    assert rollout["tcfg"]["task"]["maxEpisodeLength"] == 10


def test_initial_env_state_is_equal(rollout):
    jinit, tinit = rollout["init"]
    for k in ("progress", "rew_buf", "success", "reset_buf", "reset_succ",
              "epis_max_rew", "epis_max_step"):
        np.testing.assert_array_equal(tinit[k], jinit[k])
        assert tinit[k].dtype == jinit[k].dtype, k
    for part in ("robot", "body", "anchors"):
        for k, v in jinit["sim"][part].items():
            np.testing.assert_allclose(tinit["sim"][part][k], v, atol=1e-6,
                                       rtol=0, err_msg=f"{part}.{k}")


def test_reset_observation(rollout):
    """After the reset's settling physics step: atol 1e-5."""
    got, want = rollout["ttrace"][0]["obs"], rollout["jtrace"][0]["obs"]
    assert got.shape == (E, 37)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("step", range(1, N_STEPS + 1))
def test_env_step(rollout, step):
    """obs / reward 1e-3 (a control step is 8 inner steps of effort-clamped
    drives on f32 re-association seeds; qvel is part of the obs), the
    bookkeeping exact."""
    got, want = rollout["ttrace"][step], rollout["jtrace"][step]
    np.testing.assert_allclose(got["act"], want["act"], atol=1e-3, rtol=0)
    np.testing.assert_allclose(got["obs"], want["obs"], atol=1e-3, rtol=0)
    np.testing.assert_allclose(got["rew"], want["rew"], atol=1e-3, rtol=0)
    for k in ("reset", "progress", "success"):
        np.testing.assert_array_equal(got[k], want[k])
        assert got[k].dtype == want[k].dtype
    assert got["extras"] == want["extras"]
    assert (got["progress"] == step).all()
    moved = np.abs(got["obs"] - rollout["ttrace"][0]["obs"]).max()
    assert moved > 1e-3, "the policy did not move the robot"


def test_every_control_step_is_one_physics_step(rollout):
    assert rollout["physics_calls"] == 1 + N_STEPS
    # and the extras carry the names the eval metrics are built from
    assert "raw_reward" in rollout["ttrace"][1]["extras"]
    assert rollout["ttrace"][1]["extras"] == rollout["jtrace"][1]["extras"]


def test_golden_trace_replayed_by_the_port():
    """tests/test_golden_trajectory.py through the port: 2 envs, 8
    ``train=True`` steps, actions from RandomState(11), from the JAX
    ``init_state(PRNGKey(7))`` handed over as numpy; at that test's atol."""
    jenv, _, _, tenv, _ = tp.make_envs(
        ["--taskcfg", "grasp_cube", "--algo.num_envs", "2"])
    init = tp.jax_env_state_to_numpy(jenv.init_state(jax.random.PRNGKey(7)))
    state = convert.env_state_from_numpy(init, tenv.make_generator(7))
    acts = np.random.RandomState(11).uniform(
        -1, 1, (8, 2, tenv.num_actions)).astype(np.float32)
    qpos, obj = [], []
    with torch.no_grad():
        for t in range(8):
            state, _, _, reset, _ = tenv.step(state, torch.as_tensor(acts[t]),
                                              train=True)
            assert not bool(reset.any())
            qpos.append(state.sim.robot.qpos.numpy())
            obj.append(state.sim.body.pos.numpy())
    qpos_ref = np.load(os.path.join(GOLDEN_DIR, "grasp_cube_qpos.npy"))
    obj_ref = np.load(os.path.join(GOLDEN_DIR, "grasp_cube_objpos.npy"))
    np.testing.assert_allclose(np.stack(qpos), qpos_ref, atol=2e-4)
    np.testing.assert_allclose(np.stack(obj), obj_ref, atol=2e-4)
