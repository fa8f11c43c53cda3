"""The PPO train iteration of the port (``partmanip_tpu_torch/algos/
ppo.py`` ``_train_iteration``, ``algos/storage.py``) against the JAX
package's (``partmanip_tpu/algos/ppo.py``, ``algos/storage.py``), in f32 at
small widths (MLP 16-16, 8 envs × 4 steps, 7 observations, 4 actions).

Both trainers get the same weights, the same fixed rollout and the same
minibatch indices: inside the test the JAX trainer's ``_rollout`` and
``storage.minibatch_indices`` are swapped for them (and the port's alike),
so no PRNG stream has to agree.  One iteration then runs GAE, the actor
phase (KL gate, global-norm clip, Adam) and the critic phase; parameters,
Adam moments and counts, and the ``Train/*`` metrics must agree within
f32 tolerances (parameters 2e-6 absolute after 16 Adam steps of lr 1e-3:
re-association of the gradient sums moves each update by a relative ~1e-5;
metrics 1e-4 relative).  One case lowers ``desired_kl`` so that the gate
skips some minibatches, which must then leave the Adam state and its count
as they were."""

from types import SimpleNamespace

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import _torch_vision as tv

from partmanip_tpu import config as jconfig
from partmanip_tpu.algos import ppo as jppo_mod
from partmanip_tpu.algos import storage as jstorage
from partmanip_tpu_torch import config as tconfig
from partmanip_tpu_torch.algos import ppo as tppo_mod
from partmanip_tpu_torch.algos import rms as trms
from partmanip_tpu_torch.algos import storage as tstorage
from partmanip_tpu_torch.utils import convert

from _torch_port import jax_params_to_numpy

T, E, O, A = 4, 8, 7, 4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One PyTorch thread: the bakes and the plain steps are many small ops,
    which spin-wait under the test run's several workers when each op is
    split over every core (tests/_torch_vision.py)."""
    with tv.one_torch_thread():
        yield


def _cfg(module, **algo):
    cfg, _ = module.process_cfgs(["--taskcfg", "open_drawer", "--algocfg", "ppo"])
    a = cfg["algo"]
    a.update(num_envs=E, n_steps=T, n_updates=2, n_minibatches=4, lr=1e-3)
    a["model"]["network"].update(hid_dim=[16, 16], dtype="f32")
    for k, v in algo.items():
        if k in a["tricks"]:
            a["tricks"][k] = v
        else:
            a[k] = v
    return a


def _rollout_arrays(seed, shifted_rows=()):
    """A fixed rollout (numpy, time-major) whose stored means lie near the
    initial policy's; the flat rows ``shifted_rows`` get their stored mean
    moved far off, so the KL estimate of a minibatch made of them exceeds
    the gate."""
    rs = np.random.RandomState(seed)
    f = lambda *s: rs.normal(size=s).astype(np.float32)
    r = {"observations": f(T, E, O), "actions": np.tanh(f(T, E, A)) * 0.9,
         "rewards": f(T, E) * 0.5, "dones": rs.rand(T, E) < 0.2,
         "succs": rs.rand(T, E) < 0.1, "values": f(T, E) * 0.3,
         "log_probs": f(T, E) * 0.1 - 2.0, "mu": f(T, E, A) * 0.05,
         "sigma": np.full((T, E, A), np.log(0.5), np.float32)}
    r["succs"] &= r["dones"]
    mu = r["mu"].reshape(T * E, A)
    mu[np.asarray(shifted_rows, np.int64)] += 1.5
    r["mu"] = mu.reshape(T, E, A)
    return r, f(E, O), {"reward": f(T, E), "succ_rate": (rs.rand(T, E) < 0.3).astype(np.float32)}


def _run_both(monkeypatch, algo, kl_shift=()):
    jcfg, tcfg = _cfg(jconfig, **algo), _cfg(tconfig, **algo)
    env = SimpleNamespace(num_obs={"normal_state": O}, num_actions=A,
                          max_episode_length=5, reset=lambda s: s,
                          device=torch.device("cpu"))
    logger = SimpleNamespace(save_ckpt_dir="/nonexistent")
    jp = jppo_mod.PPO(env, jcfg, logger)
    tp = tppo_mod.PPO(env, tcfg, logger)

    params = jp.ac.init(jax.random.PRNGKey(3))
    tp.ac.load_state_dict(convert.actor_critic_from_jax(jax_params_to_numpy(params)))
    idx = np.random.RandomState(7).permutation(T * E).reshape(4, -1)
    idx = np.concatenate([idx, idx[::-1]]).astype(np.int32)      # 2 epochs
    ro_np, curr_obs, infos_np = _rollout_arrays(5, idx[list(kl_shift)].ravel())

    # the JAX trainer: fixed rollout and indices swapped in
    jts = jppo_mod.PPOTrainState(
        params=params, opt_actor=jp.tx_actor.init(jp._actor_subset(params)),
        opt_critic=jp.tx_critic.init(params.critic),
        rms=jppo_mod.rms_lib.RMSState(*map(jnp.asarray, _rms_np())),
        update_rms=jnp.asarray(False), curr_obs=jnp.asarray(curr_obs),
        rng=jax.random.PRNGKey(0))
    jro = jstorage.Rollout(**{k: jnp.asarray(v) for k, v in ro_np.items()})
    jinfos = {k: jnp.asarray(v) for k, v in infos_np.items()}
    monkeypatch.setattr(jp, "_rollout", lambda ts, es: (ts, es, jro, jinfos))
    monkeypatch.setattr(jstorage, "minibatch_indices",
                        lambda *a, **k: jnp.asarray(idx))
    lr = np.float32(1e-3)
    jts2, _, jmetrics = jax.jit(jp._train_iteration)(jts, None, lr)

    # the port's trainer on the same inputs
    opt_a, opt_c = tp._optimizers()
    tts = tppo_mod.PPOTrainState(
        rms=trms.RMSState(*[torch.as_tensor(x) for x in _rms_np()]),
        update_rms=torch.tensor(False), curr_obs=torch.as_tensor(curr_obs),
        rng=torch.Generator().manual_seed(0), opt_actor=opt_a, opt_critic=opt_c)
    tro = tstorage.Rollout(**{k: torch.as_tensor(v) for k, v in ro_np.items()})
    tinfos = {k: torch.as_tensor(v) for k, v in infos_np.items()}
    monkeypatch.setattr(tp, "_rollout", lambda ts, es: (ts, es, tro, tinfos))
    monkeypatch.setattr(tstorage, "minibatch_indices",
                        lambda *a, **k: torch.as_tensor(idx, dtype=torch.int64))
    tts2, _, tmetrics = tp._train_iteration(tts, None, float(lr))
    return jp, tp, jts2, tts2, jmetrics, tmetrics


def _rms_np():
    return (np.zeros((), np.int32), np.zeros((1, O), np.float32),
            np.full((1, O), 1e-4, np.float32))


@pytest.mark.parametrize("case", ["defaults", "tricks", "kl_gate_skips"])
def test_train_iteration_matches_jax(monkeypatch, case):
    algo = {"defaults": {},
            "tricks": dict(mini_adv_norm=True, whole_adv_norm=True,
                           use_clipped_value_loss=True, succ_value=5.0),
            "kl_gate_skips": dict(desired_kl=0.5)}[case]
    shift = (1, 3) if case == "kl_gate_skips" else ()
    jp, tp, jts, tts, jm, tm = _run_both(monkeypatch, algo, shift)

    want = convert.actor_critic_from_jax(jax_params_to_numpy(jts.params))
    got = tp.ac.state_dict()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=2e-6, rtol=0,
                                   err_msg=f"{case}: {k}")
    for part, jopt, topt in (("actor", jts.opt_actor, tts.opt_actor),
                             ("critic", jts.opt_critic, tts.opt_critic)):
        adam = [s for s in jax.tree.leaves(jopt, is_leaf=lambda x: hasattr(x, "nu"))
                if hasattr(s, "nu")][0]
        assert int(adam.count) == topt.count, f"{case}: {part} Adam count"
        conv = convert.adam_state_from_jax(_standin(adam), part)
        mine = topt.state_dict()
        for which in ("mu", "nu"):
            for name, t in conv[which].items():
                np.testing.assert_allclose(mine[which][name].numpy(), t.numpy(),
                                           atol=1e-7, rtol=1e-4,
                                           err_msg=f"{case}: {part} {which} {name}")
    jm = {k: float(v) for k, v in jm.items()}
    tm = {k: float(v) for k, v in tm.items()}
    assert set(jm) == set(tm)
    for k in jm:
        np.testing.assert_allclose(tm[k], jm[k], rtol=1e-4, atol=1e-6, err_msg=k)
    n_mb = 8
    if case == "kl_gate_skips":
        assert 0 < tm["Train/kl_update_count"] < n_mb
        assert tts.opt_actor.count == tm["Train/kl_update_count"]
    else:
        assert tm["Train/kl_update_count"] == n_mb == tts.opt_actor.count
    assert tts.opt_critic.count == n_mb


def _standin(adam):
    from partmanip_tpu_torch.utils.checkpoint import JaxAdamState
    np_tree = lambda t: jax.tree.map(np.asarray, t)
    return JaxAdamState(count=np.asarray(adam.count), mu=np_tree(adam.mu),
                        nu=np_tree(adam.nu))


@pytest.mark.parametrize("succ_value,whole", [(None, False), (5.0, True)])
def test_compute_returns_matches_jax(succ_value, whole):
    ro, _, _ = _rollout_arrays(11)
    last = np.random.RandomState(2).normal(size=E).astype(np.float32)
    jr, ja = jstorage.compute_returns(
        jstorage.Rollout(**{k: jnp.asarray(v) for k, v in ro.items()}),
        jnp.asarray(last), 0.99, 0.95, succ_value, whole)
    tr, ta = tstorage.compute_returns(
        tstorage.Rollout(**{k: torch.as_tensor(v) for k, v in ro.items()}),
        torch.as_tensor(last), 0.99, 0.95, succ_value, whole)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=1e-6, rtol=1e-6)
    # advantages vanish on done steps (before the whole-buffer norm)
    if not whole:
        assert np.all(ta.numpy()[ro["dones"]] == 0.0)


def test_minibatch_indices():
    """The JAX package's shapes and coverage: mb = min(total // n, 2048),
    drop-last; sequential tiles one partition over the epochs, random draws
    a fresh permutation per epoch."""
    g = torch.Generator().manual_seed(0)
    for total, n in ((32, 4), (4100, 2)):
        want = np.asarray(jstorage.minibatch_indices(jax.random.PRNGKey(0), total, n,
                                                     "sequential", n_epochs=3))
        got = tstorage.minibatch_indices(g, total, n, "sequential", n_epochs=3)
        np.testing.assert_array_equal(got.numpy(), want)
        r = tstorage.minibatch_indices(g, total, n, "random", n_epochs=3)
        assert tuple(r.shape) == want.shape
        per_epoch = r.reshape(3, -1)
        for row in per_epoch:
            assert len(set(row.tolist())) == row.numel() and int(row.max()) < total
        assert not torch.equal(per_epoch[0], per_epoch[1])
