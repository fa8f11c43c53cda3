"""DAgger's update of the port (``partmanip_tpu_torch/algos/dagger.py``
``_dagger_iteration``, ``algos/storage.buffer_minibatch_indices``,
``algos/ppo.Adam``) against the JAX package's
(``partmanip_tpu/algos/dagger.py``), in f32 at small widths: a state-norm
MLP teacher (9 obs, 4 actions), an MLP 16 or a PointNet student, 4 envs.

No PRNG stream has to agree: both sides get the same weights, the same
buffer rows and the same minibatch indices (inside the test the JAX
runner's ``_collect`` and ``storage.buffer_minibatch_indices`` are swapped
for them, and the port's alike).

* the minibatch indices' structure: per epoch the first ``min(size, n·mb)``
  positions are distinct valid rows, the rest wrap mod ``size``;
* one chunk's loss and gradients against ``jax.value_and_grad(DAgger._loss)``
  with the teacher's labels through its frozen RMS: within 1e-5 relative
  (per tensor, of its largest entry); the critic and ``log_std`` get none;
* Adam fed the same gradients on both sides (over nine decades, zero for
  the critic and ``log_std``): moments within 1e-6 relative, parameters
  within 1e-6 relative plus 1e-5·lr (the update's own rounding), the count
  equal;
* one full update (2 epochs × 4 minibatches of 8 rows in 2 chunks of 4)
  from a bf16 buffer: the loss within 1e-5 relative, the Adam count equal,
  the moments within 1e-5 (μ) / 2e-5 (ν) of their tensor's largest entry,
  the parameters within 2·lr (Adam's first step is a sign function:
  a tiny gradient the two frameworks round to opposite signs moves a
  weight by 2·lr); below 16 buffer rows the student stays bit for bit as
  it was on both sides while the optimizer state advances."""

import os
from types import SimpleNamespace

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

import _torch_dagger as td
import _torch_vision as tv
from _torch_port import jax_params_to_numpy
from partmanip_tpu import config as jconfig
from partmanip_tpu.algos import dagger as jdagger
from partmanip_tpu.algos import storage as jstorage
from partmanip_tpu.models.actor_critic import ACParams
from partmanip_tpu_torch import config as tconfig
from partmanip_tpu_torch.algos import dagger as tdagger
from partmanip_tpu_torch.algos import storage as tstorage
from partmanip_tpu_torch.utils import convert

O_TEA, A, E = 9, 4, 4
LR = np.float32(1e-3)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with tv.one_torch_thread():
        yield


def _rms():
    rs = np.random.RandomState(2)
    return {"n": np.int32(5), "mean": rs.randn(1, O_TEA).astype(np.float32),
            "S": (5.0 * (0.5 + rs.rand(1, O_TEA))).astype(np.float32)}


def _pair(tmp_path, network="MLP", **algo):
    """(JAX runner, port runner, JAX student params) on a stand-in env, the
    same state-norm teacher and the same student weights."""
    mode = "normal_state" if network == "MLP" else "depth_pc"
    teacher = td.write_teacher(os.path.join(tmp_path, "teacher.ckpt"), O_TEA, A, rms=_rms())
    env = SimpleNamespace(num_obs={"normal_state": O_TEA, "depth_pc": 3072, "proprio_state": 0},
                          num_actions=A, max_episode_length=5, reset=lambda s: s,
                          device=torch.device("cpu"))
    logger = SimpleNamespace(save_ckpt_dir=str(tmp_path))
    runners = []
    for module, dagger in ((jconfig, jdagger), (tconfig, tdagger)):
        cfg, _ = module.process_cfgs(["--algocfg", "dagger"])
        a = dict(cfg["algo"], num_envs=E, n_steps=1, n_updates=2, n_minibatches=4,
                 minibatch_size=8, minibatch_cap=4, buf_size=12, obs_mode=mode,
                 add_proprio_obs=False, model=td.model_cfg(network), teacher=teacher,
                 reward_reset=False, test_only=False, **algo)
        runners.append(dagger.DAgger(env, a, logger))
    jdag, tdag = runners
    tree = (td.ac_tree(3, O_TEA, A) if network == "MLP" else tv.student_tree(A))
    tdag.student.load_state_dict(convert.actor_critic_from_jax(tree, network))
    return jdag, tdag, ACParams(**jax.tree.map(jnp.asarray, tree))


def _per_tensor_close(got: dict, want: dict, rel, what):
    assert sorted(got) == sorted(want), what
    for k in want:
        w = want[k].double()
        err = float((got[k].double() - w).abs().max())
        assert err <= rel * float(w.abs().max()) + 1e-30, f"{what} {k}: {err} vs max {float(w.abs().max())}"


@pytest.mark.parametrize("size", [0, 5, 40])
def test_buffer_minibatch_indices_structure(size):
    cap, n_epochs, n_batches, mb = 48, 2, 4, 8
    gen = torch.Generator().manual_seed(3)
    idx = tstorage.buffer_minibatch_indices(gen, cap, torch.tensor(size, dtype=torch.int32),
                                            n_epochs, n_batches, mb)
    assert idx.shape == (n_epochs * n_batches, mb) and idx.dtype == torch.int64
    epochs = idx.reshape(n_epochs, n_batches * mb)
    k = min(size, n_batches * mb)
    for rows in epochs:
        head = rows[:k]
        assert len(set(head.tolist())) == k and bool((head < size).all())
        for p in range(k, n_batches * mb):
            assert rows[p] == rows[p % max(size, 1)]
    if size > 1:
        assert not torch.equal(epochs[0], epochs[1])       # a fresh shuffle per epoch


@pytest.mark.parametrize("network", ["MLP", "PointNet"])
def test_chunk_loss_and_gradients(tmp_path, network):
    jdag, tdag, params = _pair(tmp_path, network)
    rs = np.random.RandomState(11)
    stu = (0.5 * rs.randn(6, tdag.stu_num_obs)).astype(np.float32)
    tea = rs.randn(6, O_TEA).astype(np.float32)
    # the JAX chunk, as _dagger_iteration computes it
    tea_o, _ = jdag._rms_lib.normalize(jdag.tea_rms, jnp.asarray(tea), False)
    jact = jdag.teacher.act(jdag.teacher_params, tea_o)
    jloss, jgrads = jax.jit(jax.value_and_grad(jdag._loss))(params, jnp.asarray(stu), jact)

    tact = tdag._label(torch.as_tensor(tea))
    np.testing.assert_allclose(tact.numpy(), np.asarray(jact), rtol=1e-5, atol=1e-7)
    tdag.student.zero_grad(set_to_none=True)
    loss = tdag._loss(torch.as_tensor(stu), tact)
    loss.backward()
    assert abs(loss.item() - float(jloss)) <= 1e-5 * abs(float(jloss))
    want = convert.actor_critic_from_jax(jax_params_to_numpy(jgrads), network)
    got = {}
    for name, p in tdag.student.named_parameters():
        if name.startswith("critic.") or name == "log_std":
            assert p.grad is None and not want[name].any(), name
        else:
            got[name] = p.grad
    _per_tensor_close(got, {k: want[k] for k in got}, 1e-5, "gradient")


def test_adam_matches_optax_on_identical_gradients(tmp_path):
    jdag, tdag, params = _pair(tmp_path)
    rs = np.random.RandomState(12)
    jopt = jdag.tx.init(params)
    jopt.hyperparams["learning_rate"] = LR
    ts_opt = tdagger.Adam(list(tdag.student.named_parameters()))
    for step in range(3):
        g = jax.tree.map(lambda x: (rs.randn(*x.shape) * 10.0 ** rs.randint(-9, 0)
                                    ).astype(np.float32), jax_params_to_numpy(params))
        g["critic"] = jax.tree.map(np.zeros_like, g["critic"])
        g["log_std"] = np.zeros_like(g["log_std"])
        updates, jopt = jdag.tx.update(ACParams(**jax.tree.map(jnp.asarray, g)), jopt, params)
        params = optax.apply_updates(params, updates)
        tg = convert.actor_critic_from_jax(g)
        for name, p in tdag.student.named_parameters():
            p.grad = None if name.startswith("critic.") or name == "log_std" else tg[name]
        ts_opt.step(float(LR))
    adam = jopt.inner_state[0]
    assert int(adam.count) == ts_opt.count == 3
    state = ts_opt.state_dict()
    for part, tree in (("mu", adam.mu), ("nu", adam.nu)):
        want = convert.actor_critic_from_jax(jax_params_to_numpy(tree))
        for k, v in state[part].items():
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-6, atol=1e-30,
                                       err_msg=f"{part} {k}")
    want = convert.actor_critic_from_jax(jax_params_to_numpy(params))
    for k, v in tdag.student.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-6, atol=1e-5 * LR,
                                   err_msg=k)


@pytest.mark.parametrize("size,buf_dtype", [(40, "bf16"), (8, "f32")],
                         ids=["update_bf16_buffer", "small_buffer_gate"])
def test_update_matches_the_jax_update(tmp_path, monkeypatch, size, buf_dtype):
    jdag, tdag, params = _pair(tmp_path, buf_dtype=buf_dtype)
    cap = 12 * E
    rs = np.random.RandomState(13)
    stu = torch.as_tensor(rs.randn(cap, O_TEA).astype(np.float32))
    if buf_dtype == "bf16":             # values the bf16 buffer holds exactly
        stu = stu.to(torch.bfloat16).float()
    stu = stu.numpy()
    tea = rs.randn(cap, O_TEA).astype(np.float32)
    mb, chunk, n_chunks = tdag.minibatch_sizes(cap)
    assert (mb, chunk, n_chunks) == (8, 4, 2)
    idx = rs.randint(0, size, (2 * 4, mb)).astype(np.int32)
    infos = {"reward": rs.randn(1, E).astype(np.float32),
             "dagger_reward_reset": (rs.rand(1, E) < 0.5).astype(np.float32)}

    jdt = jnp.bfloat16 if buf_dtype == "bf16" else jnp.float32
    jts = jdagger.DaggerTrainState(
        student=params, opt=jdag.tx.init(params),
        buffer=jdagger.DaggerBuffer(stu_obs=jnp.asarray(stu).astype(jdt), tea_obs=jnp.asarray(tea),
                                    write_idx=jnp.int32(size % cap), size=jnp.int32(size)),
        stu_obs=jnp.zeros((E, O_TEA)), tea_obs=jnp.zeros((E, O_TEA)),
        rng=jax.random.PRNGKey(0), pending_force=jnp.zeros(E, bool))
    jinfos = {k: jnp.asarray(v) for k, v in infos.items()}
    monkeypatch.setattr(jdag, "_collect", lambda ts, es: (ts, es, jinfos))
    monkeypatch.setattr(jstorage, "buffer_minibatch_indices", lambda *a, **k: jnp.asarray(idx))
    jts2, _, jm = jax.jit(jdag._dagger_iteration)(jts, None, LR)

    tdt = torch.bfloat16 if buf_dtype == "bf16" else torch.float32
    before = {k: v.clone() for k, v in tdag.student.state_dict().items()}
    tts = tdagger.DaggerTrainState(
        buffer=tdagger.DaggerBuffer(
            stu_obs=torch.as_tensor(stu).to(tdt), tea_obs=torch.as_tensor(tea),
            write_idx=torch.tensor(size % cap, dtype=torch.int32),
            size=torch.tensor(size, dtype=torch.int32)),
        stu_obs=torch.zeros(E, O_TEA), tea_obs=torch.zeros(E, O_TEA),
        rng=torch.Generator().manual_seed(0), pending_force=torch.zeros(E, dtype=torch.bool),
        opt=tdagger.Adam(list(tdag.student.named_parameters())))
    tinfos = {k: torch.as_tensor(v) for k, v in infos.items()}
    monkeypatch.setattr(tdag, "_collect", lambda ts, es: (ts, es, tinfos))
    monkeypatch.setattr(tstorage, "buffer_minibatch_indices",
                        lambda *a, **k: torch.as_tensor(idx).long())
    tts2, _, tm = tdag._dagger_iteration(tts, None, float(LR))

    jm = {k: float(v) for k, v in jm.items()}
    tm = {k: float(v) for k, v in tm.items()}
    assert sorted(tm) == sorted(jm)
    loss_j = jm.pop("Train/dagger_loss")
    assert abs(tm.pop("Train/dagger_loss") - loss_j) <= 1e-5 * loss_j
    for k in jm:
        assert tm[k] == pytest.approx(jm[k], rel=1e-6, abs=1e-7), k
    adam = jts2.opt.inner_state[0]
    assert int(adam.count) == tts2.opt.count == 2 * 4
    state = tts2.opt.state_dict()
    for part, tree, rel in (("mu", adam.mu, 1e-5), ("nu", adam.nu, 2e-5)):
        want = convert.actor_critic_from_jax(jax_params_to_numpy(tree))
        assert float(want["actor.head.weight"].abs().max()) > 0, "the optimizer did not advance"
        _per_tensor_close(state[part], want, rel, part)
    want = convert.actor_critic_from_jax(jax_params_to_numpy(jts2.student))
    got = tdag.student.state_dict()
    if size < tdagger.MIN_UPDATE_ROWS:
        for k in got:
            assert torch.equal(got[k], before[k]) and torch.equal(want[k], before[k]), k
    else:
        moved = max(float((got[k] - before[k]).abs().max()) for k in got)
        assert moved > 4 * LR               # the steps moved it beyond the tolerance
        for k in got:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0,
                                       atol=2 * LR, err_msg=k)
