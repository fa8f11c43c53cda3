"""DAgger on the TSDF student (``partmanip_tpu_torch/algos/dagger.py`` with a
Conv3DNet on ``mesh_tsdf`` volumes) against the JAX package's, at res 8:

* one DAgger update (2 epochs × 4 minibatches of 8 rows in 2 chunks of 4)
  from a bf16 buffer of TSDF rows, with the buffer, the collection's
  metrics and the minibatch indices injected on both sides (no PRNG stream
  has to agree): the loss within 1e-5 relative, the Adam count equal, the
  moments within 5e-5 (μ) / 1e-4 (ν) of their tensor's largest entry (a
  conv bias's gradient sums every output voxel of the batch, and steps
  after the first take it at parameters that may already differ by 2·lr),
  the parameters within 2·lr (Adam's first step is a sign function);
* ``load_offline`` of a tree the port's collector wrote (open_drawer's
  committed expert, 2 envs, 3 steps, res 8) into a buffer that already
  holds rows: the same rows bit for bit, the same write index and size;
* the port's own collection on that env writes the volumes its env
  observed, rounded through bf16."""

import os
import random
from types import SimpleNamespace

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import _torch_dagger as td
import _torch_tsdf as tt
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

RES, O_TEA, A, E = 8, 9, 4, 4
LR = np.float32(1e-3)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with tv.one_torch_thread():
        yield


def _pair(tmp_path, num_obs=RES ** 3, tea_obs=O_TEA, num_actions=A, **algo):
    """(JAX runner, port runner, JAX student params): a Conv3DNet student on
    ``mesh_tsdf`` rows of a stand-in env, the same state teacher."""
    teacher = td.write_teacher(os.path.join(tmp_path, "teacher.ckpt"), tea_obs, num_actions)
    env = SimpleNamespace(num_obs={"mesh_tsdf": num_obs, "normal_state": tea_obs,
                                   "proprio_state": 0},
                          num_actions=num_actions, max_episode_length=5, reset=lambda s: s,
                          device=torch.device("cpu"))
    runners = []
    for module, dagger in ((jconfig, jdagger), (tconfig, tdagger)):
        cfg, _ = module.process_cfgs(["--algocfg", "dagger"])
        a = dict(cfg["algo"], **{**dict(
            num_envs=E, n_steps=1, n_updates=2, n_minibatches=4, minibatch_size=8,
            minibatch_cap=4, buf_size=12, model=tt.model_cfg(), teacher=teacher,
            reward_reset=False, test_only=False), **algo})
        runners.append(dagger.DAgger(env, a, SimpleNamespace(save_ckpt_dir=str(tmp_path))))
    jdag, tdag = runners
    tree = tt.student_tree(RES, num_actions)
    tdag.student.load_state_dict(convert.actor_critic_from_jax(tree, "Conv3DNet"))
    return jdag, tdag, ACParams(**jax.tree.map(jnp.asarray, tree))


def _per_tensor_close(got, want, rel, what):
    assert sorted(got) == sorted(want), what
    for k in want:
        w = want[k].double()
        err = float((got[k].double() - w).abs().max())
        assert err <= rel * float(w.abs().max()) + 1e-30, f"{what} {k}: {err}"


def test_update_matches_the_jax_update(tmp_path, monkeypatch):
    jdag, tdag, params = _pair(tmp_path)
    assert tdag.student.actor.stack.res == RES and tdag.stu_num_obs == RES ** 3
    cap = 12 * E
    rs = np.random.RandomState(13)
    stu = torch.as_tensor(rs.uniform(-1, 1, (cap, RES ** 3)).astype(np.float32))
    stu = stu.to(torch.bfloat16).float().numpy()       # rows the bf16 buffer holds exactly
    tea = rs.randn(cap, O_TEA).astype(np.float32)
    mb, chunk, n_chunks = tdag.minibatch_sizes(cap)
    assert (mb, chunk, n_chunks) == (8, 4, 2)
    size = 40
    idx = rs.randint(0, size, (2 * 4, mb)).astype(np.int32)
    infos = {"reward": rs.randn(1, E).astype(np.float32),
             "dagger_reward_reset": np.zeros((1, E), np.float32)}

    jts = jdagger.DaggerTrainState(
        student=params, opt=jdag.tx.init(params),
        buffer=jdagger.DaggerBuffer(stu_obs=jnp.asarray(stu).astype(jnp.bfloat16),
                                    tea_obs=jnp.asarray(tea), write_idx=jnp.int32(size),
                                    size=jnp.int32(size)),
        stu_obs=jnp.zeros((E, RES ** 3)), tea_obs=jnp.zeros((E, O_TEA)),
        rng=jax.random.PRNGKey(0), pending_force=jnp.zeros(E, bool))
    jinfos = {k: jnp.asarray(v) for k, v in infos.items()}
    monkeypatch.setattr(jdag, "_collect", lambda ts, es: (ts, es, jinfos))
    monkeypatch.setattr(jstorage, "buffer_minibatch_indices", lambda *a, **k: jnp.asarray(idx))
    jts2, _, jm = jax.jit(jdag._dagger_iteration)(jts, None, LR)

    before = {k: v.clone() for k, v in tdag.student.state_dict().items()}
    tts = tdagger.DaggerTrainState(
        buffer=tdagger.DaggerBuffer(
            stu_obs=torch.as_tensor(stu).to(torch.bfloat16), tea_obs=torch.as_tensor(tea),
            write_idx=torch.tensor(size, dtype=torch.int32),
            size=torch.tensor(size, dtype=torch.int32)),
        stu_obs=torch.zeros(E, RES ** 3), tea_obs=torch.zeros(E, O_TEA),
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
    for part, tree, rel in (("mu", adam.mu, 5e-5), ("nu", adam.nu, 1e-4)):
        want = convert.actor_critic_from_jax(jax_params_to_numpy(tree), "Conv3DNet")
        assert float(want["actor.stack.convs.0.weight"].abs().max()) > 0
        _per_tensor_close(state[part], want, rel, part)
    want = convert.actor_critic_from_jax(jax_params_to_numpy(jts2.student), "Conv3DNet")
    got = tdag.student.state_dict()
    moved = max(float((got[k] - before[k]).abs().max()) for k in got)
    assert moved > 4 * LR
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0, atol=2 * LR,
                                   err_msg=k)


@pytest.fixture(scope="module")
def collected(tmp_path_factory):
    """A tree written by ``collect_demos_torch.py`` on the CPU: open_drawer's
    committed expert, 2 envs, one 3-step episode, mesh_tsdf at res 8."""
    import collect_demos_torch
    root = tmp_path_factory.mktemp("collected")
    out = str(root / "demos")
    summary = collect_demos_torch.main([
        "--device", "cpu", "--taskcfg", "open_drawer", "--algo.num_envs", "2",
        "--task.maxEpisodeLength", "3", "--task.obs_mode.tsdf.resolution", str(RES),
        "--task.asset.num_objects", "3", "--task.asset.assetRoot", str(root / "assets"),
        "--teacher", tv.TEACHER, "--out", out])
    assert summary["rows"] == 6
    return out, root


def test_load_offline_of_a_collected_tree(tmp_path, collected):
    out, _ = collected
    rs = np.random.RandomState(3)
    stu0 = rs.uniform(-1, 1, (4 * 2, RES ** 3)).astype(np.float32)
    tea0 = rs.randn(4 * 2, 53).astype(np.float32)
    bufs = []
    for k, dagger in enumerate((jdagger, tdagger)):
        jdag, tdag, _ = _pair(tmp_path / str(k), tea_obs=53, num_actions=10, num_envs=2,
                              buf_size=4)
        dag = jdag if dagger is jdagger else tdag
        if dagger is jdagger:
            buf = dagger.DaggerBuffer(stu_obs=jnp.asarray(stu0).astype(jnp.bfloat16),
                                      tea_obs=jnp.asarray(tea0), write_idx=jnp.int32(5),
                                      size=jnp.int32(5))
        else:
            buf = dagger.DaggerBuffer(stu_obs=torch.as_tensor(stu0).to(torch.bfloat16),
                                      tea_obs=torch.as_tensor(tea0),
                                      write_idx=torch.tensor(5, dtype=torch.int32),
                                      size=torch.tensor(5, dtype=torch.int32))
        ts = dagger.DaggerTrainState(*[None] * len(dagger.DaggerTrainState._fields))
        buf = dag.load_offline(ts._replace(buffer=buf), out).buffer
        stu = (np.asarray(jnp.asarray(buf.stu_obs, jnp.float32)) if dagger is jdagger
               else buf.stu_obs.float().numpy())
        bufs.append((stu, np.asarray(buf.tea_obs), int(buf.write_idx), int(buf.size)))
    (js, jt, jw, jn), (ts_, tt_, tw, tn) = bufs
    np.testing.assert_array_equal(ts_, js)
    np.testing.assert_array_equal(tt_, jt)
    assert (tw, tn) == (jw, jn) == (3, 8)         # 5 + 6 rows wrap a buffer of 8


def test_collection_writes_the_observed_volumes(collected):
    """The port's DAgger collection on the TSDF env: the rows it writes are
    the volumes the env observed (through bf16) and the teacher's states."""
    from partmanip_tpu_torch.envs.open_drawer import OpenDrawerEnv
    _, root = collected
    cfg, sp = tconfig.process_cfgs([
        "--taskcfg", "open_drawer", "--algocfg", "dagger", "--algo.num_envs", "2",
        "--task.maxEpisodeLength", "3", "--task.obs_mode.tsdf.resolution", str(RES),
        "--task.asset.num_objects", "3", "--task.asset.assetRoot", str(root / "assets"),
        "--algo.teacher", tv.TEACHER, "--algo.buf_size", "4", "--algo.n_steps", "2"])
    random.seed(0)
    env = OpenDrawerEnv(cfg["task"], sp, device="cpu")
    dag = tdagger.DAgger(env, cfg["algo"], SimpleNamespace(save_ckpt_dir=str(root)))
    ts, es = dag.init_state(3)
    first = ts.stu_obs.clone()
    ts, es, infos = dag._collect(ts, es)
    buf = ts.buffer
    assert buf.stu_obs.dtype == torch.bfloat16 and buf.stu_obs.shape == (8, RES ** 3)
    assert int(buf.size) == 4 and infos["reward"].shape == (2, 2)
    assert torch.equal(buf.stu_obs[:2].float(), first.to(torch.bfloat16).float())
    assert bool((buf.stu_obs[:4].float().abs() <= 1).all())
    assert buf.tea_obs.shape == (8, 53) and bool(buf.tea_obs[:4].abs().sum(1).gt(0).all())
