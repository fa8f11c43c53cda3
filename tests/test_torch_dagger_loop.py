"""DAgger's collection, checkpoints, demo ingestion and CLI in the port
(``partmanip_tpu_torch/algos/dagger.py``, ``train_torch.py``), held against
the JAX package where it has a counterpart:

* ``_collect`` on a tiny grasp_cube state env (2 envs, 1 inner substep, 2
  steps appended to a buffer that wraps): the buffer rows, ``write_idx``,
  ``size``, the reward-reset mask and the infos against the JAX package's
  ``_collect`` (``tests/golden_torch/dagger_collect.npz``, made by
  ``make_dagger_golden.py``, with the exploration noise JAX drew from its
  key fed to the port).  Rows of the reset observation within 1e-5, rows
  and infos after a step within 1e-3 (a control step of effort-clamped
  drives), bookkeeping exact;
* the reward-driven reset mask carries across iterations (the port of
  ``tests/test_distill.py::test_force_mask_carries_across_iterations``);
* save → resume round trip of the student and its Adam state, and resume
  from a DAgger checkpoint the JAX package wrote: the same student and Adam
  state;
* ``load_offline`` of a tiny .npy tree (more rows than the buffer holds)
  against the JAX package's;
* ``train_torch.py --algocfg dagger --device cpu``: two iterations of a
  normal_state MLP student on open_drawer write ``model_2.ckpt``, and a
  run resumed from it takes iteration 3."""

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
from partmanip_tpu.models.actor_critic import ACParams
from partmanip_tpu_torch import config as tconfig
from partmanip_tpu_torch.algos import dagger as tdagger
from partmanip_tpu_torch.envs.grasp_cube import GraspCubeEnv
from partmanip_tpu_torch.utils import convert

import train_torch

O, A = 37, 7      # grasp_cube normal_state, actions


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with tv.one_torch_thread():
        yield


def _logger(root):
    return SimpleNamespace(save_ckpt_dir=str(root), info=lambda record, iteration: None)


def _grasp_dagger(root, **algo):
    """The port's DAgger on the tiny grasp_cube env of tests/_torch_dagger.py
    (an MLP 16 student, an MLP teacher of the JAX package)."""
    cfg, sp = tconfig.process_cfgs(list(td.FLAGS))
    env = GraspCubeEnv(cfg["task"], sp, device="cpu")
    teacher = td.write_teacher(os.path.join(root, "teacher.ckpt"), O, A)
    acfg = dict(cfg["algo"], teacher=teacher, model=td.model_cfg(), test_only=False, **algo)
    return tdagger.DAgger(env, acfg, _logger(root))


def test_collect_matches_the_jax_collect(tmp_path):
    g = np.load(td.GOLDEN)
    dag = _grasp_dagger(tmp_path)
    env = dag.env
    draws = td.cube_draws()
    with torch.no_grad():
        state, obs = env.reset(env.init_state(env.make_generator(0), draws), draws)
    o = obs["normal_state"]
    np.testing.assert_allclose(o.numpy(), g["obs0"], atol=1e-5, rtol=0)
    dag.student.load_state_dict(convert.actor_critic_from_jax(td.ac_tree(3, O, A)))
    ts = tdagger.DaggerTrainState(
        buffer=tdagger.DaggerBuffer(
            stu_obs=torch.as_tensor(g["stu_in"]), tea_obs=torch.as_tensor(g["tea_in"]),
            write_idx=torch.tensor(td.START_WRITE, dtype=torch.int32),
            size=torch.tensor(td.START_SIZE, dtype=torch.int32)),
        stu_obs=o, tea_obs=o, rng=env.make_generator(5),
        pending_force=torch.zeros(td.E, dtype=torch.bool),
        opt=tdagger.Adam(list(dag.student.named_parameters())))
    ts, state, infos = dag._collect(ts, state, noise=torch.as_tensor(g["noise"]))

    cap = td.BUF_SIZE * td.E
    rows = (td.START_WRITE + np.arange(td.N_STEPS * td.E)) % cap      # 4 5 | 0 1
    buf = ts.buffer
    for out, key in ((buf.stu_obs, "stu_out"), (buf.tea_obs, "tea_out")):
        got, want = out.numpy(), g[key]
        np.testing.assert_allclose(got[rows[:td.E]], want[rows[:td.E]], atol=1e-5, rtol=0)
        np.testing.assert_allclose(got[rows[td.E:]], want[rows[td.E:]], atol=1e-3, rtol=0)
        untouched = np.setdiff1d(np.arange(cap), rows)
        np.testing.assert_array_equal(got[untouched], want[untouched])
    assert (int(buf.write_idx), int(buf.size)) == (int(g["write_idx"]), int(g["size"])) == (2, 6)
    np.testing.assert_array_equal(state.progress.numpy(), g["progress"])
    np.testing.assert_array_equal(ts.pending_force.numpy(), g["pending_force"])
    np.testing.assert_allclose(ts.stu_obs.numpy(), g["obs_last"], atol=1e-3, rtol=0)
    want = {k[len("info/"):]: g[k] for k in g.files if k.startswith("info/")}
    assert sorted(infos) == sorted(want)
    for k, v in want.items():
        assert infos[k].shape == v.shape, k
        np.testing.assert_allclose(infos[k].numpy(), v, atol=1e-3, rtol=0, err_msg=k)


def test_force_mask_carries_across_iterations(tmp_path):
    """The reward-reset mask computed at step t resets its envs at t + 1,
    across the iteration boundary (the n_steps = 1 regime)."""
    rpath = os.path.join(tmp_path, "teacher_reward.npy")
    np.save(rpath, np.full(7, 1e6, np.float32))      # an unbeatable teacher curve
    dag = _grasp_dagger(tmp_path, n_steps=1, n_updates=1, n_minibatches=2,
                        reward_reset=True, teacher_reward=rpath)
    assert dag.reward_reset
    ts, es = dag.init_state(seed=0)
    # envs past the 10-step grace period with terrible reward
    es = es._replace(progress=torch.full((td.E,), 11, dtype=torch.int32),
                     epis_max_rew=torch.full((td.E,), 1e7),
                     epis_max_step=torch.full((td.E,), 11, dtype=torch.int32))
    ts, es, m = dag._dagger_iteration(ts, es, 1e-3)
    assert bool(ts.pending_force.all()) and float(m["Train/dagger_reward_reset_mean"]) == 1.0
    ts, es, _ = dag._dagger_iteration(ts, es, 1e-3)
    np.testing.assert_array_equal(es.progress.numpy(), np.ones(td.E))


def _adam_trees(adam):
    return {"count": int(adam.count), "mu": jax_params_to_numpy(adam.mu),
            "nu": jax_params_to_numpy(adam.nu)}


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_resume_restores_student_and_adam(tmp_path, writer):
    dag = _grasp_dagger(tmp_path)
    rs = np.random.RandomState(14)
    if writer == "port":
        ts, _ = dag.init_state(seed=0)
        for _ in range(2):
            for p in dag.student.parameters():
                p.grad = torch.as_tensor(rs.randn(*p.shape).astype(np.float32))
            ts.opt.step(1e-3)
        dag.total_envsteps = 6
        path = dag.save(3, ts)
        want_sd = {k: v.clone() for k, v in dag.student.state_dict().items()}
        want_opt = convert.adam_state_to_jax(ts.opt.state_dict())
        want_iter = (3, 6)
    else:
        # a checkpoint as the JAX package's DAgger.save writes it
        env = SimpleNamespace(num_obs={"normal_state": O}, num_actions=A,
                              max_episode_length=6, reset=lambda s: s)
        cfg, _ = jconfig.process_cfgs(list(td.FLAGS))
        jdag = jdagger.DAgger(env, dict(cfg["algo"], teacher=dag.teacher_path,
                                        model=td.model_cfg(), test_only=False),
                              _logger(tmp_path / "jax"))
        params = ACParams(**jax.tree.map(jnp.asarray, td.ac_tree(4, O, A)))
        opt = jdag.tx.init(params)
        for _ in range(2):
            grads = jax.tree.map(lambda x: jnp.asarray(rs.randn(*x.shape), jnp.float32), params)
            updates, opt = jdag.tx.update(grads, opt, params)
            params = optax.apply_updates(params, updates)
        jdag.total_envsteps = 40
        jdag.save(5, jdagger.DaggerTrainState(params, opt, None, None, None, None, None))
        path = os.path.join(tmp_path, "jax", "model_5.ckpt")
        want_sd = convert.actor_critic_from_jax(jax_params_to_numpy(params))
        want_opt = _adam_trees(opt.inner_state[0])
        want_iter = (5, 40)

    fresh = _grasp_dagger(tmp_path)
    ts, _ = fresh.init_state(seed=1)
    ts = fresh.resume(ts, path)
    assert (fresh.curr_iter, fresh.total_envsteps) == want_iter
    got_sd = fresh.student.state_dict()
    for k, v in want_sd.items():
        assert torch.equal(got_sd[k], v), k
    got_opt = convert.adam_state_to_jax(ts.opt.state_dict())
    assert got_opt["count"] == want_opt["count"] == 2
    for part in ("mu", "nu"):
        for (path_g, a), (path_w, b) in zip(
                jax.tree_util.tree_flatten_with_path(got_opt[part])[0],
                jax.tree_util.tree_flatten_with_path(want_opt[part])[0]):
            assert path_g == path_w
            np.testing.assert_array_equal(a, b, err_msg=f"{part} {path_g}")
    assert any(np.asarray(x).any() for x in jax.tree.leaves(got_opt["nu"]))


def test_load_offline_matches_the_jax_ingest(tmp_path):
    """Six demo rows (2 scenes × 3 steps, an 8-voxel TSDF + 3 proprio dims
    each) into a 4-row bf16 buffer that already holds one: the rows the JAX
    package's sequential writes leave, the same write index and size."""
    root = tmp_path / "demos"
    rs = np.random.RandomState(15)
    for scene in ("scene_a", "scene_b"):
        os.makedirs(root / scene)
        for step in range(3):
            np.save(root / scene / f"step_{step:03d}.npy",
                    {"tsdf": rs.randn(2, 2, 2).astype(np.float32),
                     "proprio_state": rs.randn(3).astype(np.float32),
                     "tea_obs": rs.randn(O).astype(np.float32)}, allow_pickle=True)
    env = SimpleNamespace(num_obs={"mesh_tsdf": 11, "proprio_state": 3, "normal_state": O},
                          num_actions=A, max_episode_length=6, reset=lambda s: s,
                          device=torch.device("cpu"))
    teacher = td.write_teacher(os.path.join(tmp_path, "teacher.ckpt"), O, A)
    stu0 = rs.randn(4, 11).astype(np.float32)
    tea0 = rs.randn(4, O).astype(np.float32)
    out = []
    for module, dagger, to in ((jconfig, jdagger, jnp.asarray),
                               (tconfig, tdagger, torch.as_tensor)):
        cfg, _ = module.process_cfgs(["--algocfg", "dagger"])
        dag = dagger.DAgger(env, dict(cfg["algo"], obs_mode="mesh_tsdf", add_proprio_obs=True,
                                      num_envs=2, buf_size=2, teacher=teacher,
                                      model=td.model_cfg(), test_only=False),
                            _logger(tmp_path))
        bf16 = jnp.bfloat16 if dagger is jdagger else torch.bfloat16
        i32 = (lambda x: jnp.int32(x)) if dagger is jdagger else \
            (lambda x: torch.tensor(x, dtype=torch.int32))
        buf = dagger.DaggerBuffer(stu_obs=to(stu0).astype(bf16) if dagger is jdagger
                                  else to(stu0).to(bf16),
                                  tea_obs=to(tea0), write_idx=i32(1), size=i32(1))
        ts = dagger.DaggerTrainState(*[None] * len(dagger.DaggerTrainState._fields))
        buf = dag.load_offline(ts._replace(buffer=buf), str(root)).buffer
        out.append([np.asarray(jnp.asarray(buf.stu_obs, jnp.float32)) if dagger is jdagger
                    else buf.stu_obs.float().numpy(),
                    np.asarray(buf.tea_obs), int(buf.write_idx), int(buf.size)])
    (js, jt, jw, jn), (ts_, tt, tw, tn) = out
    np.testing.assert_array_equal(ts_, js)
    np.testing.assert_array_equal(tt, jt)
    assert (tw, tn) == (jw, jn) == (3, 4)


def test_cli_trains_saves_and_resumes(tmp_path):
    """``train_torch.py --algocfg dagger`` on the CPU: two iterations of a
    normal_state MLP student distilled from the committed open_drawer
    expert, an evaluation at iteration 2, ``model_2.ckpt``; resumed from it,
    one more iteration continues the Adam count."""
    def args(iterations, *extra):
        return ["--taskcfg", "open_drawer", "--algocfg", "dagger", "--device", "cpu",
                "--algo.obs_mode", "normal_state", "--algo.model.network.name", "MLP",
                "--algo.model.network.hid_dim", "16", "--algo.teacher", tv.TEACHER,
                "--algo.num_envs", "2", "--algo.buf_size", "8",
                "--algo.max_iterations", str(iterations), "--algo.save_frequence", "2",
                "--algo.eval_frequence", "2", "--algo.eval_round", "1",
                "--task.maxEpisodeLength", "3", "--task.asset.assetRoot",
                str(tmp_path / "assets"), "--task.asset.num_objects", "2",
                "--log.mode", "screen", "--log.log_root", str(tmp_path),
                "--exp_name", "dagger_cli_seed3", *extra]
    runner = train_torch.main(args(2))
    steps = runner.n_updates * runner.num_mini_batches
    ckpt = os.path.join(runner.save_ckpt_dir, "model_2.ckpt")
    assert os.path.exists(ckpt)
    assert runner.curr_iter == 2 and len(runner.train_logs) == 2
    log = runner.last_log
    assert all(np.isfinite(v) for v in log.values())
    assert log["Train/cur_buf_size"] == 4 and "Val/succ_rate_max" in log
    assert runner.last_ts.opt.count == 2 * steps
    resumed = train_torch.main(args(3, "--resume", ckpt))
    assert resumed.curr_iter == 3 and len(resumed.train_logs) == 1
    assert resumed.last_ts.opt.count == 3 * steps
