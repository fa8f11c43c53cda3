"""Env-axis data parallelism over ranks (``partmanip_tpu_torch/parallel/
mesh.py``, PPO with ``parallel.num_devices`` > 1) on the CPU: two gloo
ranks, one spawned process each (``mesh.launch``).

* One ``_train_iteration`` of two ranks, each on its env columns of a fixed
  rollout with fixed minibatch indices (as ``tests/test_torch_ppo_train.py``
  feeds both packages), against the JAX package's iteration on a 2-device
  mesh (conftest provides 8 CPU devices; the rollout sharded over ``env``)
  and against the port's one process: parameters within 2e-6, metrics
  rtol 1e-4 (the tolerances of ``test_torch_ppo_train.py``).
* ``train_torch.main`` with ``--parallel.num_devices 2`` against one
  process, training and evaluating (``Train/*`` and ``Val/*``): metrics
  rtol 1e-3 (as the JAX package's ``tests/test_parallel.py:62``).
* Each rank's open_drawer env holds the global envs' cabinets, specs and
  reset draws of its rows (the counterpart of the JAX package's tiled
  per-device spec).
* The helpers: the rank's rows of a minibatch, the draws at the global env
  count, ranks that generate the same assets at once, and a failing rank
  stopping the run."""

import random

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import _torch_parallel as ranks
import _torch_vision as tv
import train_torch
from _torch_port import jax_params_to_numpy
from partmanip_tpu import config as jconfig
from partmanip_tpu.algos import ppo as jppo_mod
from partmanip_tpu.algos import storage as jstorage
from partmanip_tpu_torch import config as tconfig
from partmanip_tpu_torch.envs.open_drawer import OpenDrawerEnv
from partmanip_tpu_torch.parallel import mesh as mesh_lib
from partmanip_tpu_torch.sim import fused
from partmanip_tpu_torch.utils import convert

T, E, O, A = 4, 8, 7, 4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with tv.one_torch_thread():
        yield


def _fixed_rollout(seed=5):
    rs = np.random.RandomState(seed)
    f = lambda *s: rs.normal(size=s).astype(np.float32)
    r = {"observations": f(T, E, O), "actions": np.tanh(f(T, E, A)) * 0.9,
         "rewards": f(T, E) * 0.5, "dones": rs.rand(T, E) < 0.2,
         "succs": rs.rand(T, E) < 0.1, "values": f(T, E) * 0.3,
         "log_probs": f(T, E) * 0.1 - 2.0, "mu": f(T, E, A) * 0.05,
         "sigma": np.full((T, E, A), np.log(0.5), np.float32)}
    r["succs"] &= r["dones"]
    # the env's success rate at reset is every rank's ([T, 1]), the reward per env
    infos = {"reward": f(T, E), "succ_rate": rs.rand(T, 1).astype(np.float32)}
    return r, f(E, O), infos


def _jax_iteration(algo, ro, curr_obs, infos, idx):
    """The JAX trainer's iteration on a 2-device mesh: the rollout and the
    infos placed sharded over ``env`` (axis 1), the train state replicated,
    the fixed rollout and indices swapped in."""
    a = ranks.ppo_cfg(E, T, jconfig, **algo)
    a["parallel"] = {"num_devices": 2}
    env = type("Env", (), {"num_obs": {"normal_state": O}, "num_actions": A,
                           "max_episode_length": 5, "reset": staticmethod(lambda s: s)})
    jp = jppo_mod.PPO(env, a, type("L", (), {"save_ckpt_dir": "/nonexistent"}))
    assert jp.mesh is not None and jp.mesh.devices.size == 2
    params = jp.ac.init(jax.random.PRNGKey(3))
    ts = jppo_mod.PPOTrainState(
        params=params, opt_actor=jp.tx_actor.init(jp._actor_subset(params)),
        opt_critic=jp.tx_critic.init(params.critic),
        rms=jppo_mod.rms_lib.RMSState(*map(jnp.asarray, ranks.np_rms(O))),
        update_rms=jnp.asarray(False), curr_obs=jnp.asarray(curr_obs),
        rng=jax.random.PRNGKey(0))
    shard = NamedSharding(jp.mesh, P(None, "env"))
    repl = NamedSharding(jp.mesh, P())
    jro = jstorage.Rollout(**{k: jax.device_put(jnp.asarray(v), shard) for k, v in ro.items()})
    jinf = {"reward": jax.device_put(jnp.asarray(infos["reward"]), shard),
            "succ_rate": jax.device_put(jnp.asarray(infos["succ_rate"]), repl)}
    assert len(jro.observations.sharding.device_set) == 2
    ts = jax.device_put(ts, repl)
    jp._rollout = lambda ts_, es: (ts_, es, es[0], es[1])
    keep = jstorage.minibatch_indices
    jstorage.minibatch_indices = lambda *a, **k: jnp.asarray(idx, jnp.int32)
    try:
        ts2, _, m = jp._jit_train_iter(ts, (jro, jinf), np.float32(1e-3))
    finally:
        jstorage.minibatch_indices = keep
    return params, convert.actor_critic_from_jax(jax_params_to_numpy(ts2.params)), \
        {k: float(v) for k, v in m.items()}


@pytest.mark.parametrize("case", ["defaults", "tricks"])
def test_two_rank_iteration_matches_jax_mesh_and_one_process(case):
    """Two ranks' iteration (losses summed over the ranks' rows of each
    global minibatch, gradients summed before the clip, the minibatch and
    whole-buffer advantage normalisations, the KL gate, the clipped-value
    delta and the metrics all-reduced) against the JAX 2-device mesh
    iteration and the port's one process."""
    algo = {"defaults": {},
            "tricks": dict(mini_adv_norm=True, whole_adv_norm=True,
                           use_clipped_value_loss=True, succ_value=5.0)}[case]
    ro, curr_obs, infos = _fixed_rollout()
    idx = np.random.RandomState(7).permutation(T * E).reshape(4, -1)
    idx = np.concatenate([idx, idx[::-1]])                          # 2 epochs
    params, want, jm = _jax_iteration(algo, ro, curr_obs, infos, idx)
    sd = {k: v.numpy() for k, v in convert.actor_critic_from_jax(
        jax_params_to_numpy(params)).items()}
    args = (sd, ro, curr_obs, infos, ranks.np_rms(O), idx, algo)
    outs = mesh_lib.launch(ranks.train_iteration, 2, "gloo", "cpu", args=args)
    one = ranks.train_iteration(*args)
    (p0, a0, m0), (p1, a1, m1) = outs
    for k in want:
        np.testing.assert_array_equal(p0[k], p1[k], err_msg=f"ranks disagree on {k}")
        np.testing.assert_allclose(p0[k], want[k].numpy(), atol=2e-6, rtol=0,
                                   err_msg=f"{case}: {k} vs the JAX mesh")
        np.testing.assert_allclose(p0[k], one[0][k], atol=2e-6, rtol=0,
                                   err_msg=f"{case}: {k} vs one process")
    assert a0["actor"]["count"] == one[1]["actor"]["count"] == 8
    np.testing.assert_equal(m0, m1)                 # NaN where A = 4 leaves no "r" dofs
    assert set(m0) == set(jm) == set(one[2])
    for k in jm:
        np.testing.assert_allclose(m0[k], jm[k], rtol=1e-4, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(m0[k], one[2][k], rtol=1e-4, atol=1e-6, err_msg=k)


def _cli_args(tmp_path, *extra):
    return ["--taskcfg", "grasp_cube", "--algocfg", "ppo", "--device", "cpu",
            "--algo.num_envs", "8", "--algo.n_steps", "2", "--algo.max_iterations", "1",
            "--algo.n_minibatches", "2", "--sim.inner_substeps", "1",
            "--algo.model.network.hid_dim", "32", "32", "--task.maxEpisodeLength", "4",
            "--algo.eval_frequence", "1", "--algo.eval_round", "1",
            "--algo.save_frequence", "1", "--log.mode", "screen",
            "--log.log_root", str(tmp_path), "--exp_name", "par_seed5", *extra]


def test_cli_two_ranks_match_one_process(tmp_path):
    """``train_torch.main`` with ``--parallel.num_devices 2 --device cpu``
    starts two gloo ranks, trains one iteration, evaluates and saves (rank
    0); its metrics equal one process's within rtol 1e-3, every physics
    step of each rank ran on its shard, and rank 0 wrote the checkpoint."""
    one = train_torch.main(_cli_args(tmp_path / "one"))
    two = train_torch.main(_cli_args(tmp_path / "two", "--parallel.num_devices", "2"))
    assert isinstance(two, train_torch.RankRun) and two.curr_iter == one.curr_iter == 1
    assert two.total_envsteps == one.total_envsteps == 16
    # the first reset, n_steps control steps, the evaluation's reset and
    # steps, the reset after it
    assert two.shard_dispatch_count == 1 + 2 + (1 + 4) + 1
    assert (tmp_path / "two" / "ckpts" / "grasp_cube_ppo" / "par_seed5" / "model_1.ckpt").exists()
    keys = [k for k in one.last_log if k.startswith(("Train/", "Val/"))]
    assert keys and set(keys) <= set(two.last_log)
    for k in keys:
        np.testing.assert_allclose(two.last_log[k], one.last_log[k], rtol=1e-3, atol=1e-4,
                                   err_msg=k)


def test_rank_envs_hold_their_rows(tmp_path):
    """open_drawer on each of 2 ranks (12 envs, 3 cabinets): the rank's
    cabinets, per-env specs, packed kernel records and reset draws are the
    global env's rows [r·6, (r+1)·6)."""
    flags = ["--taskcfg", "open_drawer", "--algo.num_envs", "12", "--task.asset.num_objects",
             "3", "--task.asset.assetRoot", str(tmp_path)]
    cfg, sp = tconfig.process_cfgs(flags)
    random.seed(3)
    whole = OpenDrawerEnv(cfg["task"], sp, device="cpu")
    tables, ids = fused.pack_obj_table(whole.scene)
    for r in range(2):
        mesh = mesh_lib.Mesh(rank=r, size=2, backend="gloo", device=torch.device("cpu"))
        random.seed(3)
        env = OpenDrawerEnv(cfg["task"], sp, device="cpu", mesh=mesh)
        rows = slice(6 * r, 6 * r + 6)
        assert env.num_envs == 6 and list(env.env_ids) == list(range(12))[rows]
        np.testing.assert_array_equal(env.obj_lstid, whole.obj_lstid[rows])
        for part in ("obj_tree", "obj_boxes"):
            for a, b in zip(getattr(env.scene, part), getattr(whole.scene, part)):
                assert torch.equal(a, b[rows] if b.shape[0] == 12 else b), part
        t_r, ids_r = fused.pack_obj_table(env.scene)
        np.testing.assert_array_equal(t_r[0][ids_r], tables[0][ids][rows])
        pos_r, quat_r = env._random_obj_root(env.make_generator(9), 6)
        pos, quat = whole._random_obj_root(whole.make_generator(9), 12)
        assert torch.equal(pos_r, pos[rows]) and torch.equal(quat_r, quat[rows])


def test_local_rows_and_sharded_draws():
    """A rank's rows of a global minibatch are its envs' rows of its own
    rollout, each once; draws at the global env count give each env its
    one-process numbers."""
    from types import SimpleNamespace
    from partmanip_tpu_torch.algos.ppo import PPO
    idx = torch.as_tensor(np.random.RandomState(0).permutation(T * E).reshape(4, -1))
    got = []
    for r in range(2):
        mesh = mesh_lib.Mesh(rank=r, size=2, backend="gloo", device=torch.device("cpu"))
        fake = SimpleNamespace(mesh=mesh, num_envs=E, env=SimpleNamespace(num_envs=E // 2))
        rows = PPO._local_rows(fake, idx)
        flat = torch.arange(T * E).reshape(T, E)[:, 4 * r:4 * r + 4].reshape(-1)
        got.append([flat[x] for x in rows])
        draw = mesh_lib.shard_draw(mesh, 4, lambda n: torch.rand(
            (n, 3), generator=torch.Generator().manual_seed(1)))
        assert torch.equal(draw, torch.rand((8, 3), generator=torch.Generator().manual_seed(1))
                           [4 * r:4 * r + 4])
    for i in range(idx.shape[0]):
        both = torch.cat([got[0][i], got[1][i]])
        assert sorted(both.tolist()) == sorted(idx[i].tolist())


def test_failing_rank_stops_the_run_and_assets_are_made_once(tmp_path):
    """Two ranks generate the same cabinets at once into an empty asset
    root and each reads complete ones, alike on both; then rank 1 raises,
    which stops rank 0 and makes the run raise with rank 1's traceback."""
    with pytest.raises(RuntimeError, match="rank one fails on purpose after 3 cabinets"):
        mesh_lib.launch(ranks.assets_then_fail, 2, "gloo", "cpu", args=(str(tmp_path), 3),
                        timeout_s=120)
