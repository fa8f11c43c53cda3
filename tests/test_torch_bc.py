"""Behavior cloning of the port (``partmanip_tpu_torch/algos/bc.py``)
against the JAX package's (``partmanip_tpu/algos/bc.py``), on small demo
trees and a Conv3DNet student at res 8 (+ 25 proprio dims, grasp_cube's).

Both packages draw the minibatch order from
``np.random.RandomState(seed).permutation``, so they see the same batches;
the initial parameters are injected (a JAX BC checkpoint of numpy-drawn
weights, which both packages resume from).  Tolerances: the first
minibatch's loss and gradients within 1e-5 of their largest magnitude
(f32 sums in another order); the losses of later iterations within 1e-3
relative (Adam's first steps are sign functions of the gradients, so a
gradient the two frameworks round to opposite signs moves a weight by
2·lr: the trajectories part by O(lr) per step); demo trees read bit for
bit."""

import os
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
from partmanip_tpu.algos import bc as jbc
from partmanip_tpu.models.actor_critic import ACParams
from partmanip_tpu.utils import checkpoint as jckpt
from partmanip_tpu_torch import config as tconfig
from partmanip_tpu_torch.algos import bc as tbc
from partmanip_tpu_torch.algos import dagger as tdagger
from partmanip_tpu_torch.utils import convert

RES, PROP, A, O_TEA = 8, 25, 10, 37


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with tv.one_torch_thread():
        yield


class _Logger:
    def __init__(self, root):
        self.save_ckpt_dir = str(root)
        self.logs = []

    def info(self, record, iteration):
        self.logs.append(dict(record))


def _env():
    return SimpleNamespace(num_obs={"mesh_tsdf": RES ** 3 + PROP, "proprio_state": PROP,
                                    "normal_state": O_TEA},
                           num_actions=A, max_episode_length=5, reset=lambda s: s,
                           device=torch.device("cpu"))


def _runners(tmp_path, data, **algo):
    """(JAX BC, port BC) on the same stand-in env and configuration."""
    out = []
    for module, bc, sub in ((jconfig, jbc, "jax"), (tconfig, tbc, "torch")):
        cfg, _ = module.process_cfgs(["--algocfg", "bc"])
        a = dict(cfg["algo"], data_path=str(data), n_minibatches=2, max_iterations=3,
                 save_frequence=1000, model=tt.model_cfg(action_std=0.0), **algo)
        out.append(bc.BC(_env(), a, _Logger(tmp_path / sub)))
    return out


def _jax_start(tmp_path, runner):
    """A JAX BC checkpoint at iteration 0 holding the numpy-drawn student
    (and a fresh Adam): the initial parameters both packages resume from."""
    tree = tt.student_tree(RES, A, PROP, log_std=1e-8)
    params = ACParams(**jax.tree.map(jnp.asarray, tree))
    path = os.path.join(tmp_path, "start.ckpt")
    jckpt.save(path, {"iteration": 0, "params": params, "opt": runner.tx.init(params),
                      "obs_mode": "mesh_tsdf", "total_steps": 0,
                      "tricks": {"use_state_norm": False}, "teacher": None,
                      "model_cfg": tt.model_cfg(action_std=0.0)})
    return path, tree, params


def test_load_demo_tree_matches_jax(tmp_path):
    data = tt.write_demo_tree(tmp_path / "demos", RES, A, O_TEA, PROP, scenes=3, steps=4)
    for proprio in (True, False):
        jo, ja = jbc.load_demo_tree(str(data), proprio)
        to, ta = tbc.load_demo_tree(str(data), proprio)
        assert to.shape == (12, RES ** 3 + (PROP if proprio else 0)) and to.dtype == np.float32
        np.testing.assert_array_equal(to, jo)
        np.testing.assert_array_equal(ta, ja)


@pytest.mark.parametrize("schedule", ["fixed", "linear_decay", "step_decay"])
def test_lr_schedules_match_jax(tmp_path, schedule):
    j, t = _runners(tmp_path, tmp_path, lr_schedule=schedule)
    j.max_iter = t.max_iter = 10
    for it in range(11):
        j.curr_iter = t.curr_iter = it
        assert t._lr_now() == j._lr_now() and t._lr_now().dtype == np.float32, it
    with pytest.raises(ValueError, match="lr_schedule"):
        _runners(tmp_path, tmp_path, lr_schedule="cosine")


def test_first_minibatch_loss_and_gradients(tmp_path):
    data = tt.write_demo_tree(tmp_path / "demos", RES, A, O_TEA, PROP)
    j, t = _runners(tmp_path, data)
    _, tree, params = _jax_start(tmp_path, j)
    t.student.load_state_dict(convert.actor_critic_from_jax(tree, "Conv3DNet"))
    obs, act = tbc.load_demo_tree(str(data), True)
    idx = np.random.RandomState(0).permutation(len(obs))[:len(obs) // 2]

    def loss_fn(p):
        return ((jnp.asarray(act[idx]) - j.student.update_act(p, jnp.asarray(obs[idx]))) ** 2).mean()
    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(params)
    tloss = t._update(torch.as_tensor(obs[idx]), torch.as_tensor(act[idx]), 5e-4)
    assert abs(float(tloss) - float(jloss)) <= 1e-5 * float(jloss)
    want = convert.actor_critic_from_jax(jax_params_to_numpy(jgrads), "Conv3DNet")
    for name, p in t.student.named_parameters():
        if name.startswith("critic.") or name == "log_std":
            assert p.grad is None and not want[name].any(), name
            continue
        w = want[name].double()
        err = float((p.grad.double() - w).abs().max())
        assert err <= 1e-5 * float(w.abs().max()), (name, err)
    assert t.opt.count == 1


def test_run_from_injected_parameters_matches_jax(tmp_path):
    """Three iterations of two minibatches from the same start (both resume
    the JAX start checkpoint): the same batches, the same losses."""
    data = tt.write_demo_tree(tmp_path / "demos", RES, A, O_TEA, PROP)
    j, t = _runners(tmp_path, data)
    path, _, _ = _jax_start(tmp_path, j)
    j.run(seed=4, resume=path)
    t.run(seed=4, resume=path)
    jl = [log["Train/bc_loss"] for log in j.logger.logs]
    tl = [log["Train/bc_loss"] for log in t.logger.logs]
    assert len(jl) == len(tl) == 3 and t.opt.count == 6
    np.testing.assert_allclose(tl, jl, rtol=1e-3)
    assert tl[-1] < tl[0]
    assert [log["Train/learning_rate"] for log in t.logger.logs] == \
        [log["Train/learning_rate"] for log in j.logger.logs]


def test_bc_learns_constant_action(tmp_path):
    """The port of ``tests/test_distill.py::TestBC::test_bc_learns_constant_action``
    on the port's grasp_cube env (mesh_tsdf at res 8, + proprio)."""
    from partmanip_tpu_torch.envs.grasp_cube import GraspCubeEnv
    cfg, sp = tconfig.process_cfgs([
        "--algocfg", "dagger", "--algo.num_envs", "2", "--sim.inner_substeps", "1",
        "--task.maxEpisodeLength", "4", "--task.obs_mode.tsdf.resolution", "8",
        "--algo.model.network.name", "MLP"])
    cfg["task"]["im_scale"] = 8
    env = GraspCubeEnv(cfg["task"], sp, device="cpu")
    rng = np.random.RandomState(0)
    td_ = tmp_path / "demos"
    for s in range(2):
        d = td_ / f"scene_{s:05d}"
        os.makedirs(d)
        for t in range(10):
            np.save(d / f"step_{t:05d}.npy", {
                "tsdf": rng.randn(8, 8, 8).astype(np.float32),
                "proprio_state": rng.randn(25).astype(np.float32),
                "action": np.full(env.num_actions, 0.3, np.float32),
                "tea_obs": np.zeros(37, np.float32)})
    acfg = dict(cfg["algo"])
    acfg.update({"algo": "bc", "data_path": str(td_), "max_iterations": 30,
                 "n_minibatches": 2, "lr": 1e-2, "lr_schedule": "fixed",
                 "save_frequence": 1000, "eval_round": 1, "eval_frequence": 1000,
                 "model": {"action_std": 0.0, "action_activate": "tanh", "clipAction": 1.0,
                           "network": {"name": "MLP", "hid_dim": [32],
                                       "activation": "tanh"}}})
    bc = tbc.BC(env, acfg, _Logger(tmp_path))
    student = bc.run(seed=0)
    obs, act = tbc.load_demo_tree(str(td_), add_proprio=True)
    with torch.no_grad():
        pred = student.update_act(torch.as_tensor(obs)).numpy()
    assert abs(pred.mean() - 0.3) < 0.1
    assert np.abs(pred - 0.3).max() < 0.25


def test_bc_checkpoints_are_what_dagger_load_pretrain_reads(tmp_path):
    """``DAgger.load_pretrain`` takes the actor and critic of a BC checkpoint
    of the port and of one of the JAX package (written by its ``BC.save``),
    and keeps its own fresh ``log_std`` (BC trains with action_std 0.0,
    log_std = log 1e-8); the port's BC resumes the JAX one with its Adam
    state."""
    data = tt.write_demo_tree(tmp_path / "demos", RES, A, O_TEA, PROP)
    j, t = _runners(tmp_path, data)
    _, tree, params = _jax_start(tmp_path, j)
    opt = j.tx.init(params)
    opt = opt._replace(inner_state=(opt.inner_state[0]._replace(
        count=jnp.asarray(4, jnp.int32)),) + tuple(opt.inner_state[1:]))
    j.save(7, params, opt)
    jpath = os.path.join(j.save_ckpt_dir, "model_7.ckpt")
    t.student.load_state_dict(convert.actor_critic_from_jax(tree, "Conv3DNet"))
    tpath = t.save(5)

    teacher = td.write_teacher(os.path.join(tmp_path, "teacher.ckpt"), O_TEA, A)
    cfg, _ = tconfig.process_cfgs(["--algocfg", "dagger"])
    dag = tdagger.DAgger(_env(), dict(cfg["algo"], obs_mode="mesh_tsdf", num_envs=2,
                                      buf_size=2, teacher=teacher, test_only=False),
                         _Logger(tmp_path / "dagger"))
    want = convert.actor_critic_from_jax(tree, "Conv3DNet")
    for path in (tpath, jpath):
        dag.student.init(1)
        fresh = dag.student.log_std.detach().clone()
        assert float(fresh[0]) == pytest.approx(np.log(0.1))
        dag.load_pretrain(None, path)
        for k, v in dag.student.state_dict().items():
            assert torch.equal(v, fresh if k == "log_std" else want[k]), (path, k)
    _, t2 = _runners(tmp_path, data)
    t2.resume(jpath)
    assert t2.curr_iter == 7 and t2.opt.count == 4
    assert float(t2.student.log_std.detach()[0]) == pytest.approx(np.log(1e-8))
    t2.obs_mode = "depth_tsdf"
    with pytest.raises(ValueError, match="mesh_tsdf student"):
        t2.resume(jpath)
