"""The vision student and its DAgger runner: the port against the JAX
package.

* ``PointNet`` forward (``max_mean`` off and on, ``sub_mean``, a proprio
  split) with the same weights, carried across by ``utils/convert.py``: to
  1e-5 (f32 re-association of 3 → 512 channel sums);
* the port's own init: orthogonal with the JAX package's gains, zero biases,
  f32 compute whatever ``dtype`` says;
* one evaluation round of the numpy-drawn PointNet student on open_drawer
  ``depth_pc`` (2 envs, 36×64, exact unculled march, 3 steps, the committed expert as
  the teacher): every metric within 1e-4 of the JAX round
  (``tests/golden_torch/vision_depth_pc.npz``; the scene states agree to
  about 1e-6 and the two point clouds point for point, see
  ``test_torch_vision_env.py``);
* the teacher read from the committed JAX checkpoint, a student resumed
  from a JAX DAgger checkpoint, and the parts not ported yet refusing with
  the ROADMAP item that will bring them."""

import os
import random

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import _torch_vision as tv
from partmanip_tpu.models.actor_critic import ACParams
from partmanip_tpu.models.networks import PointNet as JPointNet
from partmanip_tpu.utils import checkpoint as jckpt
from partmanip_tpu_torch import config as tconfig
from partmanip_tpu_torch.algos.dagger import DAgger
from partmanip_tpu_torch.envs.open_drawer import OpenDrawerEnv
from partmanip_tpu_torch.models.actor_critic import ActorCritic
from partmanip_tpu_torch.models.networks import PointNet
from partmanip_tpu_torch.utils import checkpoint as tckpt
from partmanip_tpu_torch.utils import convert

import train_torch


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with tv.one_torch_thread():
        yield


class _Logger:
    def __init__(self, root):
        self.save_ckpt_dir = str(root)

    def info(self, record, iteration):
        self.last = record


@pytest.mark.parametrize("max_mean,sub_mean,proprio", [
    (False, False, 0), (True, False, 0), (False, True, 7), (True, True, 7)])
def test_pointnet_forward_matches_flax(max_mean, sub_mean, proprio):
    net_cfg = {"name": "PointNet", "activation": "tanh", "max_mean": max_mean,
               "sub_mean": sub_mean}
    tree = tv.pointnet_tree(3, 3, 12, proprio=proprio, max_mean=max_mean)
    x = np.random.RandomState(4).randn(3, 1024 * 3 + proprio).astype(np.float32)
    want = np.asarray(JPointNet(12, net_cfg, proprio_shape=proprio).apply(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(x)))
    net = PointNet(1024 * 3 + proprio, 12, net_cfg, proprio_shape=proprio)
    sd = convert.actor_critic_from_jax(
        {"actor": tree, "critic": tree, "log_std": np.zeros(12)}, "PointNet")
    net.load_state_dict({k[len("actor."):]: v for k, v in sd.items()
                         if k.startswith("actor.")})
    got = net(torch.as_tensor(x)).detach().numpy()
    assert got.shape == want.shape == (3, 12)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_pointnet_init_gains_and_f32_compute():
    model_cfg = {"action_std": 0.1, "action_activate": "tanh", "clipAction": 1.0,
                 "network": {"name": "PointNet", "activation": "tanh", "dtype": "bf16"}}
    ac = ActorCritic(3072, 10, model_cfg)
    ac.init(5)
    for net, head_gain in ((ac.actor, 0.01), (ac.critic, 1.0)):
        layers = [*net.point, *net.hidden, net.head]
        gains = [np.sqrt(2.0)] * 5 + [head_gain]
        for layer, gain in zip(layers, gains):
            w = layer.weight.detach().double()
            small = w @ w.T if w.shape[0] <= w.shape[1] else w.T @ w
            np.testing.assert_allclose(small.numpy(), gain ** 2 * np.eye(small.shape[0]),
                                       atol=1e-5)
            assert not layer.bias.detach().abs().any()
    y = ac.actor(torch.randn(2, 3072))
    assert y.dtype == torch.float32 and y.shape == (2, 10)


@pytest.fixture(scope="module")
def drawer_dagger(tmp_path_factory):
    root = tmp_path_factory.mktemp("dagger")
    cfg, sp = tconfig.process_cfgs(tv.flags(root / "assets"))
    tv.small_cfg(cfg)
    random.seed(tv.OBJ_SEED)
    env = OpenDrawerEnv(cfg["task"], sp, device="cpu")
    env.vision_rig.cull = False          # the JAX env's CPU (XLA) renderer does not cull
    place = env._random_obj_root
    env._random_obj_root = lambda rng, n, draws=None: place(rng, n, tv.draws())
    acfg = dict(cfg["algo"], teacher=tv.TEACHER, test_only=True)
    return DAgger(env, acfg, _Logger(root)), root


def test_eval_round_matches_the_jax_round(drawer_dagger):
    dag, _ = drawer_dagger
    golden = np.load(tv.GOLDEN)
    ts, es = dag.init_state(seed=0)
    dag.student.load_state_dict(convert.actor_critic_from_jax(
        tv.student_tree(dag.num_actions), "PointNet"))
    es, metrics = dag._eval_round(ts, es)
    want = {k.split("/", 1)[1]: float(golden[k]) for k in golden.files
            if k.startswith("metric/")}
    assert sorted(metrics) == sorted(want)
    got = {k: float(v) for k, v in metrics.items()}
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-4, (k, got[k], want[k])
    assert dag.last_obs.shape == (tv.E, 3072)
    assert got["step_id_max"] == tv.EVAL_T


def test_teacher_and_student_checkpoints(drawer_dagger):
    dag, root = drawer_dagger
    j = tckpt.load_jax(tv.TEACHER)
    for k, v in convert.actor_critic_from_jax(j["params"]._asdict()).items():
        assert torch.equal(dag.teacher.state_dict()[k], v), k
    assert (dag.tea_obs_mode, dag.tea_num_obs, dag.tea_rms) == ("normal_state", 53, None)
    # a student checkpoint as the JAX package's DAgger.save writes it
    tree = tv.student_tree(dag.num_actions, seed=8)
    path = os.path.join(str(root), "model_7.ckpt")
    jckpt.save(path, {"iteration": 7, "total_steps": 7 * 16, "obs_mode": "depth_pc",
                      "params": ACParams(actor=tree["actor"], critic=tree["critic"],
                                         log_std=tree["log_std"] + 0.5),
                      "tricks": {"use_state_norm": False}})
    ts, _ = dag.init_state(seed=1)
    fresh_log_std = dag.student.log_std.detach().clone()
    dag.load_pretrain(ts, path)
    want = convert.actor_critic_from_jax(tree, "PointNet")
    assert torch.equal(dag.student.actor.point[0].weight, want["actor.point.0.weight"])
    assert torch.equal(dag.student.log_std, fresh_log_std)
    dag.resume(ts, path)
    assert (dag.curr_iter, dag.total_envsteps) == (7, 112)
    assert torch.equal(dag.student.log_std.detach(),
                       torch.as_tensor(tree["log_std"] + 0.5))


# every vision mode is ported; what DAgger still refuses is a configuration
# the JAX package cannot run either (the ids are the refusals' former names)
@pytest.mark.parametrize("extra,error,match", [
    (["--algocfg", "dagger", "--taskcfg", "open_drawer", "--algo.obs_mode", "depth_img"],
     ValueError, "no key obs_mode.depth_img"),
    (["--algocfg", "dagger", "--taskcfg", "open_drawer", "--algo.obs_mode", "rgb_img"],
     ValueError, "no key obs_mode.rgb_img"),
    (["--algocfg", "dagger", "--taskcfg", "open_drawer", "--algo.obs_mode", "depth_pc",
      "--algo.model.network.name", "ResNet"], ValueError, "3 × 72 × 128"),
], ids=["extra0-remaining vision modes", "extra1-remaining vision modes",
        "extra2-remaining vision modes"])
def test_unported_parts_raise(tmp_path, extra, error, match):
    args = ["--device", "cpu", "--test_only", "--algo.num_envs", "2", "--log.mode", "screen",
            "--log.log_root", str(tmp_path), "--exp_name", "refuse_seed2",
            "--algo.teacher", tv.TEACHER, "--task.asset.assetRoot", str(tmp_path), *extra]
    with pytest.raises(error, match=match):
        train_torch.main(args)
