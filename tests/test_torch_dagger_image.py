"""A DAgger iteration of an image student in the port
(``partmanip_tpu_torch/algos/dagger.py`` with a ``depthResNet`` /
``ResNet`` student) against the JAX package's, in f32 on the CPU.

No PRNG stream has to agree: both sides get the same weights (flax's init
with seeded batch statistics, ``tests/_torch_image.py``), the same buffer
rows and minibatch indices, and the same exploration noise.

* The collection: 2 envs, 2 steps of grasp_cube ``depth_img`` (72×128,
  + the 25 proprio columns) with the exact unculled march on both sides,
  held against the JAX collect in ``tests/golden_torch/
  dagger_collect_depth_img.npz`` (``make_image_dagger_golden.py`` remakes
  it).  The student rows go through bf16 as the JAX package casts them:
  99.9 % of their values equal, every value within one bf16 step (2⁻⁸
  relative) plus 1e-3 m (a ray whose distance lies within rounding of the
  march's ``eps`` stops one step earlier in one package); the teacher rows
  and infos within 1e-5 before the first step and 1e-3 after (two control
  steps of f32 re-association, as the state student's collect test).
* One chunk's loss and gradients, every parameter's (the batch statistics
  included: the JAX package's gradient is taken over the whole variables
  dict): within 1e-5 of their tensor's largest magnitude.
* One update (1 epoch × 1 minibatch of 2 rows in 2 chunks of 1) from a
  bf16 buffer: the loss within 1e-5 relative, the Adam count equal, the
  moments within 1e-5 (μ) / 2e-5 (ν) of their tensor's largest entry, the
  parameters within 2·lr (Adam's first step is a sign function: lr ·
  sign(gradient)), 99.9 % of them within 1e-3·lr.  The
  two full-resolution layers' moments (the stem's conv and BatchNorm at
  36×64, block 0's first at 18×32) within 5e-3 (μ) / 1e-2 (ν): at one row
  a chunk their gradients are sums of 576–2,304 position terms of either
  sign over positive depths, ill-conditioned, and here the two packages'
  moments differ by up to 3.2e-3 (μ of block 0's BatchNorm bias); the
  chunk test holds these layers at 1e-5 with two rows a chunk.  One step,
  because a second one starts from parameters up to 2·lr apart, whose
  gradients through 36 layers differ by more than the moments'
  tolerance."""

import os
from types import SimpleNamespace

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import _torch_dagger as td
import _torch_image as ti
import _torch_vision as tv
from _torch_port import jax_params_to_numpy
from partmanip_tpu import config as jconfig
from partmanip_tpu.algos import dagger as jdagger
from partmanip_tpu.algos import storage as jstorage
from partmanip_tpu.models.actor_critic import ACParams
from partmanip_tpu_torch import config as tconfig
from partmanip_tpu_torch.algos import dagger as tdagger
from partmanip_tpu_torch.algos import storage as tstorage
from partmanip_tpu_torch.envs.grasp_cube import GraspCubeEnv
from partmanip_tpu_torch.utils import convert

LR = np.float32(1e-3)
O_TEA, A, E = 9, 4, 2
IMG = {"depthResNet": 72 * 128, "ResNet": 3 * 72 * 128}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with tv.one_torch_thread():
        yield


def _logger(root):
    return SimpleNamespace(save_ckpt_dir=str(root), info=lambda *a: None)


def _per_tensor_close(got: dict, want: dict, rel, what, rel_of=None):
    """Every tensor within ``rel`` (or ``rel_of(name)``) of its largest
    entry."""
    assert sorted(got) == sorted(want), what
    for k in want:
        w = want[k].double()
        err = float((got[k].double() - w).abs().max())
        r = rel_of(k) if rel_of and rel_of(k) else rel
        assert err <= r * float(w.abs().max()) + 1e-30, f"{what} {k}: {err}"


def test_collect_matches_the_jax_collect(tmp_path):
    g = np.load(ti.GOLDEN)
    cfg, sp = tconfig.process_cfgs(list(ti.FLAGS))
    cfg["task"]["cam"]["coarse_to_fine"] = False
    env = GraspCubeEnv(cfg["task"], sp, device="cpu")
    env.vision_rig.cull = False
    O, A_ = env.num_obs["depth_img"], env.num_actions
    O_T = env.num_obs["normal_state"]
    assert O == 72 * 128 + ti.PROPRIO
    teacher = td.write_teacher(os.path.join(tmp_path, "teacher.ckpt"), O_T, A_)
    dag = tdagger.DAgger(env, dict(cfg["algo"], teacher=teacher, model=ti.model_cfg(),
                                   test_only=False), _logger(tmp_path))
    dag.student.load_state_dict(convert.actor_critic_from_jax(
        ti.student_tree("depthResNet", O, A_, ti.PROPRIO), "depthResNet"))
    draws = td.cube_draws()
    with torch.no_grad():
        state, obs = env.reset(env.init_state(env.make_generator(0), draws), draws)
    np.testing.assert_allclose(obs["normal_state"].numpy(), g["tea0"], atol=1e-5, rtol=0)
    stu_in, tea_in = ti.start_buffer(O, O_T)
    np.testing.assert_array_equal(stu_in, g["stu_in"])
    ts = tdagger.DaggerTrainState(
        buffer=tdagger.DaggerBuffer(
            stu_obs=torch.as_tensor(stu_in).to(torch.bfloat16), tea_obs=torch.as_tensor(tea_in),
            write_idx=torch.tensor(ti.START_WRITE, dtype=torch.int32),
            size=torch.tensor(ti.START_SIZE, dtype=torch.int32)),
        stu_obs=obs["depth_img"], tea_obs=obs["normal_state"], rng=env.make_generator(5),
        pending_force=torch.zeros(ti.E, dtype=torch.bool),
        opt=tdagger.Adam(list(dag.student.named_parameters())))
    ts, state, infos = dag._collect(ts, state, noise=torch.as_tensor(g["noise"]))

    buf = ts.buffer
    assert buf.stu_obs.dtype == torch.bfloat16
    cap = ti.BUF_SIZE * ti.E
    rows = (ti.START_WRITE + np.arange(ti.N_STEPS * ti.E)) % cap      # 4 5 | 0 1
    got, want = buf.stu_obs.float().numpy(), g["stu_out"]
    assert (got[rows] == want[rows]).mean() >= 0.999
    assert (np.abs(got[rows] - want[rows]) <= 2.0 ** -8 * np.abs(want[rows]) + 1e-3).all()
    assert (got[rows, :9216] == 100.0).any() and (got[rows, :9216] < 2.0).mean() > 0.5
    got, want = buf.tea_obs.numpy(), g["tea_out"]
    np.testing.assert_allclose(got[rows[:ti.E]], want[rows[:ti.E]], atol=1e-5, rtol=0)
    np.testing.assert_allclose(got[rows[ti.E:]], want[rows[ti.E:]], atol=1e-3, rtol=0)
    untouched = np.setdiff1d(np.arange(cap), rows)
    np.testing.assert_array_equal(buf.stu_obs.float().numpy()[untouched], g["stu_out"][untouched])
    np.testing.assert_array_equal(got[untouched], g["tea_out"][untouched])
    assert (int(buf.write_idx), int(buf.size)) == (int(g["write_idx"]), int(g["size"])) == (2, 6)
    np.testing.assert_array_equal(state.progress.numpy(), g["progress"])
    last = ts.stu_obs.numpy()
    assert (np.abs(last - g["obs_last"]) <= 1e-3).mean() >= 0.999
    want = {k[len("info/"):]: g[k] for k in g.files if k.startswith("info/")}
    assert sorted(infos) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(infos[k].numpy().reshape(v.shape), v, atol=1e-3, rtol=0,
                                   err_msg=k)


def _pair(tmp_path, network, **algo):
    """(JAX runner, port runner, JAX student params) on a stand-in env
    (image rows without proprio), the same state-norm teacher and the same
    student weights."""
    rs = np.random.RandomState(2)
    rms = {"n": np.int32(5), "mean": rs.randn(1, O_TEA).astype(np.float32),
           "S": (5.0 * (0.5 + rs.rand(1, O_TEA))).astype(np.float32)}
    teacher = td.write_teacher(os.path.join(tmp_path, "teacher.ckpt"), O_TEA, A, rms=rms)
    mode = "depth_img" if network == "depthResNet" else "rgb_img"
    env = SimpleNamespace(num_obs={"normal_state": O_TEA, mode: IMG[network], "proprio_state": 0},
                          num_actions=A, max_episode_length=5, reset=lambda s: s,
                          device=torch.device("cpu"))
    runners = []
    for module, dagger in ((jconfig, jdagger), (tconfig, tdagger)):
        cfg, _ = module.process_cfgs(["--algocfg", "dagger"])
        a = dict(cfg["algo"], num_envs=E, n_steps=1, n_updates=1, n_minibatches=1,
                 minibatch_size=2, minibatch_cap=1, buf_size=20, obs_mode=mode,
                 add_proprio_obs=False, model=ti.model_cfg(network), teacher=teacher,
                 reward_reset=False, test_only=False, **algo)
        runners.append(dagger.DAgger(env, a, _logger(tmp_path)))
    jdag, tdag = runners
    tree = ti.student_tree(network, IMG[network], A, 0)
    tdag.student.load_state_dict(convert.actor_critic_from_jax(tree, network))
    return jdag, tdag, ACParams(**jax.tree.map(jnp.asarray, tree))


@pytest.mark.parametrize("network", ["depthResNet", "ResNet"])
def test_chunk_loss_and_gradients(tmp_path, network):
    jdag, tdag, params = _pair(tmp_path, network)
    rs = np.random.RandomState(11)
    stu = rs.uniform(0, 2, (2, tdag.stu_num_obs)).astype(np.float32)
    tea = rs.randn(2, O_TEA).astype(np.float32)
    tea_o, _ = jdag._rms_lib.normalize(jdag.tea_rms, jnp.asarray(tea), False)
    jact = jdag.teacher.act(jdag.teacher_params, tea_o)
    jloss, jgrads = jax.jit(jax.value_and_grad(jdag._loss))(params, jnp.asarray(stu), jact)
    tact = tdag._label(torch.as_tensor(tea))
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
    assert float(got["actor.backbone.blocks.7.bn1.var"].abs().max()) > 0
    _per_tensor_close(got, {k: want[k] for k in got}, 1e-5, "gradient")


def test_update_matches_the_jax_update(tmp_path, monkeypatch):
    network = "depthResNet"
    jdag, tdag, params = _pair(tmp_path, network)
    cap, size = 20 * E, 24
    rs = np.random.RandomState(13)
    stu = torch.as_tensor(rs.uniform(0, 2, (cap, IMG[network])).astype(np.float32))
    stu = stu.to(torch.bfloat16).float().numpy()        # values the bf16 buffer holds exactly
    tea = rs.randn(cap, O_TEA).astype(np.float32)
    assert tdag.minibatch_sizes(cap) == (2, 1, 2)
    idx = rs.randint(0, size, (1, 2)).astype(np.int32)
    infos = {"reward": rs.randn(1, E).astype(np.float32),
             "dagger_reward_reset": np.zeros((1, E), np.float32)}
    jts = jdagger.DaggerTrainState(
        student=params, opt=jdag.tx.init(params),
        buffer=jdagger.DaggerBuffer(stu_obs=jnp.asarray(stu).astype(jnp.bfloat16),
                                    tea_obs=jnp.asarray(tea), write_idx=jnp.int32(size),
                                    size=jnp.int32(size)),
        stu_obs=jnp.zeros((E, IMG[network])), tea_obs=jnp.zeros((E, O_TEA)),
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
        stu_obs=torch.zeros(E, IMG[network]), tea_obs=torch.zeros(E, O_TEA),
        rng=torch.Generator().manual_seed(0), pending_force=torch.zeros(E, dtype=torch.bool),
        opt=tdagger.Adam(list(tdag.student.named_parameters())))
    tinfos = {k: torch.as_tensor(v) for k, v in infos.items()}
    monkeypatch.setattr(tdag, "_collect", lambda ts, es: (ts, es, tinfos))
    monkeypatch.setattr(tstorage, "buffer_minibatch_indices",
                        lambda *a, **k: torch.as_tensor(idx).long())
    tts2, _, tm = tdag._dagger_iteration(tts, None, float(LR))

    loss_j, loss_t = float(jm["Train/dagger_loss"]), float(tm["Train/dagger_loss"])
    assert abs(loss_t - loss_j) <= 1e-5 * loss_j
    adam = jts2.opt.inner_state[0]
    assert int(adam.count) == tts2.opt.count == 1
    state = tts2.opt.state_dict()
    full_res = ("actor.backbone.conv0.", "actor.backbone.bn0.", "actor.backbone.blocks.0.conv0.",
                "actor.backbone.blocks.0.bn0.")
    for part, tree, rel, wide in (("mu", adam.mu, 1e-5, 5e-3), ("nu", adam.nu, 2e-5, 1e-2)):
        want = convert.actor_critic_from_jax(jax_params_to_numpy(tree), network)
        _per_tensor_close(state[part], want, rel, part,
                          lambda k: wide if k.startswith(full_res) else None)
    want = convert.actor_critic_from_jax(jax_params_to_numpy(jts2.student), network)
    got = tdag.student.state_dict()
    moved = max(float((got[k] - before[k]).abs().max()) for k in got)
    assert moved >= 0.99 * LR                   # Adam's first step: lr · sign(gradient)
    close = total = 0
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0, atol=2 * LR,
                                   err_msg=k)
        close += int(((got[k] - want[k]).abs() <= 1e-3 * LR).sum())
        total += got[k].numel()
    assert close >= 0.999 * total               # opposite signs only where a gradient is ~0
