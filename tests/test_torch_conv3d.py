"""The port's 3-D conv students (``partmanip_tpu_torch/models/networks.py``
``Conv3DNet``, ``PoolConv3DNet``) and their weight conversion
(``utils/convert.py``) against the JAX package's flax modules, on the same
weights (drawn with numpy in the flax layout) and inputs (seeded uniform
volumes in [-1, 1]), in f32 on the CPU.

Tolerances: the forward output, the input gradient and every weight
gradient within 1e-5 of their tensor's largest magnitude (f32 sums of up to
864 terms in another order); the conv features before the dense layer,
flattened in the JAX package's (D, H, W, C) order, within 1e-5 likewise;
converted weights and Adam moments bit for bit."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import _torch_tsdf as tt
from partmanip_tpu.models import networks as jnetworks
from partmanip_tpu.models.actor_critic import ACParams
from partmanip_tpu.utils import checkpoint as jckpt
from partmanip_tpu_torch.algos import dagger as tdagger
from partmanip_tpu_torch.models import networks as tnetworks
from partmanip_tpu_torch.utils import checkpoint as tckpt
from partmanip_tpu_torch.utils import convert

A = 10
REL = 1e-5


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max()
    assert err <= REL * np.abs(want).max(), f"{what}: {err} vs max {np.abs(want).max()}"


def _pair(network, res, proprio, seed=3):
    cfg = {"name": network, "activation": "tanh"}
    tree = tt.conv3d_tree(seed, res, A, proprio, network)
    jnet = jnetworks.make_network(network, A, cfg, proprio)
    tnet = tnetworks.make_network(network, res ** 3 + proprio, A, cfg, proprio)
    sd = convert._dense_from_flax(tree, "net", network)
    tnet.load_state_dict({k[len("net."):]: v for k, v in sd.items()})
    return jnet, tnet, tree


@pytest.mark.parametrize("network,res,proprio", [
    ("Conv3DNet", 50, 0), ("Conv3DNet", 8, 25), ("PoolConv3DNet", 50, 0),
    ("PoolConv3DNet", 64, 0)],
    ids=["conv3d_res50", "conv3d_res8_proprio", "pool_res50", "pool_res64"])
def test_forward_and_gradients_match_flax(network, res, proprio):
    jnet, tnet, tree = _pair(network, res, proprio)
    rs = np.random.RandomState(7)
    x = rs.uniform(-1, 1, (2, res ** 3 + proprio)).astype(np.float32)
    w = rs.randn(2, A).astype(np.float32)          # a weighted sum of the outputs as the loss

    def loss(params, xx):
        y = jnet.apply({"params": params}, xx)
        return (y * w).sum(), y
    (_, jy), (jgp, jgx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        jax.tree.map(jnp.asarray, tree["params"]), jnp.asarray(x))

    tx = torch.as_tensor(x).requires_grad_(True)
    ty = tnet(tx)
    (ty * torch.as_tensor(w)).sum().backward()
    _close(ty.detach().numpy(), jy, "forward")
    _close(tx.grad.numpy(), jgx, "input gradient")
    want = convert._dense_from_flax(jax.tree.map(np.asarray, {"params": jgp}), "net", network)
    for name, p in tnet.named_parameters():
        _close(p.grad.numpy(), want[f"net.{name}"].numpy(), f"gradient {name}")


def _jax_features(tree, x, res, layers, pool=0):
    """The flax nets' conv stack written out with ``lax.conv_general_dilated``
    (NDHWC, kernels DHWIO, symmetric padding k // 2), flattened as they
    flatten it."""
    v = jnp.asarray(x).reshape(x.shape[0], res, res, res, 1)
    for i, (_, k, s) in enumerate(layers):
        p = tree["params"][f"Conv_{i}"]
        v = jax.lax.conv_general_dilated(
            v, jnp.asarray(p["kernel"]), (s,) * 3, [(k // 2, k // 2)] * 3,
            dimension_numbers=("NDHWC", "DHWIO", "NDHWC")) + p["bias"]
        v = jnp.tanh(v)
    if pool:
        v = jax.lax.reduce_window(v, -jnp.inf, jax.lax.max, (1, pool, pool, pool, 1),
                                  (1, pool, pool, pool, 1), "VALID")
    return np.asarray(v.reshape(x.shape[0], -1))


@pytest.mark.parametrize("network,res", [("Conv3DNet", 50), ("PoolConv3DNet", 64)])
def test_features_flatten_in_the_jax_order(network, res):
    """The conv features reach the dense layer in (D, H, W, C) order: a
    port that flattened its NCDHW features as they lie would put channel
    c of voxel 0 where the JAX net has channel 0 of voxel c."""
    _, tnet, tree = _pair(network, res, 0)
    x = np.random.RandomState(8).uniform(-1, 1, (2, res ** 3)).astype(np.float32)
    layers, pool = ((tt.POOL_CONV3D, tt.POOL) if network == "PoolConv3DNet"
                    else (tt.CONV3D, 0))
    want = _jax_features(tree, x, res, layers, pool)
    side = tt.conv_side(res, layers, pool)
    assert side > 1 and want.shape == (2, layers[-1][0] * side ** 3)
    with torch.no_grad():
        got = tnet.stack(torch.as_tensor(x)).numpy()
    _close(got, want, "features")


def test_layer_sizes_init_and_refusals():
    cfg = {"name": "Conv3DNet", "activation": "tanh"}
    was = torch.backends.cudnn.allow_tf32
    try:        # cuDNN's precision is the caller's: building a net leaves it
        for flag in (True, False):
            torch.backends.cudnn.allow_tf32 = flag
            net = tnetworks.Conv3DNet(50 ** 3 + 25, A, cfg, proprio_shape=25)
            assert torch.backends.cudnn.allow_tf32 is flag
    finally:
        torch.backends.cudnn.allow_tf32 = was
    assert net.stack.out_features == 32 * 3 ** 3 and net.hidden.in_features == 864 + 25
    assert [tuple(c.weight.shape) for c in net.stack.convs] == \
        [(16, 1, 5, 5, 5), (32, 16, 3, 3, 3), (32, 32, 3, 3, 3)]
    torch.manual_seed(0)
    net.reset_parameters()
    w = net.stack.convs[0].weight.detach()
    assert abs(float(w.std()) - 125 ** -0.5) < 0.1 * 125 ** -0.5     # LeCun normal
    assert float(w.abs().max()) <= 2 * 125 ** -0.5 / 0.87962566103423978 + 1e-6
    assert not any(c.bias.any() for c in net.stack.convs)
    pool = tnetworks.PoolConv3DNet(50 ** 3, A, dict(cfg, name="PoolConv3DNet"))
    assert pool.stack.out_features == 64 and pool.hidden.in_features == 64
    with pytest.raises(ValueError, match="cube"):
        tnetworks.PoolConv3DNet(50 ** 3 + 25, A, cfg, proprio_shape=25)
    with pytest.raises(ValueError, match="cube"):
        tnetworks.Conv3DNet(3072, A, cfg)
    with pytest.raises(ValueError, match="nothing"):
        tnetworks.PoolConv3DNet(8 ** 3, A, cfg)
    for name in ("ResNet", "depthResNet"):       # the image students take 72×128 images
        with pytest.raises(ValueError, match="72 × 128"):
            tnetworks.make_network(name, 8, 4, cfg)


@pytest.mark.parametrize("network", ["Conv3DNet", "PoolConv3DNet"])
def test_converter_round_trips_weights_and_adam_moments(network):
    res, proprio = (8, 25) if network == "Conv3DNet" else (32, 0)
    tree = tt.student_tree(res, A, proprio, network=network)
    sd = convert.actor_critic_from_jax(tree, network)
    assert sd["actor.stack.convs.0.weight"].shape == (16, 1, 5, 5, 5)
    np.testing.assert_array_equal(sd["actor.stack.convs.1.weight"].numpy(),
                                  tree["actor"]["params"]["Conv_1"]["kernel"].transpose(4, 3, 0, 1, 2))
    back = convert.actor_critic_to_jax(sd, network)
    jax.tree.map(np.testing.assert_array_equal, back, tree)
    mu = tt.student_tree(res, A, proprio, seed=5, network=network)
    nu = tt.student_tree(res, A, proprio, seed=6, network=network)
    state = {"count": 7, "mu": convert.actor_critic_from_jax(mu, network),
             "nu": convert.actor_critic_from_jax(nu, network)}
    j = convert.adam_state_to_jax(state, network)
    assert j["count"] == 7
    jax.tree.map(np.testing.assert_array_equal, (j["mu"], j["nu"]), (mu, nu))
    opt = tckpt.JaxAdamState(count=np.int32(7), mu=tckpt.JaxACParams(**j["mu"]),
                             nu=tckpt.JaxACParams(**j["nu"]))
    again = convert.adam_state_from_jax((opt, tckpt.JaxEmptyState()), "student", network)
    assert again["count"] == 7
    for part in ("mu", "nu"):
        for k, v in state[part].items():
            assert torch.equal(again[part][k], v), (part, k)


def test_reads_a_jax_dagger_checkpoint_of_a_conv3dnet(tmp_path):
    """A JAX DAgger checkpoint (student ``ACParams``, optax's
    ``inject_hyperparams(adam)`` state) read by ``dagger._read_actor_critic``:
    the student's weights and the Adam moments by parameter name."""
    import optax
    tree = tt.student_tree(8, A, 25)
    params = ACParams(**jax.tree.map(jnp.asarray, tree))
    tx = optax.inject_hyperparams(lambda learning_rate: optax.adam(learning_rate))(
        learning_rate=1e-3)
    opt = tx.init(params)
    grads = jax.tree.map(lambda p: 0.01 * jnp.ones_like(p), params)
    _, opt = tx.update(grads, opt, params)
    path = os.path.join(tmp_path, "model_3.ckpt")
    jckpt.save(path, {"iteration": 3, "params": params, "opt": opt, "total_steps": 48,
                      "obs_mode": "mesh_tsdf", "model_cfg": tt.model_cfg(),
                      "teacher": None, "tricks": {"use_state_norm": False}})
    d = tdagger._read_actor_critic(path, "Conv3DNet")
    want = convert.actor_critic_from_jax(tree, "Conv3DNet")
    assert sorted(d["ac"]) == sorted(want)
    for k in want:
        assert torch.equal(d["ac"][k], want[k]), k
    assert d["opt"]["count"] == 1 and (d["iteration"], d["obs_mode"]) == (3, "mesh_tsdf")
    mu = convert.actor_critic_from_jax(jax.tree.map(np.asarray, opt.inner_state[0].mu._asdict()),
                                       "Conv3DNet")
    for k in want:
        assert torch.equal(d["opt"]["mu"][k], mu[k]), k
