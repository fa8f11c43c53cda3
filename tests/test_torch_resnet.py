"""The port's image students (``partmanip_tpu_torch/models/networks.py``
``ResNet``, ``depthResNet``, ``FrozenBatchNorm``, ``load_resnet34_pretrained``)
and their weight conversion (``utils/convert.py``) against the JAX
package's flax modules, on the CPU in f32, at 24×32 images (one forward at
the observation's 72×128).

The JAX package applies its ResNets with ``train`` left False everywhere,
so its BatchNorm is the fixed affine of the stored statistics, and its
optimizer steps those statistics like any parameter (the gradient is taken
over the whole variables dict).  The tests give both sides the same
non-trivial statistics (means ≈ N(0, 0.1²), variances in [0.5, 1.5]).

Tolerances: forward, input gradient and every parameter's gradient
(``batch_stats`` included) within 1e-5 of their tensor's largest magnitude
(f32 sums of up to 4,608 terms in another order through 36 layers);
converted weights, grafted pretrained weights and Adam moments bit for bit
(the depth stem's channel sum within 1e-6)."""

import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from partmanip_tpu.models import networks as jn
from partmanip_tpu.models.actor_critic import ActorCritic as JAC
from partmanip_tpu_torch.models import networks as tn
from partmanip_tpu_torch.models.actor_critic import ActorCritic as TAC
from partmanip_tpu_torch.utils import convert

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "tools"))
from resnet_convert import _STAGES, _flatten, convert_state_dict  # noqa: E402

H, W, A, REL = 24, 32, 4, 1e-5
CFG = {"activation": "tanh"}


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max()
    assert err <= REL * np.abs(want).max(), f"{what}: {err} vs max {np.abs(want).max()}"


def _stats(variables, seed):
    """The flax variables with seeded non-trivial batch statistics."""
    rs = np.random.RandomState(seed)

    def leaf(path, x):
        name = path[-1].key
        x = np.array(x)
        if name == "mean":
            return (0.1 * rs.randn(*x.shape)).astype(np.float32)
        if name == "var":
            return (0.5 + rs.rand(*x.shape)).astype(np.float32)
        return x
    return jax.tree_util.tree_map_with_path(leaf, variables)


def _pair(name, proprio, h=H, w=W, seed=0):
    """(flax net, its variables as numpy, the port's net with the same
    weights)."""
    C = 1 if name == "depthResNet" else 3
    jnet = jn.NETWORKS[name](output_dim=A, net_cfg=CFG, proprio_shape=proprio, h=h, w=w)
    v = _stats(jax.jit(jnet.init)(jax.random.PRNGKey(seed), jnp.zeros((1, C * h * w + proprio))),
               seed)
    tnet = tn.NETWORKS[name](C * h * w + proprio, A, CFG, proprio, h=h, w=w)
    sd = convert.actor_critic_from_jax({"actor": v, "critic": v, "log_std": np.zeros(A)}, name)
    tnet.load_state_dict({k[len("actor."):]: t for k, t in sd.items() if k.startswith("actor.")})
    return jnet, v, tnet, C


@pytest.mark.parametrize("name,proprio", [("ResNet", 25), ("depthResNet", 0)])
def test_forward_and_every_gradient_match_flax(name, proprio):
    jnet, v, tnet, C = _pair(name, proprio)
    rs = np.random.RandomState(7)
    x = rs.uniform(-1, 1, (3, C * H * W + proprio)).astype(np.float32)
    wt = rs.randn(3, A).astype(np.float32)

    def loss(variables, xx):
        y = jnet.apply(variables, xx)
        return (y * wt).sum(), y
    (_, jy), (jg, jgx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        jax.tree.map(jnp.asarray, v), jnp.asarray(x))
    tx = torch.as_tensor(x).requires_grad_(True)
    ty = tnet(tx)
    (ty * torch.as_tensor(wt)).sum().backward()
    _close(ty.detach().numpy(), jy, "forward")
    _close(tx.grad.numpy(), jgx, "input gradient")
    g = jax.tree.map(np.asarray, jg)
    want = convert.actor_critic_from_jax({"actor": g, "critic": g, "log_std": np.zeros(A)}, name)
    stats = 0
    for n, p in tnet.named_parameters():
        _close(p.grad.numpy(), want[f"actor.{n}"].numpy(), f"gradient {n}")
        stats += n.endswith((".mean", ".var")) and bool(p.grad.abs().max() > 0)
    assert stats == 2 * 36                 # every BatchNorm's statistics get a gradient


def test_batchnorm_is_a_fixed_affine_in_every_mode():
    _, _, tnet, C = _pair("ResNet", 25)
    x = torch.as_tensor(np.random.RandomState(3).uniform(-1, 1, (4, C * H * W + 25))
                        .astype(np.float32))
    before = {k: t.clone() for k, t in tnet.state_dict().items()}
    tnet.train()
    y_train = tnet(x)
    tnet.eval()
    y_eval = tnet(x)
    torch.testing.assert_close(y_train, y_eval, rtol=0, atol=0)
    for k, t in tnet.state_dict().items():
        assert torch.equal(t, before[k]), k
    bn = tnet.backbone.bn0
    z = torch.randn(2, 64, 5, 6)
    view = lambda t: t.view(1, -1, 1, 1)
    want = (z - view(bn.mean)) * view(torch.rsqrt(bn.var + 1e-5) * bn.scale) + view(bn.bias)
    torch.testing.assert_close(bn(z), want, rtol=0, atol=0)
    assert not any(isinstance(m, torch.nn.modules.batchnorm._BatchNorm) for m in tnet.modules())


def test_shapes_and_forward_at_72x128():
    """flax's ``SAME`` 1×1 downsample pads nothing at 18×32 → 9×16 → 5×8 →
    3×4, and the port's padding 0 gives the same sizes."""
    jnet, v, tnet, C = _pair("depthResNet", 25, h=72, w=128)
    sizes = []
    hooks = [m.register_forward_hook(lambda m, i, o: sizes.append(tuple(o.shape[2:])))
             for m in (tnet.backbone.conv0, *tnet.backbone.blocks)]
    x = np.random.RandomState(4).uniform(0, 2, (1, 72 * 128 + 25)).astype(np.float32)
    with torch.no_grad():
        y = tnet(torch.as_tensor(x))
    for hk in hooks:
        hk.remove()
    assert sizes == [(36, 64)] + [(18, 32)] * 3 + [(9, 16)] * 4 + [(5, 8)] * 6 + [(3, 4)] * 3
    _close(y.numpy(), jax.jit(jnet.apply)(jax.tree.map(jnp.asarray, v), jnp.asarray(x)),
           "forward at 72x128")


def test_build_init_and_refusals():
    net = tn.make_network("ResNet", 3 * 72 * 128 + 25, A, CFG, 25)
    assert isinstance(net, tn.ResNet) and net.hidden[0].in_features == 512 + 25
    assert isinstance(tn.make_network("depthResNet", 72 * 128, A, CFG), tn.depthResNet)
    torch.manual_seed(0)
    net.reset_parameters()
    w = net.backbone.blocks[3].conv0.weight.detach()      # 128 × 64 × 3 × 3
    fan_in = 64 * 9
    assert abs(float(w.std()) - fan_in ** -0.5) < 0.05 * fan_in ** -0.5     # LeCun normal
    assert float(w.abs().max()) <= 2 * fan_in ** -0.5 / 0.87962566103423978 + 1e-6
    bn = net.backbone.blocks[3].bn2
    assert (bn.scale == 1).all() and (bn.bias == 0).all() and (bn.mean == 0).all() \
        and (bn.var == 1).all()
    assert sum(b.down for b in net.backbone.blocks) == 3
    with pytest.raises(ValueError, match="3 × 72 × 128"):
        tn.make_network("ResNet", 3072, A, CFG)
    with pytest.raises(ValueError, match="1 × 72 × 128"):
        tn.make_network("depthResNet", 72 * 128, A, CFG, 25)


def _synth_torchvision(seed=0):
    """A torchvision-layout ResNet-34 state dict of random values (the real
    ImageNet file is not in the repository)."""
    rs = np.random.RandomState(seed)
    sd = {}

    def bn(prefix, c):
        sd[prefix + ".weight"] = rs.randn(c).astype(np.float32)
        sd[prefix + ".bias"] = rs.randn(c).astype(np.float32)
        sd[prefix + ".running_mean"] = rs.randn(c).astype(np.float32)
        sd[prefix + ".running_var"] = (rs.rand(c) + 0.5).astype(np.float32)

    sd["conv1.weight"] = (0.05 * rs.randn(64, 3, 7, 7)).astype(np.float32)
    bn("bn1", 64)
    cin = 64
    for stage, (cout, blocks) in enumerate(_STAGES, start=1):
        for i in range(blocks):
            pre, c0 = f"layer{stage}.{i}", cin if i == 0 else cout
            sd[pre + ".conv1.weight"] = (0.05 * rs.randn(cout, c0, 3, 3)).astype(np.float32)
            bn(pre + ".bn1", cout)
            sd[pre + ".conv2.weight"] = (0.05 * rs.randn(cout, cout, 3, 3)).astype(np.float32)
            bn(pre + ".bn2", cout)
            if i == 0 and stage > 1:
                sd[pre + ".downsample.0.weight"] = (0.05 * rs.randn(cout, c0, 1, 1)
                                                    ).astype(np.float32)
                bn(pre + ".downsample.1", cout)
        cin = cout
    return sd


@pytest.mark.parametrize("name", ["ResNet", "depthResNet"])
def test_pretrained_graft_matches_the_jax_loader(tmp_path, name):
    path = str(tmp_path / "rn34.npz")
    np.savez(path, **dict(_flatten(convert_state_dict(_synth_torchvision()))))
    jnet, v, tnet, C = _pair(name, 0)
    head = {k: t.clone() for k, t in tnet.state_dict().items() if not k.startswith("backbone.")}
    tn.load_resnet34_pretrained(tnet, path)
    grafted = jax.tree.map(np.asarray, jn.load_resnet34_pretrained(v, path))
    want = convert.actor_critic_from_jax(
        {"actor": grafted, "critic": grafted, "log_std": np.zeros(A)}, name)
    for k, t in tnet.state_dict().items():
        if k.startswith("backbone.conv0") and name == "depthResNet":
            np.testing.assert_allclose(t.numpy(), want[f"actor.{k}"].numpy(), rtol=0, atol=1e-6)
        else:
            np.testing.assert_array_equal(t.numpy(), want[f"actor.{k}"].numpy(), err_msg=k)
    for k, t in head.items():
        assert torch.equal(tnet.state_dict()[k], t), k
    # the actor-critic grafts actor and critic when the config names the file
    cfg = {"action_std": 0.1, "action_activate": "tanh", "clipAction": 1.0,
           "network": dict(CFG, name=name, pretrained=path)}
    ac = TAC(C * 72 * 128, A, cfg)
    ac.init(3)
    assert torch.equal(ac.critic.backbone.blocks[5].bn1.var, tnet.backbone.blocks[5].bn1.var)
    assert torch.equal(ac.actor.backbone.conv0.weight, tnet.backbone.conv0.weight)


def test_converter_round_trips_weights_and_adam_moments():
    _, v, tnet, _ = _pair("ResNet", 25)
    tree = {"actor": v, "critic": _stats(v, 9), "log_std": np.full(A, -1.0, np.float32)}
    sd = convert.actor_critic_from_jax(tree, "ResNet")
    assert sd["actor.backbone.blocks.3.conv2.weight"].shape == (128, 64, 1, 1)
    np.testing.assert_array_equal(
        sd["actor.backbone.blocks.3.conv2.weight"].numpy(),
        v["params"]["ResNet34Backbone_0"]["_BasicBlock_3"]["Conv_2"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        sd["critic.backbone.blocks.15.bn1.var"].numpy(),
        tree["critic"]["batch_stats"]["ResNet34Backbone_0"]["_BasicBlock_15"]["BatchNorm_1"]["var"])
    back = convert.actor_critic_to_jax(sd, "ResNet")
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    # the student's Adam state (keyed by the port's parameter names) and back
    state = {"count": 7, "mu": sd, "nu": {k: t * t for k, t in sd.items()}}
    j = convert.adam_state_to_jax(state, "ResNet")
    assert j["count"] == 7
    for part in ("mu", "nu"):
        again = convert.actor_critic_from_jax(j[part], "ResNet")
        for k, t in state[part].items():
            assert torch.equal(again[k], t), (part, k)
