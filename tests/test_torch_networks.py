"""The port's network module on its own (no JAX needed): seeded orthogonal
init with the gain schedule of the JAX package (√2 hidden, 0.01 policy head,
1 value head, zero biases), the bf16 / f32 compute-dtype knob, the
refusal of the architectures that are not ported, and PointNet's fused
512-wide layer + max pool (``ops/point_pool``) against autograd through
``Linear`` + ``amax``."""

import re

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from partmanip_tpu_torch.models import networks as tnetworks
from partmanip_tpu_torch.models.actor_critic import ActorCritic as TActorCritic
from partmanip_tpu_torch.ops import point_pool

NUM_OBS, NUM_ACT, B = 37, 7, 16


def _model_cfg(dtype="f32", activation="tanh"):
    return {"action_std": 0.5, "action_activate": "tanh", "clipAction": 1.0,
            "network": {"name": "MLP", "hid_dim": [32, 32],
                        "activation": activation, "dtype": dtype}}


def test_seeded_init_follows_the_gain_schedule():
    tac = TActorCritic(NUM_OBS, NUM_ACT, _model_cfg())
    tac.init(4)
    first = {k: v.clone() for k, v in tac.state_dict().items()}
    tac.init(4)
    for k, v in tac.state_dict().items():
        assert torch.equal(v, first[k])
    w = first["actor.hidden.1.weight"]               # orthogonal, gain √2
    np.testing.assert_allclose((w @ w.T).numpy(), 2.0 * np.eye(32), atol=1e-4)
    head = first["actor.head.weight"]                # gain 0.01
    np.testing.assert_allclose((head @ head.T).numpy(),
                               1e-4 * np.eye(NUM_ACT), atol=1e-7)
    assert float(first["critic.head.bias"].abs().max()) == 0.0
    np.testing.assert_allclose(first["log_std"].numpy(), np.log(0.5), atol=1e-6)


def test_bf16_is_the_default_compute_dtype():
    cfg = _model_cfg()
    del cfg["network"]["dtype"]
    net = tnetworks.MLP(NUM_OBS, 4, cfg["network"])
    x = torch.as_tensor(np.random.RandomState(1).normal(
        size=(B, NUM_OBS)).astype(np.float32))
    with torch.no_grad():
        y = net(x)
        net.dtype = None
        y32 = net(x)
    assert y.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in net.parameters())
    assert 0 < float((y - y32).abs().max()) < 2e-2
    with pytest.raises(ValueError, match="dtype"):
        tnetworks.MLP(NUM_OBS, 4, dict(cfg["network"], dtype="f16"))


@pytest.mark.parametrize("name", ["depthResNet", "ResNet"])
def test_vision_networks_raise(name):
    """The image students build at their 72×128 input and raise on any
    other input size."""
    channels = 1 if name == "depthResNet" else 3
    net = tnetworks.make_network(name, channels * 72 * 128, 4, _model_cfg()["network"])
    assert isinstance(net, tnetworks.NETWORKS[name])
    with pytest.raises(ValueError, match=f"{channels} × 72 × 128"):
        tnetworks.make_network(name, 8, 4, _model_cfg()["network"])


POINTS = 64


def _pointnet_case(case):
    """(net, input) of a small PointNet: B 4, 64 points of 3 channels."""
    proprio = 5 if case == "proprio_sub_mean" else 0
    cfg = {"name": "PointNet", "activation": "tanh", "max_mean": case == "max_mean",
           "sub_mean": case == "proprio_sub_mean"}
    torch.manual_seed(7)
    net = tnetworks.PointNet(3 * POINTS + proprio, 6, cfg, proprio_shape=proprio,
                             point_num=POINTS)
    rs = np.random.RandomState(8)
    pts = rs.uniform(-1, 1, (4, POINTS, 3)).astype(np.float32)
    if case == "repeated_points":          # FPS repeats points of a sparse cloud
        pts[:, POINTS - 16:] = pts[:, :16]
        pts[2] = pts[2, :1]
    if case == "tie_every_point":          # a zero row of the 512-wide layer
        with torch.no_grad():
            net.point[-1].weight[[5, 300]] = 0.0
    x = np.concatenate([pts.reshape(4, -1), rs.randn(4, proprio).astype(np.float32)], axis=1)
    return net, torch.as_tensor(x)


def _grads(net, x, g):
    net.zero_grad(set_to_none=True)
    y = net(x)
    y.backward(g)
    return y.detach(), {n: p.grad.clone() for n, p in net.named_parameters()}


@pytest.mark.parametrize("case", ["plain", "repeated_points", "tie_every_point",
                                  "proprio_sub_mean", "max_mean"])
def test_pointnet_pool_matches_linear_amax(case, monkeypatch):
    """The pooled output and every parameter's gradient against autograd
    through Linear + amax, two backward passes bit-equal, a no_grad forward
    bit-equal to amax with nothing counted, and the counters: the share of
    tied pools and the argmax points per row.  max_mean keeps its own path."""
    net, x = _pointnet_case(case)
    g = torch.as_tensor(np.random.RandomState(9).randn(4, 6).astype(np.float32))
    counters = net.pool_counters
    y, got = _grads(net, x, g)
    _, again = _grads(net, x, g)
    for n in got:
        assert torch.equal(got[n], again[n]), n
    seen = counters.read()
    with torch.no_grad():
        assert torch.equal(net(x), y)
    assert counters.rows == (0 if case == "max_mean" else 8)

    monkeypatch.setattr(point_pool, "linear_max_pool",
                        lambda h, w, b, counters=None: F.linear(h, w, b).amax(dim=1))
    y_ref, want = _grads(net, x, g)
    assert torch.equal(y, y_ref)
    for n in want:
        torch.testing.assert_close(got[n], want[n], rtol=1e-5, atol=1e-7, msg=n)
    if case == "max_mean":
        assert seen == {}
        return
    tie, crit = float(seen["tie_share"]), float(seen["critical_points"])
    assert 1 <= crit <= POINTS
    if case in ("plain", "proprio_sub_mean"):
        assert tie == 0.0 and crit < POINTS
    elif case == "tie_every_point":
        assert tie == pytest.approx(2 / 512) and crit == POINTS
    else:
        assert 0 < tie < 1


def test_pool_plain_marks_every_maximum():
    """pool_plain's first index, count and bitmask against a loop, with a
    tie at two points, at every point, and past the first 32-point word;
    the kernel's wrapper refuses CPU tensors, and its channel bound is the
    source's sort-key width."""
    h = torch.as_tensor(np.random.RandomState(3).randn(2, 40, 4).astype(np.float32))
    h[0, [3, 35], 1] = 9.0
    h[1, :, 2] = -1.5
    h[1, 33, 3] = 7.0
    pooled, first, count, mask = point_pool.pool_plain(h)
    assert mask.shape == (2, 4, 2) and mask.dtype == torch.int32
    for b in range(2):
        for c in range(4):
            at = [p for p in range(40) if h[b, p, c] == h[b, :, c].max()]
            assert pooled[b, c] == h[b, :, c].max()
            assert (first[b, c], count[b, c]) == (at[0], len(at))
            words = [sum(1 << (p - 32 * j) for p in at if p // 32 == j) for j in range(2)]
            assert [w & 0xFFFFFFFF for w in mask[b, c].tolist()] == words
    assert torch.equal(point_pool._unpack_bits(mask, 40), h == pooled[:, None])
    with pytest.raises(ValueError, match="CUDA"):
        point_pool.pool_cuda(h)
    with open(point_pool.SOURCE) as f:
        bits = int(re.search(r"constexpr int C_BITS = (\d+);", f.read()).group(1))
    assert 1 << bits == point_pool.MAX_CHANNELS
