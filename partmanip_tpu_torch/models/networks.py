"""Policy/value networks (``torch.nn``).

Counterpart of ``partmanip_tpu/models/networks.py`` for the ``MLP``,
``PointNet``, ``Conv3DNet`` and ``PoolConv3DNet`` architectures: activation
from config, orthogonal init of the dense layers with the stable-baselines
gain schedule (√2 hidden, 0.01 policy head, 1 value head), zero biases; the
3-D convolutions take flax's default init (LeCun normal, truncated at two
standard deviations).  The ResNet architectures (ResNet, depthResNet) are
not ported yet.

The 3-D nets hold their volumes as NCDHW where the JAX package's are NDHWC;
``vol.reshape(b, 1, r, r, r)`` keeps its voxel order, and the conv features
are permuted to (D, H, W, C) before they are flattened, so that the dense
layer after them reads its inputs in the JAX package's order and its weight
converts as every other dense layer's does.  The JAX nets compute in full
f32 (their convolutions take no compute dtype).  On the GPU cuDNN computes
f32 convolutions in TF32 unless ``torch.backends.cudnn.allow_tf32`` is
False; the modules leave that process-wide flag to their caller, and the
port's entry points (``train_torch.py``, ``collect_demos_torch.py``) set it
False, so that there forward and backward convolutions round as f32 ones.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn as nn
import torch.nn.functional as F

UNPORTED_NETWORKS = ("ResNet", "depthResNet")


def get_activation(name: str) -> Callable:
    return {
        "elu": F.elu, "selu": F.selu, "relu": F.relu, "crelu": F.relu,
        "lrelu": F.leaky_relu, "tanh": torch.tanh, "sigmoid": torch.sigmoid,
    }[name]


def _init_dense(layer: nn.Linear, gain: float) -> None:
    """Orthogonal weight (drawn on the CPU from the global generator, so a
    seed gives the same weights on every device), zero bias."""
    w = torch.empty(layer.weight.shape)
    nn.init.orthogonal_(w, gain)
    with torch.no_grad():
        layer.weight.copy_(w)
        layer.bias.zero_()


def _compute_dtype(net_cfg: dict, default: str = "bf16"):
    """Compute dtype of the dense stack.  ``bf16`` (default for MLP) runs the
    matmuls under bf16 autocast while parameters stay f32; ``dtype: f32``
    restores exact f32 numerics."""
    v = net_cfg.get("dtype", default)
    table = {"bf16": torch.bfloat16, "f32": None}
    if v not in table:
        raise ValueError(f"network.dtype must be one of {sorted(table)}, "
                         f"got {v!r}")
    return table[v]


class MLP(nn.Module):
    def __init__(self, input_dim: int, output_dim: int, net_cfg: dict,
                 proprio_shape: int = 0):
        super().__init__()
        self.act = get_activation(net_cfg["activation"])
        self.dtype = _compute_dtype(net_cfg)
        dims = [input_dim] + list(net_cfg["hid_dim"])
        self.hidden = nn.ModuleList(
            nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))
        self.head = nn.Linear(dims[-1], output_dim)
        self.reset_parameters()

    def reset_parameters(self):
        for layer in self.hidden:
            _init_dense(layer, math.sqrt(2.0))
        _init_dense(self.head, 1.0 if self.head.out_features == 1 else 0.01)

    def _stack(self, x):
        for layer in self.hidden:
            x = self.act(layer(x))
        return self.head(x)

    def forward(self, x):
        if self.dtype is None:
            return self._stack(x)
        with torch.autocast(device_type=x.device.type, dtype=self.dtype):
            y = self._stack(x)
        # heads read in f32 downstream (log-prob/KL/value math)
        return y.float()


class PointNet(nn.Module):
    """[B, point_num·C (+ proprio)] point clouds → shared per-point MLP
    128-256-512 (no activation after 512) → max (or max ‖ mean) pool →
    (‖ proprio) → 128 → 32 → head.  Computes in f32, as the JAX package's
    PointNet does (its dense layers take no compute dtype): the ``dtype``
    key of the config, the MLP's bf16 switch, does not apply."""

    def __init__(self, input_dim: int, output_dim: int, net_cfg: dict,
                 proprio_shape: int = 0, point_num: int = 1024):
        super().__init__()
        self.act = get_activation(net_cfg["activation"])
        self.max_mean = bool(net_cfg.get("max_mean", False))
        self.sub_mean = bool(net_cfg.get("sub_mean", False))
        self.proprio_shape = int(proprio_shape)
        self.point_num = int(point_num)
        channels, rest = divmod(input_dim - self.proprio_shape, self.point_num)
        if rest or channels < 1:
            raise ValueError(f"PointNet input {input_dim} is not {point_num} "
                             f"points (+ {proprio_shape} proprio)")
        dims = [channels, 128, 256, 512]
        self.point = nn.ModuleList(
            nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))
        pooled = 512 * (2 if self.max_mean else 1) + self.proprio_shape
        self.hidden = nn.ModuleList([nn.Linear(pooled, 128), nn.Linear(128, 32)])
        self.head = nn.Linear(32, output_dim)
        self.reset_parameters()

    def reset_parameters(self):
        for layer in (*self.point, *self.hidden):
            _init_dense(layer, math.sqrt(2.0))
        _init_dense(self.head, 1.0 if self.head.out_features == 1 else 0.01)

    def forward(self, x):
        b = x.shape[0]
        if self.proprio_shape:
            proprio = x[:, -self.proprio_shape:]
            pc = x[:, :-self.proprio_shape].reshape(b, self.point_num, -1)
        else:
            proprio = None
            pc = x.reshape(b, self.point_num, -1)
        if self.sub_mean:
            xyz = pc[..., :3]
            pc = torch.cat([xyz - xyz.mean(dim=1, keepdim=True), pc[..., 3:]], dim=-1)
        h = pc
        for layer in self.point:
            h = layer(h)
            if layer.out_features != 512:
                h = self.act(h)
        if self.max_mean:
            h = torch.cat([h.amax(dim=1), h.mean(dim=1)], dim=-1)
        else:
            h = h.amax(dim=1)
        if proprio is not None:
            h = torch.cat([h, proprio], dim=-1)
        for layer in self.hidden:
            h = self.act(layer(h))
        return self.head(h)


def _init_conv(layer: nn.Conv3d) -> None:
    """flax's default conv init: LeCun normal (variance 1 / fan_in, truncated
    at ±2σ and rescaled to keep the variance), zero bias; drawn on the CPU
    like :func:`_init_dense`."""
    w = torch.empty(layer.weight.shape)
    fan_in = w[0].numel()
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std)
    with torch.no_grad():
        layer.weight.copy_(w)
        layer.bias.zero_()


def _cube_side(n: int, what: str) -> int:
    r = round(n ** (1 / 3))
    if r ** 3 != n:
        raise ValueError(f"{what}: {n} inputs are not a cube of voxels")
    return r


class _Conv3DStack(nn.Module):
    """A volume [b, r³] (x-major voxel order, as the JAX package flattens
    its NDHWC volumes) → strided 3-D convs with symmetric padding k // 2 and
    the activation → (optionally max-pooled) features flattened in
    (D, H, W, C) order."""

    def __init__(self, res: int, layers, act, pool: int = 0):
        super().__init__()
        self.res, self.act, self.pool = res, act, pool
        self.convs = nn.ModuleList()
        c, side = 1, res
        for f, k, s in layers:
            self.convs.append(nn.Conv3d(c, f, k, stride=s, padding=k // 2))
            c, side = f, (side + 2 * (k // 2) - k) // s + 1
        if pool:
            side = (side - pool) // pool + 1
        if side < 1:
            raise ValueError(f"a {res}³ volume shrinks to nothing in {layers}"
                             + (f" and a {pool}³ pool" if pool else ""))
        self.out_features = c * side ** 3

    def reset_parameters(self):
        for conv in self.convs:
            _init_conv(conv)

    def forward(self, vol):
        b, r = vol.shape[0], self.res
        v = vol.reshape(b, 1, r, r, r)
        for conv in self.convs:
            v = self.act(conv(v))
        if self.pool:
            v = F.max_pool3d(v, self.pool, stride=self.pool)
        return v.permute(0, 2, 3, 4, 1).reshape(b, -1)


class Conv3DNet(nn.Module):
    """TSDF volume r³ (+ proprio) → convs 16 / 32 / 32, kernels 5 / 3 / 3,
    strides 3 / 3 / 2 (50 → 17 → 6 → 3) → flatten (‖ proprio) → 256 →
    head."""

    LAYERS = ((16, 5, 3), (32, 3, 3), (32, 3, 2))

    def __init__(self, input_dim: int, output_dim: int, net_cfg: dict,
                 proprio_shape: int = 0):
        super().__init__()
        self.act = get_activation(net_cfg["activation"])
        self.proprio_shape = int(proprio_shape)
        res = _cube_side(input_dim - self.proprio_shape,
                         f"Conv3DNet input {input_dim} less {proprio_shape} proprio")
        self.stack = _Conv3DStack(res, self.LAYERS, self.act)
        self.hidden = nn.Linear(self.stack.out_features + self.proprio_shape, 256)
        self.head = nn.Linear(256, output_dim)
        self.reset_parameters()

    def reset_parameters(self):
        self.stack.reset_parameters()
        _init_dense(self.hidden, math.sqrt(2.0))
        _init_dense(self.head, 1.0 if self.head.out_features == 1 else 0.01)

    def forward(self, x):
        if self.proprio_shape:
            v = self.stack(x[:, :-self.proprio_shape])
            v = torch.cat([v, x[:, -self.proprio_shape:]], dim=-1)
        else:
            v = self.stack(x)
        return self.head(self.act(self.hidden(v)))


class PoolConv3DNet(nn.Module):
    """Volume r³ → convs 16 / 32 / 64, kernels 5 / 3 / 3, stride 2 → 4³ max
    pool → flatten → 32 → head.  Like the JAX net it reshapes its whole
    input as the volume, so it takes no proprio: an input that is not a cube
    raises ``ValueError`` (where the JAX net fails in the reshape)."""

    LAYERS = ((16, 5, 2), (32, 3, 2), (64, 3, 2))

    def __init__(self, input_dim: int, output_dim: int, net_cfg: dict,
                 proprio_shape: int = 0):
        super().__init__()
        self.act = get_activation(net_cfg["activation"])
        res = _cube_side(input_dim, f"PoolConv3DNet input {input_dim} (it takes "
                         f"no proprio; {proprio_shape} given)")
        self.stack = _Conv3DStack(res, self.LAYERS, self.act, pool=4)
        self.hidden = nn.Linear(self.stack.out_features, 32)
        self.head = nn.Linear(32, output_dim)
        self.reset_parameters()

    def reset_parameters(self):
        self.stack.reset_parameters()
        _init_dense(self.hidden, math.sqrt(2.0))
        _init_dense(self.head, 1.0 if self.head.out_features == 1 else 0.01)

    def forward(self, x):
        return self.head(self.act(self.hidden(self.stack(x))))


NETWORKS = {"MLP": MLP, "PointNet": PointNet, "Conv3DNet": Conv3DNet,
            "PoolConv3DNet": PoolConv3DNet}


def make_network(name: str, input_dim: int, output_dim: int, net_cfg: dict,
                 proprio_shape: int = 0) -> nn.Module:
    if name in UNPORTED_NETWORKS:
        raise NotImplementedError(
            f"network {name!r} is not ported yet (ROADMAP Queue A: remaining "
            f"vision modes)")
    return NETWORKS[name](input_dim, output_dim, net_cfg, proprio_shape)
