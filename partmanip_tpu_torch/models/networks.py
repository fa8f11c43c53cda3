"""Policy/value networks (``torch.nn``).

Counterpart of ``partmanip_tpu/models/networks.py`` for the ``MLP`` and
``PointNet`` architectures: activation from config, orthogonal init with the
stable-baselines gain schedule (√2 hidden, 0.01 policy head, 1 value head),
zero biases.  The other vision architectures (Conv3DNet, PoolConv3DNet,
ResNet, depthResNet) are not ported yet.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn as nn
import torch.nn.functional as F

UNPORTED_NETWORKS = ("Conv3DNet", "PoolConv3DNet", "ResNet", "depthResNet")


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


NETWORKS = {"MLP": MLP, "PointNet": PointNet}


def make_network(name: str, input_dim: int, output_dim: int, net_cfg: dict,
                 proprio_shape: int = 0) -> nn.Module:
    if name in UNPORTED_NETWORKS:
        raise NotImplementedError(
            f"network {name!r} is not ported yet (ROADMAP Queue A: remaining "
            f"vision modes)")
    return NETWORKS[name](input_dim, output_dim, net_cfg, proprio_shape)
