"""Policy/value networks (``torch.nn``).

Counterpart of ``partmanip_tpu/models/networks.py`` for the ``MLP``
architecture: hid_dim list, activation from config, orthogonal init with the
stable-baselines gain schedule (√2 hidden, 0.01 policy head, 1 value head),
zero biases.  The vision architectures (Conv3DNet, PoolConv3DNet, PointNet,
ResNet) are not ported yet.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn as nn
import torch.nn.functional as F

UNPORTED_NETWORKS = ("Conv3DNet", "PoolConv3DNet", "PointNet", "ResNet",
                     "depthResNet")


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


NETWORKS = {"MLP": MLP}


def make_network(name: str, input_dim: int, output_dim: int, net_cfg: dict,
                 proprio_shape: int = 0) -> nn.Module:
    if name in UNPORTED_NETWORKS:
        raise NotImplementedError(
            f"network {name!r} is not ported yet (ROADMAP Queue A: vision "
            f"student)")
    return NETWORKS[name](input_dim, output_dim, net_cfg, proprio_shape)
