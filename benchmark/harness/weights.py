"""The networks' starting weights, made by the benchmark from the seed on
the device in one draw, and loaded into the program's modules by name;
the reference builds its networks from the same call.

A dense layer's weight is normal with standard deviation gain/√fan_in
(the gains of the program's own orthogonal init: √2 hidden, 0.01 policy
head, 1 value head), its bias zero; ``log_std`` is log(action_std).
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch

Layout = List[Tuple[str, Tuple[int, int], float]]   # (layer prefix, (out, in), gain)


def dense_stack(prefix: str, dims: Sequence[int], heads: Sequence[float]) -> Layout:
    """Layers ``dims[0] → … → dims[-1]`` named ``<prefix>.<i>``; the last
    ``len(heads)`` layers take the given gains, the others √2."""
    n = len(dims) - 1
    gains = [math.sqrt(2.0)] * (n - len(heads)) + list(heads)
    return [(f"{prefix}.{i}", (b, a), g) for i, (a, b, g) in enumerate(zip(dims[:-1], dims[1:], gains))]


def mlp_layout(net: str, obs: int, hid: Sequence[int], out: int) -> Layout:
    """``models/networks.MLP``: ``<net>.hidden.<i>`` then ``<net>.head``."""
    dims = [obs] + list(hid)
    head_gain = 1.0 if out == 1 else 0.01
    return (dense_stack(f"{net}.hidden", dims, [])
            + [(f"{net}.head", (out, dims[-1]), head_gain)])


def pointnet_layout(net: str, channels: int, proprio: int, out: int) -> Layout:
    """``models/networks.PointNet``: ``<net>.point.<0-2>`` (C → 128 → 256 →
    512), ``<net>.hidden.<0-1>`` (512 + proprio → 128 → 32), ``<net>.head``."""
    head_gain = 1.0 if out == 1 else 0.01
    return (dense_stack(f"{net}.point", [channels, 128, 256, 512], [])
            + dense_stack(f"{net}.hidden", [512 + proprio, 128, 32], [])
            + [(f"{net}.head", (out, 32), head_gain)])


def make(layout: Layout, num_actions: int, action_std: float, seed: int,
         device) -> Dict[str, torch.Tensor]:
    """f32 parameters by state-dict name, drawn from ``seed`` on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    total = sum(o * i for _, (o, i), _ in layout)
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, (o, i), gain in layout:
        out[f"{name}.weight"] = flat[at:at + o * i].reshape(o, i) * (gain / math.sqrt(i))
        out[f"{name}.bias"] = torch.zeros(o, device=device)
        at += o * i
    out["log_std"] = torch.full((num_actions,), math.log(max(action_std, 1e-8)), device=device)
    return out


def load_into(module: torch.nn.Module, weights: Dict[str, torch.Tensor]) -> None:
    """Copy ``weights`` into ``module``'s parameters of the same names; every
    parameter must be given, at its shape."""
    params = dict(module.named_parameters())
    if set(params) != set(weights):
        raise ValueError(f"weights for {sorted(set(weights) ^ set(params))} do not match "
                         f"the module's parameters")
    with torch.no_grad():
        for name, p in params.items():
            if p.shape != weights[name].shape:
                raise ValueError(f"{name}: {tuple(weights[name].shape)} vs {tuple(p.shape)}")
            p.copy_(weights[name])


def mlp_actor_critic(config: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The MLP actor-critic of a configuration (``num_obs``, ``hid_dim``,
    ``num_actions``, ``action_std``)."""
    c = config
    layout = (mlp_layout("actor", c["num_obs"], c["hid_dim"], c["num_actions"])
              + mlp_layout("critic", c["num_obs"], c["hid_dim"], 1))
    return make(layout, c["num_actions"], c["action_std"], seed, device)


def pointnet_actor_critic(config: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The PointNet student of a configuration (``channels``, ``proprio``,
    ``num_actions``, ``action_std``)."""
    c = config
    layout = (pointnet_layout("actor", c["channels"], c["proprio"], c["num_actions"])
              + pointnet_layout("critic", c["channels"], c["proprio"], 1))
    return make(layout, c["num_actions"], c["action_std"], seed, device)
