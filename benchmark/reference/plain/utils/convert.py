"""The JAX package's actor-critic parameters, given as plain numpy by
``utils/checkpoint.load_jax`` (which reads its checkpoints without
importing JAX), as a ``state_dict`` of named tensors
(:func:`actor_critic_from_jax`): ``MLP`` and ``PointNet``, whose flax
layers ``Dense_0..Dense_5`` are the three per-point layers, the two after
the pool and the head."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch



# the port's layers in the order of the flax tree's Dense_0, Dense_1, … (an
# MLP's hidden layers are counted from the tree)
_DENSE = {"PointNet": ("point.0", "point.1", "point.2", "hidden.0", "hidden.1", "head"),
          "Conv3DNet": ("hidden", "head"), "PoolConv3DNet": ("hidden", "head")}
# … and of its Conv_0, Conv_1, …: flax kernels [kD, kH, kW, in, out], torch
# weights [out, in, kD, kH, kW]
_CONV = {"Conv3DNet": ("stack.convs.0", "stack.convs.1", "stack.convs.2"),
         "PoolConv3DNet": ("stack.convs.0", "stack.convs.1", "stack.convs.2")}
_KERNEL_TO_TORCH = {2: (1, 0), 5: (4, 3, 0, 1, 2)}
_WEIGHT_TO_FLAX = {2: (1, 0), 5: (2, 3, 4, 1, 0)}


_RESNETS = ("ResNet", "depthResNet")
_BN_FIELDS = (("params", "scale"), ("params", "bias"), ("batch_stats", "mean"),
              ("batch_stats", "var"))


def _net_from_flax(tree: dict, prefix: str, network: str) -> Dict[str, torch.Tensor]:
    if network in _RESNETS:
        return _resnet_from_flax(tree, prefix)
    return _dense_from_flax(tree, prefix, network)


def _layer_names(network: str, n_dense: int):
    """(flax name, port name) of every layer of ``network``."""
    if network == "MLP":
        dense = [f"hidden.{i}" for i in range(n_dense - 1)] + ["head"]
    elif network in _DENSE:
        dense = list(_DENSE[network])
    else:
        raise NotImplementedError(f"no converter for network {network!r}")
    return ([(f"Conv_{i}", n) for i, n in enumerate(_CONV.get(network, ()))]
            + [(f"Dense_{i}", n) for i, n in enumerate(dense)])


def _dense_from_flax(tree: dict, prefix: str, network: str) -> Dict[str, torch.Tensor]:
    """``{"params": {"Conv_i" / "Dense_i": {"kernel", "bias"}}}`` → entries
    ``<prefix>.<layer>.weight`` …: for an MLP ``hidden.i`` and the last
    Dense the head; for a PointNet ``point.0-2``, ``hidden.0-1``, ``head``;
    for a Conv3DNet / PoolConv3DNet ``stack.convs.0-2``, ``hidden``,
    ``head``."""
    layers = tree["params"] if "params" in tree else tree
    n_dense = sum(name.startswith("Dense_") for name in layers)
    names = _layer_names(network, n_dense)
    if sorted(f for f, _ in names) != sorted(layers):
        raise ValueError(f"{network} has layers {sorted(f for f, _ in names)}, "
                         f"the tree {sorted(layers)}")
    out = {}
    for flax_name, d in names:
        kernel = np.asarray(layers[flax_name]["kernel"], np.float32)
        out[f"{prefix}.{d}.weight"] = torch.from_numpy(np.array(
            kernel.transpose(_KERNEL_TO_TORCH[kernel.ndim]), order="C"))
        out[f"{prefix}.{d}.bias"] = torch.from_numpy(
            np.array(layers[flax_name]["bias"], np.float32))
    return out


def actor_critic_from_jax(np_tree: dict, network: str = "MLP") -> Dict[str, torch.Tensor]:
    """``{"actor": {"params": {...}}, "critic": {...}, "log_std"}`` (numpy
    leaves) of a ``network`` actor-critic →
    ``ActorCritic.load_state_dict`` input."""
    sd = {"log_std": torch.from_numpy(np.array(np_tree["log_std"], np.float32))}
    sd.update(_net_from_flax(np_tree["actor"], "actor", network))
    sd.update(_net_from_flax(np_tree["critic"], "critic", network))
    return sd


_ENV_FIELDS = ("progress", "rew_buf", "success", "reset_buf", "reset_succ",
               "epis_max_rew", "epis_max_step")
_ENV_DTYPES = {"progress": np.int32, "epis_max_step": np.int32,
               "success": np.bool_, "reset_buf": np.bool_,
               "reset_succ": np.bool_, "rew_buf": np.float32,
               "epis_max_rew": np.float32}


