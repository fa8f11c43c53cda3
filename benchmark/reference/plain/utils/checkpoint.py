"""Checkpoint save/resume of the port, and a reader for the JAX package's
checkpoints.

Counterpart of ``partmanip_tpu/utils/checkpoint.py``.  A checkpoint of the
port is one ``torch.save`` of a plain dict (state dicts, RMS tensors, python
scalars); tensors are moved to the CPU on save and loaded onto the CPU, so
the reader decides the device.

A checkpoint of the JAX package is a pickle whose leaves are numpy arrays,
held in the JAX package's ``ACParams`` / ``RMSState`` named tuples beside
optax optimizer states.  :func:`load_jax` reads it with a restricted
unpickler that maps those classes and the optax states it knows (the
``inject_hyperparams`` wrapper, ``ScaleByAdamState``, ``EmptyState``) to
local stand-ins and refuses every other class, so it imports nothing of JAX,
optax or the JAX package; ``utils/convert.py`` turns the result into the
port's modules and Adam moments.
"""

from __future__ import annotations

import importlib
import os
import pickle
import zipfile
from typing import Any, NamedTuple

import numpy as np
import torch


# ----------------------------------------------------------------------
# checkpoints of the JAX package
# ----------------------------------------------------------------------

class JaxACParams(NamedTuple):
    """Stand-in of ``partmanip_tpu.models.actor_critic.ACParams``: flax
    parameter trees of numpy arrays."""

    actor: Any
    critic: Any
    log_std: Any


class JaxRMSState(NamedTuple):
    """Stand-in of ``partmanip_tpu.algos.rms.RMSState``."""

    n: Any
    mean: Any
    S: Any


class JaxInjectState(NamedTuple):
    """Stand-in of optax's ``InjectStatefulHyperparamsState`` (the state of
    ``optax.inject_hyperparams``)."""

    count: Any
    hyperparams: Any
    hyperparams_states: Any
    inner_state: Any


class JaxAdamState(NamedTuple):
    """Stand-in of optax's ``ScaleByAdamState``: the step count and the two
    moments, trees shaped like the parameters."""

    count: Any
    mu: Any
    nu: Any


class JaxEmptyState(NamedTuple):
    """Stand-in of optax's ``EmptyState`` (clip_by_global_norm, scale)."""


_STANDINS = {
    ("partmanip_tpu.models.actor_critic", "ACParams"): JaxACParams,
    ("partmanip_tpu.algos.rms", "RMSState"): JaxRMSState,
    ("optax.schedules._inject", "InjectStatefulHyperparamsState"): JaxInjectState,
    ("optax.schedules._inject", "InjectHyperparamsState"): JaxInjectState,
    ("optax._src.transform", "ScaleByAdamState"): JaxAdamState,
    ("optax._src.base", "EmptyState"): JaxEmptyState,
}
# numpy's array / dtype / scalar reconstructors, under numpy 1.x and 2.x names
_NUMPY = {("numpy", "ndarray"), ("numpy", "dtype"),
          ("numpy.core.multiarray", "_reconstruct"),
          ("numpy._core.multiarray", "_reconstruct"),
          ("numpy.core.multiarray", "scalar"),
          ("numpy._core.multiarray", "scalar")}


class _JaxUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) in _STANDINS:
            return _STANDINS[(module, name)]
        if (module, name) in _NUMPY:
            try:
                mod = importlib.import_module(module)
            except ImportError:       # the other numpy major version's name
                mod = importlib.import_module(
                    module.replace("numpy._core", "numpy.core")
                    if "._core" in module else
                    module.replace("numpy.core", "numpy._core"))
            return getattr(mod, name)
        raise pickle.UnpicklingError(
            f"refusing to load {module}.{name} from a JAX checkpoint")


def load_jax(path: str) -> dict:
    """The dict a JAX ``PPO.save`` wrote, with ``params`` a
    :class:`JaxACParams`, ``rms`` a :class:`JaxRMSState` and the optimizer
    states ``opt_actor`` / ``opt_critic`` as :class:`JaxInjectState`."""
    with open(path, "rb") as f:
        d = _JaxUnpickler(f).load()
    if not isinstance(d, dict) or not isinstance(d.get("params"), JaxACParams):
        raise ValueError(f"{path} is not a PPO checkpoint of the JAX package")
    return d


