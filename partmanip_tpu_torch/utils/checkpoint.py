"""Checkpoint save/resume of the port.

Counterpart of ``partmanip_tpu/utils/checkpoint.py``.  A checkpoint is one
``torch.save`` of a plain dict (state dicts, RMS tensors, python scalars);
tensors are moved to the CPU on save and loaded onto the CPU, so the reader
decides the device.  Checkpoints of the JAX package are pickles of its own
classes and are not read here (``utils/convert.py`` carries weights across
as numpy).
"""

from __future__ import annotations

import os
from typing import Any

import torch


def _to_host(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def save(path: str, obj: Any):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save(_to_host(obj), path)


def load(path: str) -> Any:
    if not os.path.exists(path):
        raise FileNotFoundError(f"no checkpoint at {path}")
    return torch.load(path, map_location="cpu", weights_only=True)
