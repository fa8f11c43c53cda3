"""Copies of what the program produced, as plain data that the reference
can read without the program's classes: a named tuple becomes
``{"type": <class name>, "fields": {...}}``, a tensor a clone, a
``torch.Generator`` its state and device; dicts, lists and tuples keep
their shape."""

from __future__ import annotations

import torch


def snapshot(x):
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    if isinstance(x, torch.Generator):
        return {"generator": x.get_state().clone(), "device": str(x.device)}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return {"type": type(x).__name__,
                "fields": {k: snapshot(getattr(x, k)) for k in x._fields}}
    if isinstance(x, dict):
        return {k: snapshot(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(snapshot(v) for v in x)
    return x


def rebuild(x, types: dict):
    """A :func:`snapshot` as objects of ``types`` (class name → class)."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, dict) and set(x) == {"generator", "device"}:
        g = torch.Generator(device=x["device"])
        g.set_state(x["generator"])
        return g
    if isinstance(x, dict) and set(x) == {"type", "fields"}:
        return types[x["type"]](**{k: rebuild(v, types) for k, v in x["fields"].items()})
    if isinstance(x, dict):
        return {k: rebuild(v, types) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(rebuild(v, types) for v in x)
    return x


def tensors(x, prefix=""):
    """``{dotted path: tensor}`` of the tensors in a snapshot."""
    out = {}
    if isinstance(x, torch.Tensor):
        out[prefix] = x
    elif isinstance(x, dict) and set(x) == {"type", "fields"}:
        out.update(tensors(x["fields"], prefix))
    elif isinstance(x, dict) and set(x) != {"generator", "device"}:
        for k, v in x.items():
            out.update(tensors(v, f"{prefix}.{k}" if prefix else str(k)))
    return out
