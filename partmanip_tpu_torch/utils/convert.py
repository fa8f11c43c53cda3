"""Carry weights and state across from the JAX package as plain numpy.

Whoever holds the JAX package's objects flattens them to numpy and hands
them over here (``utils/checkpoint.load_jax`` does so for its checkpoints
without importing JAX):

* :func:`actor_critic_from_jax` — the flax parameter tree of ``ACParams`` →
  a ``state_dict`` for :class:`models.actor_critic.ActorCritic`, for every
  ported network (``MLP``; ``PointNet``, whose flax layers ``Dense_0..Dense_5``
  are the three per-point layers, the two after the pool and the head;
  ``Conv3DNet`` / ``PoolConv3DNet``: ``Conv_0..Conv_2`` with their kernels
  [kD, kH, kW, in, out] as torch's [out, in, kD, kH, kW], then the dense
  layer and the head; ``ResNet`` / ``depthResNet``: the variables dict
  ``{"params", "batch_stats"}``, whose backbone ``ResNet34Backbone_0``
  holds the stem and ``_BasicBlock_0..15``, conv kernels HWIO → OIHW,
  each ``BatchNorm_j``'s ``scale`` / ``bias`` (params) and ``mean`` /
  ``var`` (batch_stats) as the port's ``bn<j>`` parameters, then
  ``Dense_0..2``);
* :func:`adam_state_from_jax` — the Adam state of a JAX optimizer (PPO's
  actor part or critic, or DAgger's whole student) → the port's
  ``{"count", "mu", "nu"}`` keyed by parameter name;
  :func:`actor_critic_to_jax` / :func:`adam_state_to_jax` — the inverses
  (numpy trees in the flax layout);
* :func:`rms_from_jax` — ``{"n", "mean", "S"}`` → ``RMSState``;
* :func:`scene_state_from_numpy` / :func:`env_state_from_numpy` (and their
  ``*_to_numpy`` inverses) — states given as ``[E, ...]`` numpy arrays (the
  JAX layout, which is also the port's) ↔ the port's containers on a device;
  the free body and the articulated object are each optional.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..algos.rms import RMSState
from ..envs.base import EnvState
from ..sim.contact import AnchorState
from ..sim.engine import SceneState
from ..sim.types import FreeBodyState, TreeState


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


def resnet_backbone_names(down):
    """(flax path below the backbone's scope, e.g. ``params/_BasicBlock_3/
    BatchNorm_2/mean``, the port's parameter name below the backbone, and
    ``"kernel"`` for a conv kernel or ``"bn"``) of every parameter of a
    ResNet-34 backbone whose blocks have a 1×1 downsample where ``down``
    [n_blocks] is True, in the port's order."""
    out = []

    def layer(scope, module, j):
        out.append((f"params/{scope}Conv_{j}/kernel", f"{module}conv{j}.weight", "kernel"))
        for col, field in _BN_FIELDS:
            out.append((f"{col}/{scope}BatchNorm_{j}/{field}", f"{module}bn{j}.{field}", "bn"))

    layer("", "", 0)
    for i, has_down in enumerate(down):
        for j in range(3 if has_down else 2):
            layer(f"_BasicBlock_{i}/", f"blocks.{i}.", j)
    return out


def _tree_get(tree: dict, path: str):
    for key in path.split("/"):
        tree = tree[key]
    return tree


def _tree_put(tree: dict, path: str, value) -> None:
    *scopes, leaf = path.split("/")
    for key in scopes:
        tree = tree.setdefault(key, {})
    tree[leaf] = value


def _resnet_backbone_paths(tree: dict):
    """The backbone paths of a flax ResNet variables dict, in the port's
    order: (flax path from the top, port name below the network, kind)."""
    scope = tree["params"]["ResNet34Backbone_0"]
    n_blocks = sum(k.startswith("_BasicBlock_") for k in scope)
    down = ["Conv_2" in scope[f"_BasicBlock_{i}"] for i in range(n_blocks)]
    out = []
    for path, name, kind in resnet_backbone_names(down):
        col, rest = path.split("/", 1)
        out.append((f"{col}/ResNet34Backbone_0/{rest}", f"backbone.{name}", kind))
    return out


def _resnet_from_flax(tree: dict, prefix: str) -> Dict[str, torch.Tensor]:
    """A flax ResNet / depthResNet variables dict (or moments alike) →
    state-dict entries under ``prefix``."""
    out = {}
    for path, name, kind in _resnet_backbone_paths(tree):
        v = np.asarray(_tree_get(tree, path), np.float32)
        if kind == "kernel":
            v = v.transpose(3, 2, 0, 1)
        out[f"{prefix}.{name}"] = torch.from_numpy(np.array(v, order="C"))
    for i, d in enumerate(("hidden.0", "hidden.1", "head")):
        layer = tree["params"][f"Dense_{i}"]
        out[f"{prefix}.{d}.weight"] = torch.from_numpy(np.array(
            np.asarray(layer["kernel"], np.float32).T, order="C"))
        out[f"{prefix}.{d}.bias"] = torch.from_numpy(np.array(layer["bias"], np.float32))
    return out


def _resnet_to_flax(sd: Dict[str, torch.Tensor], prefix: str) -> dict:
    np_ = lambda t: t.detach().cpu().numpy().astype(np.float32)
    n_blocks = len({k.split(".")[3] for k in sd if k.startswith(f"{prefix}.backbone.blocks.")})
    tree = {"params": {"ResNet34Backbone_0": {
        f"_BasicBlock_{i}": {"Conv_2": {}} if f"{prefix}.backbone.blocks.{i}.conv2.weight" in sd
        else {} for i in range(n_blocks)}}}
    for path, name, kind in _resnet_backbone_paths(tree):
        v = np_(sd[f"{prefix}.{name}"])
        _tree_put(tree, path, np.ascontiguousarray(v.transpose(2, 3, 1, 0))
                  if kind == "kernel" else v)
    for i, d in enumerate(("hidden.0", "hidden.1", "head")):
        tree["params"][f"Dense_{i}"] = {
            "kernel": np.ascontiguousarray(np_(sd[f"{prefix}.{d}.weight"]).T),
            "bias": np_(sd[f"{prefix}.{d}.bias"])}
    return tree


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


def actor_critic_to_jax(sd: Dict[str, torch.Tensor], network: str = "MLP") -> dict:
    """The inverse of :func:`actor_critic_from_jax`: a state dict (or
    moments keyed alike) → ``{"actor": {"params": {"Conv_i" / "Dense_i":
    {"kernel", "bias"}}}, "critic": ..., "log_std"}`` with numpy leaves."""
    np_ = lambda t: t.detach().cpu().numpy().astype(np.float32)

    def tree(prefix):
        if network in _RESNETS:
            return _resnet_to_flax(sd, prefix)
        n_dense = len({k for k in sd if k.startswith(prefix + ".hidden.")
                       and k.endswith(".weight")}) + 1
        out = {}
        for flax_name, n in _layer_names(network, n_dense):
            w = np_(sd[f"{prefix}.{n}.weight"])
            out[flax_name] = {"kernel": np.ascontiguousarray(w.transpose(_WEIGHT_TO_FLAX[w.ndim])),
                              "bias": np_(sd[f"{prefix}.{n}.bias"])}
        return {"params": out}
    return {"actor": tree("actor"), "critic": tree("critic"),
            "log_std": np_(sd["log_std"])}


def adam_state_to_jax(state: dict, network: str = "MLP") -> dict:
    """The port's Adam state over a whole ``ActorCritic`` (DAgger's student)
    → ``{"count", "mu", "nu"}`` with the moments as numpy trees in the layout
    of the JAX package's ``ACParams``."""
    return {"count": int(state["count"]),
            "mu": actor_critic_to_jax(state["mu"], network),
            "nu": actor_critic_to_jax(state["nu"], network)}


def adam_state_from_jax(opt_state, part: str, network: str = "MLP") -> dict:
    """The Adam moments and step count of a JAX optimizer state (read by
    ``checkpoint.load_jax``) as the port's optimizer state: ``{"count": int,
    "mu": {name: tensor}, "nu": {...}}`` with the names of
    ``ActorCritic.named_parameters()``.  ``part`` is ``"actor"`` (PPO: the
    actor network and ``log_std``, one optimizer in both packages),
    ``"critic"`` (PPO) or ``"student"`` (DAgger: one optimizer over the
    whole ``ACParams``)."""
    from . import checkpoint
    adam = checkpoint.jax_adam_state(opt_state)

    def moments(tree):
        if part == "student":
            return actor_critic_from_jax(tree._asdict(), network)
        if part == "actor":
            out = _net_from_flax(tree["actor"], "actor", network)
            out["log_std"] = torch.from_numpy(np.array(tree["log_std"], np.float32))
            return out
        if part == "critic":
            return _net_from_flax(tree, "critic", network)
        raise ValueError(f"part must be 'actor', 'critic' or 'student', got {part!r}")
    return {"count": int(adam.count), "mu": moments(adam.mu), "nu": moments(adam.nu)}


def rms_from_jax(d: dict, device="cpu") -> RMSState:
    return RMSState(
        n=torch.as_tensor(np.array(d["n"]), dtype=torch.int32, device=device),
        mean=_f32(d["mean"], device), S=_f32(d["S"], device))


def _f32(x, device):
    return torch.as_tensor(np.array(x, np.float32), device=device)


def scene_state_from_numpy(d: dict, device="cpu") -> SceneState:
    """``{"robot": {qpos, qvel, root_pos, root_quat}, "anchors": {point,
    body}}`` plus, where the scene has them, ``"obj"`` (the articulated
    object's tree state, fields as ``"robot"``) and ``"body"`` ({pos, quat,
    linvel, angvel} of the free body) → ``SceneState``; a part that is
    missing or ``None`` stays ``None``."""
    r, a = d["robot"], d["anchors"]
    tree = lambda t: TreeState(*[_f32(t[k], device) for k in TreeState._fields])
    obj, body = d.get("obj"), d.get("body")
    return SceneState(
        robot=tree(r),
        obj=None if obj is None else tree(obj),
        body=None if body is None else FreeBodyState(
            *[_f32(body[k], device) for k in FreeBodyState._fields]),
        anchors=AnchorState(
            point=_f32(a["point"], device),
            body=torch.as_tensor(np.array(a["body"], np.int32), device=device)))


def scene_state_to_numpy(s: SceneState) -> dict:
    """The inverse of :func:`scene_state_from_numpy` (absent parts left
    out)."""
    def leaves(t):
        return {k: getattr(t, k).detach().cpu().numpy() for k in t._fields}
    return {k: leaves(getattr(s, k)) for k in ("robot", "obj", "body", "anchors")
            if getattr(s, k) is not None}


_ENV_FIELDS = ("progress", "rew_buf", "success", "reset_buf", "reset_succ",
               "epis_max_rew", "epis_max_step")
_ENV_DTYPES = {"progress": np.int32, "epis_max_step": np.int32,
               "success": np.bool_, "reset_buf": np.bool_,
               "reset_succ": np.bool_, "rew_buf": np.float32,
               "epis_max_rew": np.float32}


def env_state_from_numpy(d: dict, rng: torch.Generator,
                         device="cpu") -> EnvState:
    """``{"sim": <scene dict>, "progress", "rew_buf", ...}`` → ``EnvState``
    (the generator is the port's own; PRNG keys do not carry over).  An
    optional ``"task_state"`` array (open_drawer's per-object success
    bitmap) is carried as it is."""
    ts = d.get("task_state")
    return EnvState(
        sim=scene_state_from_numpy(d["sim"], device),
        rng=rng,
        task_state=None if ts is None else torch.as_tensor(
            np.array(ts), device=device),
        **{k: torch.as_tensor(np.array(d[k], _ENV_DTYPES[k]), device=device)
           for k in _ENV_FIELDS})


def env_state_to_numpy(s: EnvState) -> dict:
    out = {k: getattr(s, k).detach().cpu().numpy() for k in _ENV_FIELDS}
    out["sim"] = scene_state_to_numpy(s.sim)
    if s.task_state is not None:
        out["task_state"] = s.task_state.detach().cpu().numpy()
    return out
