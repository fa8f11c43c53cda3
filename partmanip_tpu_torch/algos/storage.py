"""Rollout storage semantics: GAE with done-masking and success-pinned
returns, plus minibatch index generation (PyTorch).

Counterpart of ``partmanip_tpu/algos/storage.py``:

* GAE: the advantage is zeroed across done boundaries via
  ``next_is_not_terminal`` — the post-reset transition carries no gradient —
  and returns are pinned to ``succ_value`` on success steps;
* minibatching: sequential or random permutation of the flattened [T·E]
  buffer, minibatch size min(total // n_minibatches, 2048), drop-last;
* the DAgger ring buffer's minibatches: a fresh shuffle of its valid rows
  per epoch (:func:`buffer_minibatch_indices`);
* the demo trees BC trains on and DAgger ingests (:func:`read_demo_tree`).
"""

from __future__ import annotations

import os
from os.path import join as pjoin
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..parallel import mesh as mesh_lib


class Rollout(NamedTuple):
    """Stacked trajectory tensors, time-major [T, E, ...]."""

    observations: torch.Tensor     # [T, E, O] (normalized if state-norm on)
    actions: torch.Tensor          # [T, E, A] activated actions
    rewards: torch.Tensor          # [T, E]
    dones: torch.Tensor            # [T, E] bool (reset_buf)
    succs: torch.Tensor            # [T, E] bool (reset_succ)
    values: torch.Tensor           # [T, E]
    log_probs: torch.Tensor        # [T, E]
    mu: torch.Tensor               # [T, E, A]
    sigma: torch.Tensor            # [T, E, A] log-std rows


def compute_returns(r: Rollout, last_values: torch.Tensor, gamma: float,
                    lam: float, succ_value: Optional[float],
                    whole_adv_norm: bool = False, mesh=None):
    """GAE over the rollout, last step first.  With a ``mesh``
    (``parallel/mesh.py``) the whole-buffer normalisation takes the mean and
    the spread of every rank's advantages.

    Returns (returns [T, E], advantages [T, E]).
    """
    not_terminal = (~r.dones).to(r.rewards.dtype)
    succs = r.succs.to(r.rewards.dtype)
    next_values = torch.cat([r.values[1:], last_values[None]], dim=0)
    adv_next = torch.zeros_like(last_values)
    returns = [None] * r.rewards.shape[0]
    for t in reversed(range(r.rewards.shape[0])):
        delta = r.rewards[t] + gamma * next_values[t] - r.values[t]
        adv_next = not_terminal[t] * (delta + gamma * lam * adv_next)
        if succ_value is not None:
            returns[t] = ((1.0 - succs[t]) * (adv_next + r.values[t])
                          + succs[t] * succ_value)
        else:
            returns[t] = adv_next + r.values[t]
    returns = torch.stack(returns)
    advantages = returns - r.values
    if whole_adv_norm:
        # population std (ddof 0), as jnp.std
        n = advantages.numel() * (1 if mesh is None else mesh.size)
        m = mesh_lib.mean(mesh, advantages, n)
        advantages = (advantages - m) / (mesh_lib.std(mesh, advantages, m, n) + 1e-8)
    return returns, advantages


def minibatch_indices(generator: torch.Generator, total: int,
                      num_mini_batches: int, sampler: str = "sequential",
                      n_epochs: int = 1, device=None) -> torch.Tensor:
    """Index matrix [n_epochs·n_batches, mb_size] (int64) over the flattened
    buffer.

    ``random`` draws a *fresh* permutation per epoch from ``generator``;
    ``sequential`` partitions once and tiles it across epochs."""
    mb = min(total // num_mini_batches, 2048)
    n = total // mb  # drop_last
    if sampler == "sequential":
        return torch.arange(n * mb, device=device).reshape(n, mb).repeat(n_epochs, 1)
    if sampler == "random":
        dev = device if device is not None else generator.device
        perms = [torch.randperm(total, generator=generator, device=generator.device)
                 [: n * mb].to(dev) for _ in range(n_epochs)]
        return torch.stack(perms).reshape(n_epochs * n, mb)
    raise NotImplementedError(sampler)


def buffer_minibatch_indices(generator: torch.Generator, cap: int, size,
                             n_epochs: int, n_batches: int, mb: int) -> torch.Tensor:
    """Without-replacement minibatch indices over the first ``size`` valid
    rows of a [cap]-row ring buffer, a fresh shuffle per epoch drawn from
    ``generator``: each epoch sorts the valid rows to the front in random
    order, and batch positions wrap mod ``max(size, 1)`` only when an epoch
    needs more rows than are valid.  ``size`` may be a device scalar (no
    host sync).

    Returns int64 [n_epochs·n_batches, mb] on the generator's device."""
    dev = generator.device
    key = torch.rand((n_epochs, cap), generator=generator, device=dev)
    size = torch.as_tensor(size, device=dev)
    key = key + (torch.arange(cap, device=dev) >= size) * 10.0   # valid rows first
    perms = torch.argsort(key, dim=1)
    pos = torch.arange(n_batches * mb, device=dev) % torch.clamp(size, min=1)
    return perms[:, pos].reshape(n_epochs * n_batches, mb)


def read_demo_tree(folder: str, add_proprio: bool, label: str):
    """The rows of a ``<folder>/<scene>/<step>.npy`` demo tree (dicts with
    ``tsdf``, ``proprio_state``, ``action``, ``tea_obs``), scenes and steps
    in sorted order: (student obs: the flattened ``tsdf`` (‖ ``proprio_state``
    with ``add_proprio``), the flattened ``label`` entry), each a list of
    f32 numpy rows."""
    obs, labels = [], []
    for scene in sorted(os.listdir(folder)):
        for step in sorted(os.listdir(pjoin(folder, scene))):
            d = np.load(pjoin(folder, scene, step), allow_pickle=True).item()
            o = np.asarray(d["tsdf"], np.float32).reshape(-1)
            if add_proprio:
                o = np.concatenate(
                    [o, np.asarray(d["proprio_state"], np.float32).reshape(-1)])
            obs.append(o)
            labels.append(np.asarray(d[label], np.float32).reshape(-1))
    return obs, labels
