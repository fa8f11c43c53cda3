"""Rollout storage semantics: GAE with done-masking and success-pinned
returns, plus minibatch index generation (PyTorch).

Counterpart of ``partmanip_tpu/algos/storage.py``:

* GAE: the advantage is zeroed across done boundaries via
  ``next_is_not_terminal`` — the post-reset transition carries no gradient —
  and returns are pinned to ``succ_value`` on success steps;
* minibatching: sequential or random permutation of the flattened [T·E]
  buffer, minibatch size min(total // n_minibatches, 2048), drop-last.

``buffer_minibatch_indices`` (the DAgger ring buffer) is not ported yet
(ROADMAP Queue A: BC / DAgger training).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


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
                    whole_adv_norm: bool = False):
    """GAE over the rollout, last step first.

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
        advantages = ((advantages - advantages.mean())
                      / (advantages.std(correction=0) + 1e-8))
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
