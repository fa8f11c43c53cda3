"""Running mean/std observation normalization (PyTorch).

Counterpart of ``partmanip_tpu/algos/rms.py``: Chan's parallel-variance
update where each call folds one batch in with weight 1/n, and normalization
divides by std (no epsilon — S is seeded with 1e-4 so std never hits exact
zero).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..parallel import mesh as mesh_lib


class RMSState(NamedTuple):
    n: torch.Tensor      # i32 scalar: number of batches folded in
    mean: torch.Tensor   # [1, D]
    S: torch.Tensor      # [1, D] accumulated (n × variance)

    @property
    def std(self) -> torch.Tensor:
        return torch.sqrt(self.S / torch.clamp(self.n, min=1))


def init_rms(shape: int, device=None) -> RMSState:
    return RMSState(
        n=torch.zeros((), dtype=torch.int32, device=device),
        mean=torch.zeros((1, shape), device=device),
        S=torch.ones((1, shape), device=device) * 1e-4,
    )


def update_rms(state: RMSState, x: torch.Tensor, mesh=None) -> RMSState:
    """Fold one batch [B, D] in.  With a ``mesh`` (``parallel/mesh.py``)
    the batch is the rows of every rank: its mean and its spread about it
    are all-reduced, so every rank folds in the same numbers."""
    n = state.n + 1
    if mesh is None:
        batch_mean = x.mean(dim=0, keepdim=True)
        spread = torch.mean((x - batch_mean) ** 2, dim=0, keepdim=True)
    else:
        rows = x.shape[0] * mesh.size
        batch_mean = mesh_lib.all_sum(mesh, x.sum(dim=0, keepdim=True)) / rows
        spread = mesh_lib.all_sum(mesh, ((x - batch_mean) ** 2).sum(dim=0, keepdim=True)) / rows
    mean = state.mean + (batch_mean - state.mean) / n
    S = (state.S + spread
         + (state.mean - batch_mean) ** 2 * (n - 1) / n)
    return RMSState(n=n, mean=mean, S=S)


def normalize(state: RMSState, x: torch.Tensor,
              update: torch.Tensor | bool = True, mesh=None
              ) -> Tuple[torch.Tensor, RMSState]:
    """(x − mean)/std with optional state update.  ``update`` may be a bool
    tensor (the freeze-at-50%-success flag); ``mesh``: see
    :func:`update_rms`."""
    if isinstance(update, bool):
        if update:
            state = update_rms(state, x, mesh)
    else:
        upd = update_rms(state, x, mesh)
        state = RMSState(*[torch.where(update, a, b)
                           for a, b in zip(upd, state)])
    return (x - state.mean) / state.std, state
