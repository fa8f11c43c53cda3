"""Farthest-point sampling judged by its definition, written for the
benchmark: starting from index 0, each pick is a point farthest from the
points picked before it.  Distances are taken in float64, so a pick that
ties the farthest within the program's float32 rounding passes and a pick
that falls short of it shows."""

from __future__ import annotations

import torch


@torch.no_grad()
def shortfall(points: torch.Tensor, idx: torch.Tensor) -> float:
    """The widest share by which a pick of ``idx`` [B, k] lies nearer to
    the points picked before it than the farthest point of ``points``
    [B, N, 3] does, over the rows and picks (0 where every pick is a
    farthest point; 1 for a first pick other than index 0, or a pick taken
    twice)."""
    p = points.double()
    idx = idx.long()
    B, k = idx.shape
    rows = torch.arange(B, device=p.device)
    worst = (idx[:, 0] != 0).double()
    nearest = torch.full(p.shape[:2], float("inf"), dtype=torch.float64, device=p.device)
    for i in range(1, k):
        d = ((p - p[rows, idx[:, i - 1]][:, None, :]) ** 2).sum(-1)
        nearest = torch.minimum(nearest, d)
        far = nearest.amax(dim=1)
        got = nearest[rows, idx[:, i]]
        worst = torch.maximum(worst, (far - got) / far.clamp(min=1e-30))
    return float(worst.max())


@torch.no_grad()
def sample(points: torch.Tensor, k: int) -> torch.Tensor:
    """Farthest-point sampling of ``points`` [B, N, 3] from index 0, the
    lowest index on ties, in the points' own precision: indices [B, k]
    (the controls' sampler)."""
    B = points.shape[0]
    rows = torch.arange(B, device=points.device)
    idx = torch.zeros((B, k), dtype=torch.int64, device=points.device)
    nearest = torch.full(points.shape[:2], float("inf"), dtype=points.dtype, device=points.device)
    for i in range(1, k):
        nearest = torch.minimum(nearest, ((points - points[rows, idx[:, i - 1]][:, None, :]) ** 2
                                          ).sum(-1))
        idx[:, i] = nearest.argmax(dim=1)
    return idx
