"""Batched small-matrix linear algebra, unrolled over the static dimension.

Counterpart of ``partmanip_tpu/ops/linalg.py``.  The joint-space systems of
the simulator are tiny (≤16²) and SPD by construction (M + implicit-PD /
contact terms), so the factorization is unrolled over the matrix dimension
with no pivoting; every step is a vector op batched over envs, and the sums
run in the same order as in the JAX file.
"""

from __future__ import annotations

import torch


def cholesky_factor(A: torch.Tensor) -> torch.Tensor:
    """Lower-triangular Cholesky of SPD matrices A [..., D, D], unrolled."""
    D = A.shape[-1]
    L = torch.zeros_like(A)  # filled column by column, in place
    for j in range(D):
        if j > 0:
            s = A[..., j, j] - torch.sum(L[..., j, :j] ** 2, dim=-1)
        else:
            s = A[..., j, j]
        ljj = torch.sqrt(torch.clamp(s, min=1e-12))
        L[..., j, j] = ljj
        if j + 1 < D:
            if j > 0:
                r = A[..., j + 1:, j] - torch.einsum(
                    "...k,...ik->...i", L[..., j, :j], L[..., j + 1:, :j])
            else:
                r = A[..., j + 1:, j]
            L[..., j + 1:, j] = r / ljj[..., None]
    return L


def cholesky_solve(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b given L = chol(A). b [..., D] → x [..., D]."""
    D = L.shape[-1]
    # forward: L y = b
    y = torch.zeros_like(b)
    for i in range(D):
        if i > 0:
            s = b[..., i] - torch.sum(L[..., i, :i] * y[..., :i], dim=-1)
        else:
            s = b[..., i]
        y[..., i] = s / L[..., i, i]
    # backward: Lᵀ x = y
    x = torch.zeros_like(b)
    for i in reversed(range(D)):
        if i + 1 < D:
            s = y[..., i] - torch.sum(L[..., i + 1:, i] * x[..., i + 1:],
                                      dim=-1)
        else:
            s = y[..., i]
        x[..., i] = s / L[..., i, i]
    return x


def spd_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x = A⁻¹ b for batched SPD A [..., D, D], b [..., D]."""
    return cholesky_solve(cholesky_factor(A), b)


def inv3(A: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of batched 3×3 matrices (inertia tensors)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    co00 = e * i - f * h
    co01 = c * h - b * i
    co02 = b * f - c * e
    co10 = f * g - d * i
    co11 = a * i - c * g
    co12 = c * d - a * f
    co20 = d * h - e * g
    co21 = b * g - a * h
    co22 = a * e - b * d
    det = a * co00 + b * co10 + c * co20
    inv = torch.stack([
        torch.stack([co00, co01, co02], -1),
        torch.stack([co10, co11, co12], -1),
        torch.stack([co20, co21, co22], -1),
    ], -2)
    return inv / det[..., None, None]
