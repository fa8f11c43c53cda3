"""Mesh / primitive surface point sampling → posed scene point clouds
(PyTorch).

Counterpart of ``partmanip_tpu/ops/pointcloud.py``: per-part surface point
sets sampled once at load (area-weighted triangle sampling, or boxes and
spheres analytically, in numpy: the same samplers and the same draws from a
``np.random.RandomState``), posed and randomly subsampled at query
(:class:`PCFromParts`).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch


def sample_mesh_surface(vertices: np.ndarray, faces: np.ndarray,
                        num_points: int, rng=None) -> np.ndarray:
    """Area-weighted uniform surface samples [num_points, 3]."""
    rng = rng or np.random.RandomState(0)
    v = np.asarray(vertices, np.float64)
    f = np.asarray(faces, np.int64)
    a, b, c = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
    area = 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=-1)
    probs = area / max(area.sum(), 1e-12)
    tri = rng.choice(len(f), size=num_points, p=probs)
    u = rng.rand(num_points, 1)
    w = rng.rand(num_points, 1)
    flip = (u + w) > 1
    u = np.where(flip, 1 - u, u)
    w = np.where(flip, 1 - w, w)
    pts = a[tri] + u * (b[tri] - a[tri]) + w * (c[tri] - a[tri])
    return pts.astype(np.float32)


def sample_box_surface(half_extents, num_points: int, rng=None) -> np.ndarray:
    """Uniform samples on a box surface (for primitive parts)."""
    rng = rng or np.random.RandomState(0)
    h = np.asarray(half_extents, np.float64)
    areas = np.array([h[1] * h[2], h[1] * h[2], h[0] * h[2], h[0] * h[2],
                      h[0] * h[1], h[0] * h[1]])
    face = rng.choice(6, size=num_points, p=areas / areas.sum())
    uv = rng.rand(num_points, 2) * 2 - 1
    ax = face // 2
    sgn = np.where(face % 2 == 0, 1.0, -1.0)
    others = np.array([[1, 2], [0, 2], [0, 1]])[ax]
    rows = np.arange(num_points)
    pts = np.empty((num_points, 3))
    pts[rows, ax] = sgn * h[ax]
    pts[rows, others[:, 0]] = uv[:, 0] * h[others[:, 0]]
    pts[rows, others[:, 1]] = uv[:, 1] * h[others[:, 1]]
    return pts.astype(np.float32)


def sample_sphere_surface(radius: float, num_points: int, rng=None):
    rng = rng or np.random.RandomState(0)
    v = rng.randn(num_points, 3)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    return (radius * v).astype(np.float32)


class PCFromParts:
    """Pose pre-sampled per-part point sets and subsample to num_points."""

    def __init__(self, part_points: List[np.ndarray], num_points: int = 1024,
                 device="cpu"):
        self.num_points = num_points
        self.parts = torch.as_tensor(np.stack(part_points), device=device)  # [M, P, 3]

    def query(self, part_rot: torch.Tensor, part_pos: torch.Tensor,
              generator: Optional[torch.Generator] = None,
              perm: Optional[torch.Tensor] = None) -> torch.Tensor:
        """part_rot [E, M, 3, 3], part_pos [E, M, 3] → [E, num_points, 3]:
        the posed points at the first ``num_points`` entries of a random
        permutation of the M·P points, drawn from ``generator`` or given as
        ``perm`` (the same rows for every env)."""
        posed = torch.einsum("emab,mpb->empa", part_rot, self.parts) + part_pos[:, :, None, :]
        E, M, P, _ = posed.shape
        if perm is None:
            perm = torch.randperm(M * P, generator=generator, device=self.parts.device)
        return posed.reshape(E, M * P, 3)[:, perm[: self.num_points]]
