"""Quaternion / rotation math core (PyTorch).

Counterpart of ``partmanip_tpu/ops/rotations.py``: same functions, same
formulas, same operation order, on ``torch.Tensor``s.  Everything broadcasts
over arbitrary leading batch axes.

Conventions
-----------
* Quaternions are ``[x, y, z, w]`` (scalar-last).
* Rotation matrices are world-from-body: ``p_world = R @ p_body + t``.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product over the last axis, broadcasting the batch axes."""
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def _unit_basis(like: torch.Tensor, axis: int) -> torch.Tensor:
    """Basis vector e_axis with the batch shape of quats ``like``."""
    basis = like.new_zeros(like.shape[:-1] + (3,))
    basis[..., axis] = 1.0
    return basis


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a ⊗ b for xyzw quats."""
    ax, ay, az, aw = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bx, by, bz, bw = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack(
        [
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
            aw * bw - ax * bx - ay * by - az * bz,
        ],
        dim=-1,
    )


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([-q[..., :3], q[..., 3:4]], dim=-1)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector(s) v by quat(s) q."""
    q_vec = q[..., :3]
    q_w = q[..., 3:4]
    t = 2.0 * _cross(q_vec, v)
    return v + q_w * t + _cross(q_vec, t)


def quat_rotate_inverse(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return quat_rotate(quat_conjugate(q), v)


def quat_axis(q: torch.Tensor, axis: int) -> torch.Tensor:
    """Rotated basis vector."""
    return quat_rotate(q, _unit_basis(q, axis))


def quat_from_angle_axis(angle: torch.Tensor, axis: torch.Tensor) -> torch.Tensor:
    """Axis must be unit; angle broadcasts against axis' batch shape."""
    half = 0.5 * angle[..., None]
    return torch.cat([axis * torch.sin(half), torch.cos(half)], dim=-1)


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    """xyzw quat → 3x3 rotation matrix; robust to non-unit quats via the
    2/|q|^2 factor."""
    i, j, k, r = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    two_s = 2.0 / torch.sum(q * q, dim=-1)
    o = torch.stack(
        [
            1 - two_s * (j * j + k * k),
            two_s * (i * j - k * r),
            two_s * (i * k + j * r),
            two_s * (i * j + k * r),
            1 - two_s * (i * i + k * k),
            two_s * (j * k - i * r),
            two_s * (i * k - j * r),
            two_s * (j * k + i * r),
            1 - two_s * (i * i + j * j),
        ],
        dim=-1,
    )
    return o.reshape(q.shape[:-1] + (3, 3))


def _octahedral_group() -> np.ndarray:
    """The 24 rotation matrices of the cube's proper symmetry group."""
    mats = []
    for perm in [(0, 1, 2), (0, 2, 1), (1, 0, 2), (1, 2, 0), (2, 0, 1), (2, 1, 0)]:
        for sx in (1, -1):
            for sy in (1, -1):
                for sz in (1, -1):
                    m = np.zeros((3, 3))
                    m[0, perm[0]] = sx
                    m[1, perm[1]] = sy
                    m[2, perm[2]] = sz
                    if np.linalg.det(m) > 0.5:
                        mats.append(m)
    out = np.stack(mats, axis=0)
    assert out.shape == (24, 3, 3)
    return out


_OCTA = _octahedral_group()


def transform_compose(pos_a, quat_a, pos_b, quat_b):
    """Compose transforms: result = A ∘ B (apply B first, then A)."""
    return quat_rotate(quat_a, pos_b) + pos_a, quat_mul(quat_a, quat_b)


