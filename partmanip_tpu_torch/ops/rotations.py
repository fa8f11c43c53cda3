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


def normalize(v: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    """Normalize along the last axis."""
    return v / (torch.linalg.norm(v, dim=-1, keepdim=True) + eps)


def quat_unit(q: torch.Tensor) -> torch.Tensor:
    return normalize(q)


def quat_identity(shape=(), device=None) -> torch.Tensor:
    q = torch.zeros(tuple(shape) + (4,), device=device)
    q[..., 3] = 1.0
    return q


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


def quat_from_euler_xyz(roll, pitch, yaw) -> torch.Tensor:
    """Intrinsic XYZ (roll-pitch-yaw) Euler angles to xyzw quat.

    Matches URDF ``rpy`` semantics: R = Rz(yaw) @ Ry(pitch) @ Rx(roll).
    """
    cr, sr = torch.cos(roll * 0.5), torch.sin(roll * 0.5)
    cp, sp = torch.cos(pitch * 0.5), torch.sin(pitch * 0.5)
    cy, sy = torch.cos(yaw * 0.5), torch.sin(yaw * 0.5)
    return torch.stack(
        [
            sr * cp * cy - cr * sp * sy,
            cr * sp * cy + sr * cp * sy,
            cr * cp * sy - sr * sp * cy,
            cr * cp * cy + sr * sp * sy,
        ],
        dim=-1,
    )


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


def mat_to_quat(m: torch.Tensor) -> torch.Tensor:
    """3x3 rotation matrix → xyzw quat (branch-free Shepperd's method)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=1e-12))

    qw_w = safe_sqrt(1.0 + tr) * 0.5
    q_w = torch.stack(
        [(m21 - m12), (m02 - m20), (m10 - m01), 4.0 * qw_w * qw_w], dim=-1
    ) / (4.0 * qw_w[..., None])

    qx_x = safe_sqrt(1.0 + m00 - m11 - m22) * 0.5
    q_x = torch.stack(
        [4.0 * qx_x * qx_x, (m01 + m10), (m02 + m20), (m21 - m12)], dim=-1
    ) / (4.0 * qx_x[..., None])

    qy_y = safe_sqrt(1.0 - m00 + m11 - m22) * 0.5
    q_y = torch.stack(
        [(m01 + m10), 4.0 * qy_y * qy_y, (m12 + m21), (m02 - m20)], dim=-1
    ) / (4.0 * qy_y[..., None])

    qz_z = safe_sqrt(1.0 - m00 - m11 + m22) * 0.5
    q_z = torch.stack(
        [(m02 + m20), (m12 + m21), 4.0 * qz_z * qz_z, (m10 - m01)], dim=-1
    ) / (4.0 * qz_z[..., None])

    # Choose the branch with the largest pivot.
    cand = torch.stack([q_w, q_x, q_y, q_z], dim=-2)  # [..., 4, 4]
    pivots = torch.stack(
        [1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22,
         1.0 - m00 - m11 + m22],
        dim=-1,
    )
    best = torch.argmax(pivots, dim=-1)
    idx = best[..., None, None].expand(best.shape + (1, 4))
    q = torch.gather(cand, -2, idx)[..., 0, :]
    return quat_unit(q)


def orientation_error(desired: torch.Tensor, current: torch.Tensor) -> torch.Tensor:
    """Small-angle orientation error."""
    q_r = quat_mul(desired, quat_conjugate(current))
    return q_r[..., 0:3] * torch.sign(q_r[..., 3:4])


def quat_diff_rad(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Angle between two quats in radians."""
    mul = quat_mul(a, quat_conjugate(b))
    return 2.0 * torch.arcsin(
        torch.clamp(torch.linalg.norm(mul[..., 0:3], dim=-1), max=1.0)
    )


def mat_diff_rad(m1: torch.Tensor, m2: torch.Tensor) -> torch.Tensor:
    """Geodesic angle between rotation matrices."""
    diff = torch.matmul(m1.transpose(-1, -2), m2)
    tr = diff[..., 0, 0] + diff[..., 1, 1] + diff[..., 2, 2]
    return torch.arccos(torch.clamp((tr - 1.0) / 2.0, -1.0, 1.0))


def scale_transform(x, lower, upper):
    """Normalize x from [lower, upper] to [-1, 1]."""
    offset = (lower + upper) * 0.5
    return 2.0 * (x - offset) / (upper - lower)


def unscale_transform(x, lower, upper):
    offset = (lower + upper) * 0.5
    return x * (upper - lower) * 0.5 + offset


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


def deambiguity_rotation(q: torch.Tensor) -> torch.Tensor:
    """Snap a cube orientation to its symmetry-canonical frame.

    Given quat(s) ``q`` of a (symmetric) cube, returns among the 24
    symmetry-equivalent rotation matrices ``R @ S`` (S in the rotational
    octahedral group) the one closest to the identity (max trace).

    Args:
        q: [..., 4] xyzw quats.
    Returns:
        [..., 3, 3] canonical rotation matrices.
    """
    r = quat_to_mat(q)  # [..., 3, 3]
    sym = torch.as_tensor(_OCTA, dtype=r.dtype, device=r.device)  # [24, 3, 3]
    cand = torch.einsum("...ij,kjl->...kil", r, sym)  # [..., 24, 3, 3]
    tr = cand[..., 0, 0] + cand[..., 1, 1] + cand[..., 2, 2]
    best = torch.argmax(tr, dim=-1)
    idx = best[..., None, None, None].expand(best.shape + (1, 3, 3))
    return torch.gather(cand, -3, idx)[..., 0, :, :]


def transform_apply(pos: torch.Tensor, quat: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Apply rigid transform (pos, quat) to point(s) p."""
    return quat_rotate(quat, p) + pos


def transform_compose(pos_a, quat_a, pos_b, quat_b):
    """Compose transforms: result = A ∘ B (apply B first, then A)."""
    return quat_rotate(quat_a, pos_b) + pos_a, quat_mul(quat_a, quat_b)


def transform_inverse(pos, quat):
    qi = quat_conjugate(quat)
    return -quat_rotate(qi, pos), qi


def quat_to_angle_axis(q: torch.Tensor):
    """xyzw quat → (angle, axis), angle normalized to [-π, π]."""
    w = torch.clamp(q[..., 3], -1.0, 1.0)
    sin_theta = torch.sqrt(torch.clamp(1.0 - w * w, min=0.0))
    angle = normalize_angle(2.0 * torch.arccos(w))
    small = sin_theta <= 1e-5
    axis = q[..., 0:3] / torch.where(small, 1.0, sin_theta)[..., None]
    default_axis = torch.zeros_like(axis)
    default_axis[..., 2] = 1.0
    angle = torch.where(small, 0.0, angle)
    axis = torch.where(small[..., None], default_axis, axis)
    return angle, axis


def normalize_angle(a: torch.Tensor) -> torch.Tensor:
    """Wrap to [-π, π]."""
    return torch.remainder(a + math.pi, 2 * math.pi) - math.pi


def angle_axis_to_exp_map(angle, axis):
    return angle[..., None] * axis


def quat_to_exp_map(q):
    angle, axis = quat_to_angle_axis(q)
    return angle_axis_to_exp_map(angle, axis)


def exp_map_to_angle_axis(exp_map):
    angle = torch.linalg.norm(exp_map, dim=-1)
    small = angle <= 1e-5
    axis = exp_map / torch.where(small, 1.0, angle)[..., None]
    default_axis = torch.zeros_like(exp_map)
    default_axis[..., 2] = 1.0
    return (torch.where(small, 0.0, normalize_angle(angle)),
            torch.where(small[..., None], default_axis, axis))


def exp_map_to_quat(exp_map):
    angle, axis = exp_map_to_angle_axis(exp_map)
    return quat_from_angle_axis(angle, axis)


def quat_to_tan_norm(q):
    """Rotation as (tangent, normal) 6D."""
    tan = quat_axis(q, 0)
    norm_ = quat_axis(q, 2)
    return torch.cat([tan, norm_], dim=-1)


def slerp(q0, q1, t):
    """Spherical interpolation, shortest arc."""
    cos_half = torch.sum(q0 * q1, dim=-1, keepdim=True)
    q1 = torch.where(cos_half < 0, -q1, q1)
    cos_half = torch.abs(cos_half)
    cos_half = torch.clamp(cos_half, 0.0, 1.0)
    half = torch.arccos(cos_half)
    sin_half = torch.sqrt(torch.clamp(1.0 - cos_half * cos_half, min=0.0))
    safe_sin = torch.where(torch.abs(sin_half) < 1e-3, 1.0, sin_half)
    ra = torch.sin((1 - t) * half) / safe_sin
    rb = torch.sin(t * half) / safe_sin
    out = ra * q0 + rb * q1
    lin = (1 - t) * q0 + t * q1  # near-parallel case
    out = torch.where(torch.abs(sin_half) < 1e-3, lin, out)
    return torch.where(cos_half >= 1.0, q0, out)


def calc_heading(q):
    """xy-plane heading angle."""
    rot_dir = quat_axis(q, 0)
    return torch.atan2(rot_dir[..., 1], rot_dir[..., 0])


def calc_heading_quat(q):
    return quat_from_angle_axis(calc_heading(q), _unit_basis(q, 2))


def calc_heading_quat_inv(q):
    return quat_from_angle_axis(-calc_heading(q), _unit_basis(q, 2))


def local_to_world_space(pos_offset_local, pose_global):
    """Local-frame point → world. pose_global: [..., 7] (pos + xyzw quat)."""
    return quat_rotate(pose_global[..., 3:7], pos_offset_local) \
        + pose_global[..., 0:3]
