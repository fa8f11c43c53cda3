"""Batched forward kinematics and Jacobians for padded articulations.

Counterpart of ``partmanip_tpu/sim/kinematics.py``: link poses and analytic
world-frame Jacobians as plain functions of ``(spec, state)``, batched over
envs.  The link sweep is a Python loop over L (≤16); joint types are blended
branchlessly so padded per-env topologies run through one code path.
"""

from __future__ import annotations

import torch

from ..ops import rotations as rot
from .types import FK, HostCache, TreeSpec, TreeState

# parent tables of shared (env axis 1) topologies, read to the host once
_STATIC_PARENTS = HostCache()


def _static_parents(spec: TreeSpec):
    """Parent indices as python ints when all envs share one topology
    (a plain slice instead of a per-env gather), else None."""
    if spec.parent.shape[0] != 1:
        return None
    return _STATIC_PARENTS.get(
        spec.parent, lambda: [int(x) for x in spec.parent[0].tolist()])


def _take_env(arr, idx):
    """Gather along the link axis with per-env indices.

    arr: [Eb, L, ...] (Eb in {1, E}), idx: [E, P] env-batched indices.
    """
    E = idx.shape[0]
    arr = arr.expand((E,) + arr.shape[1:])
    tail = arr.shape[2:]
    ix = idx.reshape(idx.shape + (1,) * len(tail)).expand(idx.shape + tail)
    return torch.gather(arr, 1, ix)


def forward_kinematics(spec: TreeSpec, state: TreeState) -> FK:
    """Compute world link poses and per-dof world axes/anchors.

    qpos entries are gathered per link via ``spec.dof_idx``; fixed links use a
    zero joint coordinate (branchless blend on ``joint_type``).
    """
    E = state.qpos.shape[0]
    L = spec.num_links
    D = spec.num_dofs
    dtype = state.qpos.dtype

    # q value per link (0 for fixed links).
    qlink = torch.gather(state.qpos, 1, spec.dof_idx.expand(E, L))  # [E, L]
    is_rev = (spec.joint_type == 1).to(dtype).expand(E, L)
    is_pris = (spec.joint_type == 2).to(dtype).expand(E, L)

    axis = spec.axis.expand(E, L, 3)
    origin_pos = spec.origin_pos.expand(E, L, 3)
    origin_quat = spec.origin_quat.expand(E, L, 4)

    # Joint motion in the joint frame: rotation about axis (revolute) and/or
    # translation along axis (prismatic); identity when fixed.
    jq = rot.quat_from_angle_axis(qlink * is_rev, axis)        # [E, L, 4]
    jt = axis * (qlink * is_pris)[..., None]                   # [E, L, 3]

    # Root link (index 0): its origin transform is applied relative to the
    # provided root pose (normally identity origin).
    p0, q0 = rot.transform_compose(
        state.root_pos, state.root_quat, origin_pos[:, 0], origin_quat[:, 0]
    )
    static_parents = _static_parents(spec)
    pos_l, quat_l = [p0], [q0]
    for l in range(1, L):
        if static_parents is not None:
            pi = max(static_parents[l], 0)
            pp, pq = pos_l[pi], quat_l[pi]
        else:
            pidx = torch.clamp(spec.parent.expand(E, L)[:, l], 0, l - 1)
            pp = _take_env(torch.stack(pos_l, 1), pidx[:, None])[:, 0]
            pq = _take_env(torch.stack(quat_l, 1), pidx[:, None])[:, 0]
        # joint frame in world
        jp, jqw = rot.transform_compose(pp, pq, origin_pos[:, l],
                                        origin_quat[:, l])
        # child link frame = joint frame ∘ (translation, rotation)
        pos_l.append(jp + rot.quat_rotate(jqw, jt[:, l]))
        quat_l.append(rot.quat_mul(jqw, jq[:, l]))
    link_pos = torch.stack(pos_l, 1)
    link_quat = torch.stack(quat_l, 1)

    # Per-dof world axis / anchor, gathered at the dof's child link.  The
    # child frame origin lies on the joint axis for revolute joints, and the
    # axis direction is invariant under the joint's own motion.
    dof_child = spec.dof_child.expand(E, D)
    child_quat = _take_env(link_quat, dof_child)          # [E, D, 4]
    dof_anchor = _take_env(link_pos, dof_child)           # [E, D, 3]
    axis_child = _take_env(axis, dof_child)               # [E, D, 3]
    dof_axis_w = rot.quat_rotate(child_quat, axis_child)

    return FK(link_pos=link_pos, link_quat=link_quat,
              dof_axis_w=dof_axis_w, dof_anchor_w=dof_anchor)


def _dof_kind(spec: TreeSpec, E: int):
    """[E, D] revolute / prismatic indicators, gathered per dof."""
    D = spec.num_dofs
    jt = spec.joint_type.expand(E, spec.num_links)
    child = spec.dof_child.expand(E, D)
    kind = torch.gather(jt, 1, child)
    dm = spec.dof_mask.expand(E, D)
    rev = (kind == 1).to(dm.dtype) * dm
    pris = (kind == 2).to(dm.dtype) * dm
    return rev, pris


def _columns(spec: TreeSpec, fk: FK, points_w, anc_p, E: int):
    """Linear and angular Jacobian columns of points moved by the dofs in
    ``anc_p``: ([E, P, D, 3], [E, P, D, 3])."""
    rev, pris = _dof_kind(spec, E)                       # [E, D]
    r = points_w[:, :, None, :] - fk.dof_anchor_w[:, None, :, :]  # [E,P,D,3]
    axis = fk.dof_axis_w[:, None, :, :]                  # [E, 1, D, 3]
    jv = (rot._cross(axis, r) * rev[:, None, :, None]
          + axis * pris[:, None, :, None]) * anc_p[..., None]
    jw = axis * (rev[:, None, :, None] * anc_p[..., None])
    return jv, jw


def point_jacobian(spec: TreeSpec, fk: FK, link_idx, points_w) -> torch.Tensor:
    """Linear Jacobian of world point(s) attached to link(s).

    Args:
        link_idx: i64 [E, P] link each point is attached to.
        points_w: f32 [E, P, 3] current world positions of the points.
    Returns:
        Jv: f32 [E, P, 3, D] with d(point)/d(qpos).
    """
    E = link_idx.shape[0]
    anc_p = _take_env(spec.ancestor, link_idx)          # [E, P, D]
    jv, _ = _columns(spec, fk, points_w, anc_p, E)
    return jv.transpose(-1, -2)                         # [E, P, 3, D]


def link_jacobians(spec: TreeSpec, fk: FK):
    """Full spatial Jacobians of every link's COM.

    Returns:
        Jv: [E, L, 3, D] linear Jacobian at the link COM (world frame)
        Jw: [E, L, 3, D] angular Jacobian (world frame)
        com_w: [E, L, 3] world COM positions
    """
    E = fk.link_pos.shape[0]
    L, D = spec.num_links, spec.num_dofs
    com_w = fk.link_pos + rot.quat_rotate(fk.link_quat,
                                          spec.com.expand(E, L, 3))
    anc = spec.ancestor.expand(E, L, D)
    jv, jw = _columns(spec, fk, com_w, anc, E)
    return jv.transpose(-1, -2), jw.transpose(-1, -2), com_w


def frame_jacobian(spec: TreeSpec, fk: FK, link_idx):
    """6×D spatial Jacobian [linear; angular] of link frame origins (the
    rows the damped least-squares IK uses).

    Args:
        link_idx: i64 [E, P]
    Returns:
        J: f32 [E, P, 6, D]
    """
    E = link_idx.shape[0]
    pts = _take_env(fk.link_pos, link_idx)              # [E, P, 3]
    anc_p = _take_env(spec.ancestor, link_idx)
    jv, jw = _columns(spec, fk, pts, anc_p, E)
    return torch.cat([jv.transpose(-1, -2), jw.transpose(-1, -2)], dim=-2)
