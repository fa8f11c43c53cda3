"""Host-side articulation builder: link/joint lists → packed ``TreeSpec``.

Counterpart of ``partmanip_tpu/sim/builder.py`` (numpy only, framework
neutral).  Asset generators emit :class:`LinkDef` lists; this module packs
them into rectangular numpy arrays (padding heterogeneous objects to a common
L/D).  ``sim.types.to_device`` turns the result into tensors.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from .types import (
    JOINT_FIXED,
    JOINT_PRISMATIC,
    JOINT_REVOLUTE,
    TreeSpec,
)


def _rpy_to_quat(rpy) -> np.ndarray:
    """URDF rpy → xyzw quat (R = Rz @ Ry @ Rx)."""
    r, p, y = rpy
    cr, sr = np.cos(r / 2), np.sin(r / 2)
    cp, sp = np.cos(p / 2), np.sin(p / 2)
    cy, sy = np.cos(y / 2), np.sin(y / 2)
    return np.array(
        [
            sr * cp * cy - cr * sp * sy,
            cr * sp * cy + sr * cp * sy,
            cr * cp * sy - sr * sp * cy,
            cr * cp * cy + sr * sp * sy,
        ]
    )


@dataclasses.dataclass
class LinkDef:
    """One link plus the joint connecting it to its parent."""

    name: str
    parent: Optional[str] = None          # None for the root link
    joint_type: int = JOINT_FIXED
    origin_pos: Sequence[float] = (0.0, 0.0, 0.0)
    origin_rpy: Sequence[float] = (0.0, 0.0, 0.0)
    origin_quat: Optional[Sequence[float]] = None  # overrides rpy if set
    axis: Sequence[float] = (0.0, 0.0, 1.0)
    lower: float = 0.0
    upper: float = 0.0
    vel_limit: float = 1e9
    effort: float = 1e9
    damping: float = 0.0       # intrinsic joint damping
    friction: float = 0.0
    armature: float = 0.0
    mass: float = 0.0
    com: Sequence[float] = (0.0, 0.0, 0.0)
    # Diagonal inertia about com in link frame (full matrix also accepted).
    inertia: Sequence[float] = (0.0, 0.0, 0.0)
    joint_name: str = ""


@dataclasses.dataclass
class BuiltTree:
    """numpy TreeSpec plus name→index maps (host-side convenience)."""

    spec: TreeSpec
    link_index: dict
    dof_index: dict
    dof_names: list


def build_tree(
    links: List[LinkDef],
    pad_links: Optional[int] = None,
    pad_dofs: Optional[int] = None,
) -> BuiltTree:
    """Pack a LinkDef list (root first, parents before children) into a
    TreeSpec with a singleton env axis. DOFs are numbered in link order,
    matching Isaac's asset dof ordering."""
    names = [l.name for l in links]
    assert len(set(names)) == len(names), "duplicate link names"
    link_index = {n: i for i, n in enumerate(names)}
    assert links[0].parent is None, "first link must be the root"

    L = pad_links or len(links)
    assert L >= len(links)
    parent = np.full(L, -1, np.int32)
    joint_type = np.zeros(L, np.int32)
    origin_pos = np.zeros((L, 3), np.float32)
    origin_quat = np.tile(np.array([0, 0, 0, 1], np.float32), (L, 1))
    axis = np.tile(np.array([0, 0, 1], np.float32), (L, 1))
    dof_idx = np.zeros(L, np.int32)
    link_mask = np.zeros(L, np.float32)
    mass = np.zeros(L, np.float32)
    com = np.zeros((L, 3), np.float32)
    inertia = np.zeros((L, 3, 3), np.float32)

    dof_list = []  # (link idx, LinkDef)
    dof_index = {}
    dof_names = []
    for i, l in enumerate(links):
        if l.parent is not None:
            p = link_index[l.parent]
            assert p < i, f"parent {l.parent} must precede {l.name}"
            parent[i] = p
        joint_type[i] = l.joint_type
        origin_pos[i] = l.origin_pos
        origin_quat[i] = (
            np.asarray(l.origin_quat) if l.origin_quat is not None
            else _rpy_to_quat(l.origin_rpy)
        )
        a = np.asarray(l.axis, np.float64)
        n = np.linalg.norm(a)
        axis[i] = a / n if n > 0 else [0, 0, 1]
        link_mask[i] = 1.0
        mass[i] = l.mass
        com[i] = l.com
        ine = np.asarray(l.inertia, np.float64)
        inertia[i] = np.diag(ine) if ine.ndim == 1 else ine
        if l.joint_type != JOINT_FIXED:
            dof_idx[i] = len(dof_list)
            dof_index[l.joint_name or l.name] = len(dof_list)
            dof_names.append(l.joint_name or l.name)
            dof_list.append((i, l))

    D = pad_dofs or max(len(dof_list), 1)
    assert D >= len(dof_list)
    dof_child = np.zeros(D, np.int32)
    dof_mask = np.zeros(D, np.float32)
    dof_lower = np.zeros(D, np.float32)
    dof_upper = np.zeros(D, np.float32)
    dof_vel_limit = np.full(D, 1e9, np.float32)
    dof_effort = np.full(D, 1e9, np.float32)
    dof_armature = np.zeros(D, np.float32)
    dof_damping = np.zeros(D, np.float32)
    dof_friction = np.zeros(D, np.float32)
    drive_kp = np.zeros(D, np.float32)
    drive_kd = np.zeros(D, np.float32)
    for d, (i, l) in enumerate(dof_list):
        dof_child[d] = i
        dof_mask[d] = 1.0
        dof_lower[d] = l.lower
        dof_upper[d] = l.upper
        dof_vel_limit[d] = l.vel_limit
        dof_effort[d] = l.effort
        dof_armature[d] = l.armature
        dof_damping[d] = l.damping
        dof_friction[d] = l.friction

    # ancestor[l, d]: does dof d move link l?  Walk each link to the root.
    ancestor = np.zeros((L, D), np.float32)
    for i in range(len(links)):
        j = i
        while j >= 0:
            if joint_type[j] != JOINT_FIXED:
                ancestor[i, dof_idx[j]] = 1.0
            j = parent[j]

    def env1(x):
        return x[None]

    spec = TreeSpec(
        parent=env1(parent),
        joint_type=env1(joint_type),
        origin_pos=env1(origin_pos),
        origin_quat=env1(origin_quat.astype(np.float32)),
        axis=env1(axis.astype(np.float32)),
        dof_idx=env1(dof_idx),
        link_mask=env1(link_mask),
        mass=env1(mass),
        com=env1(com),
        inertia=env1(inertia),
        dof_child=env1(dof_child),
        dof_mask=env1(dof_mask),
        dof_lower=env1(dof_lower),
        dof_upper=env1(dof_upper),
        dof_vel_limit=env1(dof_vel_limit),
        dof_effort=env1(dof_effort),
        dof_armature=env1(dof_armature),
        dof_damping=env1(dof_damping),
        dof_friction=env1(dof_friction),
        drive_kp=env1(drive_kp),
        drive_kd=env1(drive_kd),
        ancestor=env1(ancestor),
        gravity_scale=np.ones(1, np.float32),
    )
    return BuiltTree(spec=spec, link_index=link_index, dof_index=dof_index,
                     dof_names=dof_names)


def stack_trees(trees: List[TreeSpec]) -> TreeSpec:
    """Stack per-env specs (each env axis 1) into one [E, ...] spec.
    All must share (L, D) padding."""
    return TreeSpec(*[np.concatenate(arrs, axis=0) for arrs in zip(*trees)])
