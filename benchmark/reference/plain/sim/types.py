"""Simulator state & specification containers (PyTorch).

Counterpart of ``partmanip_tpu/sim/types.py``.  All simulation state lives in
explicit ``NamedTuple``s of ``[num_envs, ...]`` tensors that thread through
the step functions.

Two kinds of simulated entities:

* ``Tree`` — a fixed-base articulation (the Franka).  Reduced coordinates
  ``qpos/qvel`` of size D; links padded to L with masks.
* ``FreeBody`` — a lone free rigid body (the cube), integrated with
  Newton-Euler directly.

All ``TreeSpec`` arrays carry a leading env axis that may be 1 (broadcast —
the robot is identical across envs) or ``num_envs``.  ``sim/builder.py`` emits
numpy arrays; :func:`to_device` turns a spec into tensors on the device
once, at env construction.
"""

from __future__ import annotations

import weakref
from typing import NamedTuple

import numpy as np
import torch
from torch import Tensor

# Joint type codes (branchless blending in kinematics keys off these).
JOINT_FIXED = 0
JOINT_REVOLUTE = 1
JOINT_PRISMATIC = 2


class TreeSpec(NamedTuple):
    """Static description of a fixed-base articulation, padded to (L, D).

    Topology arrays must satisfy ``parent[e, l] < l`` (topological order) so
    kinematics can sweep links once, in index order.
    """

    # --- per link, [E?, L] / [E?, L, k] ---
    parent: Tensor        # i32; parent link index, -1 for the root link
    joint_type: Tensor    # i32; JOINT_* code of the joint connecting to parent
    origin_pos: Tensor    # f32 [E?, L, 3]; joint frame origin in parent frame
    origin_quat: Tensor   # f32 [E?, L, 4]; joint frame rotation in parent frame
    axis: Tensor          # f32 [E?, L, 3]; joint axis in the child/joint frame
    dof_idx: Tensor       # i32; dof driving this link (valid iff joint_type>0)
    link_mask: Tensor     # f32; 1.0 for real links, 0.0 for padding
    mass: Tensor          # f32 [E?, L]
    com: Tensor           # f32 [E?, L, 3]; center of mass in link frame
    inertia: Tensor       # f32 [E?, L, 3, 3]; about com, in link frame

    # --- per dof, [E?, D] ---
    dof_child: Tensor     # i32; link whose joint this dof actuates
    dof_mask: Tensor      # f32; 1.0 for real dofs
    dof_lower: Tensor
    dof_upper: Tensor
    dof_vel_limit: Tensor
    dof_effort: Tensor    # drive force/torque limit
    dof_armature: Tensor
    dof_damping: Tensor   # intrinsic joint damping (not the drive's)
    dof_friction: Tensor  # Coulomb joint friction
    drive_kp: Tensor      # PD position-drive stiffness (0 = undriven)
    drive_kd: Tensor      # PD position-drive damping

    # --- misc ---
    ancestor: Tensor      # f32 [E?, L, D]; 1.0 iff dof d moves link l
    gravity_scale: Tensor  # f32 [E?]; 0.0 = gravity disabled for the asset

    @property
    def num_links(self) -> int:
        return self.parent.shape[-1]

    @property
    def num_dofs(self) -> int:
        return self.dof_mask.shape[-1]


class TreeState(NamedTuple):
    """Dynamic state of a fixed-base articulation, [E, ...]."""

    qpos: Tensor       # f32 [E, D]
    qvel: Tensor       # f32 [E, D]
    root_pos: Tensor   # f32 [E, 3]; world pose of the root link
    root_quat: Tensor  # f32 [E, 4]


class FreeBodySpec(NamedTuple):
    """A single free rigid body (box collision geometry)."""

    mass: Tensor          # f32 [E?]
    inertia: Tensor       # f32 [E?, 3, 3] about com, body frame
    half_extents: Tensor  # f32 [E?, 3] collision box half sizes
    gravity_scale: Tensor  # f32 [E?]
    friction: Tensor      # f32 [E?]


class FreeBodyState(NamedTuple):
    pos: Tensor      # f32 [E, 3]
    quat: Tensor     # f32 [E, 4] xyzw
    linvel: Tensor   # f32 [E, 3]
    angvel: Tensor   # f32 [E, 3] world frame


class SphereGeoms(NamedTuple):
    """Collision spheres attached to articulation links (robot side)."""

    link_idx: Tensor  # i32 [S]
    offset: Tensor    # f32 [S, 3] center in link frame
    radius: Tensor    # f32 [S]
    friction: Tensor  # f32 [S]
    sticky: Tensor    # f32 [S] 1.0 = stick-slip anchor friction (finger pads)


class BoxGeoms(NamedTuple):
    """Collision boxes attached to articulation links (object side)."""

    link_idx: Tensor   # i32 [E?, G]
    offset_pos: Tensor   # f32 [E?, G, 3]
    offset_quat: Tensor  # f32 [E?, G, 4]
    half_extents: Tensor  # f32 [E?, G, 3]
    geom_mask: Tensor    # f32 [E?, G]
    friction: Tensor     # f32 [E?, G]


class GridGeoms(NamedTuple):
    """Baked mesh-SDF collision geoms attached to articulation links.  The
    grids themselves live in a shared ``ops.sdf.GridStack``
    (``SceneSpec.grid_stack``); each geom references one by index."""

    link_idx: Tensor     # i32 [E?, K]
    grid_id: Tensor      # i32 [E?, K] index into the scene grid stack
    offset_pos: Tensor   # f32 [E?, K, 3] grid frame in link frame
    offset_quat: Tensor  # f32 [E?, K, 4]
    geom_mask: Tensor    # f32 [E?, K]
    friction: Tensor     # f32 [E?, K]


class SimParams(NamedTuple):
    """Global integration parameters."""

    dt: float = 1.0 / 60.0       # control-rate timestep
    substeps: int = 4
    inner_substeps: int = 4      # extra subdivision for contact stability
    gravity: float = -9.81
    contact_kn: float = 2.0e4    # penalty normal stiffness [N/m]
    contact_damping_ratio: float = 1.0
    contact_kt: float = 1.0e3    # tangential (friction) damping [N·s/m]
    contact_offset: float = 0.005  # activation distance
    max_depenetration_velocity: float = 1.0
    # Velocity-product (Coriolis/centrifugal + gyroscopic) terms of the tree
    # bias; the shipped configs run with them off.
    coriolis: bool = True
    # Kept so the merged configs of the two packages compare equal; in the
    # port CUDA tensors always go through the fused kernel.
    use_fused: bool = True

    @property
    def h(self) -> float:
        """Inner integration step."""
        return self.dt / (self.substeps * self.inner_substeps)


class FK(NamedTuple):
    """Forward-kinematics result for one articulation."""

    link_pos: Tensor    # f32 [E, L, 3]
    link_quat: Tensor   # f32 [E, L, 4]
    # Per-dof world quantities (gathered from the dof's child link):
    dof_axis_w: Tensor    # f32 [E, D, 3] joint axis in world
    dof_anchor_w: Tensor  # f32 [E, D, 3] a point on the joint axis (world)


def to_device(spec, device):
    """Turn the numpy leaves of a spec ``NamedTuple`` into tensors on
    ``device`` (i32 stays integer: int64 so it can index, f32 stays f32)."""
    def conv(x):
        if isinstance(x, torch.Tensor):
            return x.to(device)
        x = np.asarray(x)
        if np.issubdtype(x.dtype, np.integer):
            return torch.as_tensor(x.astype(np.int64), device=device)
        return torch.as_tensor(x.astype(np.float32), device=device)
    return type(spec)(*[conv(x) for x in spec])


class HostCache:
    """Host-side values derived from a spec tensor (python ints of a parent
    table, a mass as a float, a packed kernel argument), computed once per
    tensor so the step functions do not read the device back every call.
    Keyed by the tensor's identity; an entry dies with its tensor."""

    def __init__(self):
        self._entries = {}

    def get(self, tensor: Tensor, make):
        key = id(tensor)
        hit = self._entries.get(key)
        if hit is not None and hit[0]() is tensor:
            return hit[1]
        value = make()
        self._entries[key] = (
            weakref.ref(tensor, lambda _: self._entries.pop(key, None)), value)
        return value
