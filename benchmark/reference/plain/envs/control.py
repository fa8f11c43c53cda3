"""Franka task-space control (PyTorch).

Counterpart of ``partmanip_tpu/envs/control.py``: the drive modes ``ik``
(7(+3) actions), ``pos`` (8(+3)), ``ik_abs`` (8(+3)) and the debug
``heuristic`` servo, including

* action scaling: Δpose × 0.005, gripper × dt/5, mobile base × 0.005
  rotated into the root frame;
* damped least-squares IK with λ=0.05 on the mean of the two fingertip
  Jacobians, arm columns only;
* the per-step cached robot state: averaged tip rigid-body row, 9D tip
  rotation, gripper length, normalized qpos.

Everything is a plain function of (spec, fk, state).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import rotations as rot
from ..ops.linalg import spd_solve
from ..sim import engine, kinematics
from ..sim.types import TreeSpec, TreeState

IK_DAMPING = 0.05
POSE_ACTION_SCALE = 0.005
HEURISTIC_GRASP_POSE = (-0.2, 0.0, 0.4, -0.5, 0.5, 0.5, -0.5)


class RobotView(NamedTuple):
    """Per-step cached robot quantities."""

    tip_state: torch.Tensor       # [E, 13] mean of the two tip body rows
    ltip_state: torch.Tensor      # [E, 13]
    rtip_state: torch.Tensor      # [E, 13]
    tip_pos: torch.Tensor         # [E, 3]
    tip_rot: torch.Tensor         # [E, 3, 3]
    gripper_length: torch.Tensor  # [E]
    qpos_normalized: torch.Tensor  # [E, D]
    qpos: torch.Tensor            # [E, D]
    qvel: torch.Tensor            # [E, D]
    tip_jacobian: torch.Tensor    # [E, 6, n_arm] mean tip spatial Jacobian


class FrankaControlConfig(NamedTuple):
    drive_mode: str = "ik"
    mobile: bool = False
    dt: float = 1.0 / 60.0
    num_dofs: int = 9
    lefttip_idx: int = 0
    righttip_idx: int = 0
    root_quat: tuple = (0.0, 0.0, 0.0, 1.0)  # default root for base rotation

    @property
    def num_actions(self) -> int:
        base = {"ik": 7, "pos": 8, "ik_abs": 8, "heuristic": 1}[self.drive_mode]
        return base + (3 if self.mobile else 0)

    @property
    def nb(self) -> int:
        return 3 if self.mobile else 0


def robot_view(cfg: FrankaControlConfig, spec: TreeSpec, fk,
               state: TreeState) -> RobotView:
    E = state.qpos.shape[0]
    idx = torch.tensor([cfg.lefttip_idx, cfg.righttip_idx],
                       device=state.qpos.device).expand(E, 2)
    tips = engine.rigid_body_state(spec, fk, state, idx)  # [E, 2, 13]
    ltip, rtip = tips[:, 0], tips[:, 1]
    tip = 0.5 * (ltip + rtip)
    lower = spec.dof_lower.expand(state.qpos.shape)
    upper = spec.dof_upper.expand(state.qpos.shape)
    qn = 2.0 * (state.qpos - lower) / (upper - lower + 1e-12) - 1.0

    J = kinematics.frame_jacobian(spec, fk, idx)  # [E, 2, 6, D]
    j_eef = 0.5 * (J[:, 0] + J[:, 1])
    j_eef = j_eef[..., cfg.nb:cfg.num_dofs - 2]   # arm columns only

    return RobotView(
        tip_state=tip, ltip_state=ltip, rtip_state=rtip,
        tip_pos=tip[:, :3], tip_rot=rot.quat_to_mat(tip[:, 3:7]),
        gripper_length=torch.linalg.norm(ltip[:, :3] - rtip[:, :3], dim=-1),
        qpos_normalized=qn, qpos=state.qpos, qvel=state.qvel,
        tip_jacobian=j_eef,
    )


def solve_ik(j_eef: torch.Tensor, dpose: torch.Tensor) -> torch.Tensor:
    """Damped least-squares: u = Jᵀ (J Jᵀ + λ²I)⁻¹ dpose."""
    lmbda = (IK_DAMPING ** 2) * torch.eye(6, dtype=dpose.dtype,
                                          device=dpose.device)
    jt = j_eef.transpose(-1, -2)
    A = j_eef @ jt + lmbda
    return torch.einsum("...dk,...k->...d", jt, spd_solve(A, dpose))


def compute_targets(cfg: FrankaControlConfig, spec: TreeSpec,
                    view: RobotView, actions: torch.Tensor) -> torch.Tensor:
    """Map raw policy actions to PD position targets [E, D]."""
    E, D = view.qpos.shape
    nb = cfg.nb
    q = view.qpos
    targets = q.clone()   # filled in place below
    raw = actions

    dpose_base = q.new_zeros((E, 3))
    if cfg.mobile:
        dpose_base = raw[:, :3] * POSE_ACTION_SCALE
        root_r = rot.quat_to_mat(torch.tensor(cfg.root_quat, dtype=q.dtype,
                                              device=q.device))
        base_delta = torch.einsum("ba,eb->ea", root_r, dpose_base)  # Rᵀ·d
        targets[:, :3] = q[:, :3] + base_delta
        raw = raw[:, 3:]

    def ik_arm(dpose):
        u = solve_ik(view.tip_jacobian, dpose)
        targets[:, nb:-2] = q[:, nb:-2] + u

    if cfg.drive_mode == "pos":
        targets[:, nb:-2] = q[:, nb:-2] + raw[:, :-1] * cfg.dt * 20.0
        targets[:, -2:] = q[:, -2:] + raw[:, -1:] * cfg.dt
    elif cfg.drive_mode == "ik":
        pos_err = raw[:, :3] * POSE_ACTION_SCALE
        orn_err = raw[:, 3:6] * POSE_ACTION_SCALE
        # mobile: the commanded base translation is subtracted from the
        # task-space delta so arm IK solves only the residual (the
        # subtraction uses the *unrotated* delta).
        ik_arm(torch.cat([pos_err - dpose_base, orn_err], dim=-1))
        targets[:, -2:] = q[:, -2:] + raw[:, -1:] * cfg.dt / 5.0
    elif cfg.drive_mode == "ik_abs":
        pos_err = raw[:, :3] - view.tip_pos
        target_q = raw[:, 3:7] / (
            torch.linalg.norm(raw[:, 3:7], dim=-1, keepdim=True) + 1e-8)
        orn_err = rot.orientation_error(target_q, view.tip_state[:, 3:7])
        ik_arm(torch.cat([pos_err, orn_err], dim=-1))
        up = spec.dof_upper.expand(E, D)[:, -1]
        lo = spec.dof_lower.expand(E, D)[:, -1]
        targets[:, -2:] = (raw[:, -1:] * (up - lo)[:, None] / 2
                           + (up + lo)[:, None] / 2)
    elif cfg.drive_mode == "heuristic":
        gp = torch.tensor(HEURISTIC_GRASP_POSE, dtype=q.dtype, device=q.device)
        pos_err = gp[None, :3] - view.tip_pos
        orn_err = rot.orientation_error(
            gp[None, 3:7].expand(E, 4), view.tip_state[:, 3:7])
        ik_arm(torch.cat([pos_err, orn_err], dim=-1))
        targets[:, -2:] = q[:, -2:]
    else:
        raise NotImplementedError(cfg.drive_mode)

    lower = spec.dof_lower.expand(E, D)
    upper = spec.dof_upper.expand(E, D)
    return torch.clamp(targets, lower, upper)
