"""Batched articulated rigid-body dynamics (PyTorch).

Counterpart of ``partmanip_tpu/sim/dynamics.py``.  Joint-space Lagrangian
formulation built from the world-frame link Jacobians of :mod:`kinematics`:

* mass matrix  ``M = Σ_l m_l Jv_lᵀ Jv_l + Jw_lᵀ I_l^w Jw_l``;
* velocity-product (Coriolis/centrifugal + gyroscopic) and gravity bias,
  the velocity-product term in closed form (:func:`bias_forces`), checked
  against a forward-mode JVP through FK (:func:`bias_forces_jvp`);
* stable high-gain PD position drives via implicit integration
  (Tan et al., "Stable Proportional-Derivative Controllers"), with drive
  effort clamping;
* Coulomb joint friction / damping / armature.

Contacts enter as explicit generalized forces plus optional implicit
damping/stiffness blocks assembled by :mod:`engine`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..ops import rotations as rot
from ..ops.linalg import spd_solve
from . import kinematics
from .types import TreeSpec, TreeState

# Stiction linearization velocity (m/s or rad/s): below this, Coulomb
# friction acts as implicit viscous damping (exact linearization of the
# clipped-friction law).
_FRICTION_VEPS = 1e-3

# Brake-early factor of the saturated-drive switching curve (see step_tree):
# < 1 starts decelerating before the diagonal-mass time-optimal point, which
# absorbs the error of neglecting the off-diagonal inertia coupling.
_BRAKE_BETA = 0.25

# Floor of the saturated-drive velocity boundary layer (rad/s resp. m/s):
# the implicit servo slope is capped at effort/_SAT_VEPS for very heavy or
# weak dofs where one substep's velocity quantum effort·h/M is below this.
_SAT_VEPS = 1e-2


def mass_matrix(spec: TreeSpec, fk, E: int) -> torch.Tensor:
    """Joint-space inertia matrix [E, D, D] (+armature, padded-dof identity)."""
    jv, jw, _ = kinematics.link_jacobians(spec, fk)  # [E, L, 3, D]
    L = spec.num_links
    mass = (spec.mass * spec.link_mask).expand(E, L)
    # world-frame rotational inertia per link: R I Rᵀ
    Rm = rot.quat_to_mat(fk.link_quat)  # [E, L, 3, 3]
    I_l = spec.inertia.expand(E, L, 3, 3)
    Iw = torch.einsum("elab,elbc,eldc->elad", Rm, I_l, Rm)
    M = torch.einsum("el,elad,elaf->edf", mass, jv, jv)
    M = M + torch.einsum("elad,elab,elbf->edf", jw, Iw, jw)
    dm = spec.dof_mask.expand(E, spec.num_dofs)
    arm = spec.dof_armature.expand(dm.shape)
    return M + torch.diag_embed(arm * dm + (1.0 - dm))


def bias_forces(spec: TreeSpec, state: TreeState, gravity: torch.Tensor,
                coriolis: bool = True, fk=None) -> torch.Tensor:
    """Generalized bias τ_bias with  M q̈ = τ_applied − τ_bias.

    τ_bias = C(q, q̇) q̇ + g(q).  The velocity-product term uses the analytic
    time-derivative of the world-frame Jacobian columns,

        for dof d with world axis a_d, anchor p_d on child link c(d):
            ȧ_d = ω_{c(d)} × a_d
            revolute  col:  d/dt [a_d × (x − p_d)] = ȧ_d × (x − p_d)
                                                     + a_d × (ẋ − ṗ_d)
            prismatic col:  d/dt a_d = ȧ_d

    closed-form and branch-free; :func:`bias_forces_jvp` is the same term by
    a JVP through the FK sweep, kept for the tests.
    """
    E, D = state.qpos.shape
    L = spec.num_links
    if fk is None:
        fk = kinematics.forward_kinematics(spec, state)
    jv, jw, com_w = kinematics.link_jacobians(spec, fk)
    mass = (spec.mass * spec.link_mask).expand(E, L)
    # gravity: τ_g = Σ_l Jvᵀ m g  (scaled per articulation; gravity_scale 0
    # disables it, as for the robot)
    gscale = spec.gravity_scale.expand(E)
    g_force = mass[..., None] * gravity[None, None, :] * gscale[:, None, None]
    tau = -torch.einsum("elad,ela->ed", jv, g_force)

    if coriolis:
        qv = state.qvel
        v = torch.einsum("elad,ed->ela", jv, qv)        # link COM lin vel
        w = torch.einsum("elad,ed->ela", jw, qv)        # link ang vel
        Rm = rot.quat_to_mat(fk.link_quat)
        Iw = torch.einsum("elab,elbc,eldc->elad", Rm,
                          spec.inertia.expand(E, L, 3, 3), Rm)
        rev, pris = kinematics._dof_kind(spec, E)             # [E, D]
        dof_child = spec.dof_child.expand(E, D)
        w_c = kinematics._take_env(w, dof_child)              # [E, D, 3]
        # anchor (child link origin) velocities via its own jacobian rows
        j_anchor = kinematics.frame_jacobian(spec, fk, dof_child)  # [E,D,6,Dq]
        v_anchor = torch.einsum("edaf,ef->eda", j_anchor[:, :, :3], qv)
        a = fk.dof_axis_w                                     # [E, D, 3]
        adot = rot._cross(w_c, a)

        anc = spec.ancestor.expand(E, L, D)
        r = com_w[:, :, None, :] - fk.dof_anchor_w[:, None, :, :]   # [E,L,D,3]
        dv = v[:, :, None, :] - v_anchor[:, None, :, :]             # [E,L,D,3]
        col_rev = rot._cross(adot[:, None], r) + rot._cross(a[:, None], dv)
        jdotv = ((col_rev * rev[:, None, :, None]
                  + adot[:, None] * pris[:, None, :, None])
                 * anc[..., None] * qv[:, None, :, None]).sum(dim=2)  # [E,L,3]
        jdotw = (adot[:, None] * (rev * qv)[:, None, :, None]
                 * anc[..., None]).sum(dim=2)                         # [E,L,3]

        gyro = rot._cross(w, torch.einsum("elab,elb->ela", Iw, w))
        tau = tau + torch.einsum("elad,ela->ed", jv, mass[..., None] * jdotv)
        tau = tau + torch.einsum(
            "elad,ela->ed", jw,
            torch.einsum("elab,elb->ela", Iw, jdotw) + gyro)
    return tau * spec.dof_mask.expand(E, D)


def bias_forces_jvp(spec: TreeSpec, state: TreeState, gravity: torch.Tensor,
                    coriolis: bool = True) -> torch.Tensor:
    """Autodiff (JVP-through-FK, ``torch.func.jvp``) version of
    :func:`bias_forces`, used only by the tests to cross-check the analytic
    velocity-product terms."""
    E, D = state.qpos.shape
    L = spec.num_links

    def link_vels(qpos):
        st = state._replace(qpos=qpos)
        fk = kinematics.forward_kinematics(spec, st)
        jv, jw, _ = kinematics.link_jacobians(spec, fk)
        v = torch.einsum("elad,ed->ela", jv, state.qvel)
        w = torch.einsum("elad,ed->ela", jw, state.qvel)
        return v, w

    fk = kinematics.forward_kinematics(spec, state)
    jv, jw, _ = kinematics.link_jacobians(spec, fk)
    w = torch.einsum("elad,ed->ela", jw, state.qvel)
    mass = (spec.mass * spec.link_mask).expand(E, L)
    Rm = rot.quat_to_mat(fk.link_quat)
    Iw = torch.einsum("elab,elbc,eldc->elad", Rm,
                      spec.inertia.expand(E, L, 3, 3), Rm)
    gscale = spec.gravity_scale.expand(E)
    g_force = mass[..., None] * gravity[None, None, :] * gscale[:, None, None]
    tau = -torch.einsum("elad,ela->ed", jv, g_force)
    if coriolis:
        _, (vdot_b, wdot_b) = torch.func.jvp(link_vels, (state.qpos,),
                                             (state.qvel,))
        gyro = rot._cross(w, torch.einsum("elab,elb->ela", Iw, w))
        tau = tau + torch.einsum("elad,ela->ed", jv, mass[..., None] * vdot_b)
        tau = tau + torch.einsum(
            "elad,ela->ed", jw,
            torch.einsum("elab,elb->ela", Iw, wdot_b) + gyro)
    return tau * spec.dof_mask.expand(E, D)


class ImplicitBlocks(NamedTuple):
    """Extra implicit contact terms for the joint-space solve, aggregated per
    attachment point: point Jacobians Jp [E, P, 3, D] and 3×3 normal
    operators N [E, P, 3, 3] (N already carries its h·cd + h²·kn factors),
    contributing  A += Σ_p Jpᵀ N Jp."""

    Jp: torch.Tensor
    N: torch.Tensor


def step_tree(
    spec: TreeSpec,
    state: TreeState,
    fk,
    M: torch.Tensor,
    pos_targets: torch.Tensor,
    tau_ext: torch.Tensor,
    h: float,
    gravity: torch.Tensor,
    implicit: Optional[ImplicitBlocks] = None,
    coriolis: bool = True,
) -> TreeState:
    """One semi-implicit integration step of a driven articulation.

    Solves (M + h·D_imp + h²·K_imp) q̈ = τ_drive + τ_fric + τ_ext − τ_bias,
    then  q̇ ← clip(q̇ + h q̈),  q ← clip(q + h q̇)  with joint limits.
    """
    E, D = state.qpos.shape
    q, qv = state.qpos, state.qvel
    dm = spec.dof_mask.expand(E, D)
    kp = spec.drive_kp.expand(E, D)
    kd = spec.drive_kd.expand(E, D)
    effort = spec.dof_effort.expand(E, D)
    fric = spec.dof_friction.expand(E, D)
    damping = spec.dof_damping.expand(E, D)

    # PD drive torque, linearized implicitly:
    #   τ(q⁺, q̇⁺) ≈ τ₀ − (h²·kp + h·kd)·q̈   with   τ₀ = kp(q* − q − h q̇) − kd q̇
    tau_d0 = kp * (pos_targets - q - h * qv) - kd * qv

    # Coulomb joint friction, linearized to viscous inside |q̇| < veps.
    tau_fric = -fric * torch.clamp(qv / _FRICTION_VEPS, -1.0, 1.0)
    d_fric = fric / _FRICTION_VEPS * (torch.abs(qv) < _FRICTION_VEPS)

    bias = bias_forces(spec, state, gravity, coriolis=coriolis, fk=fk)

    def assemble(unsat, b_extra=0.0):
        diag = (h * (kd * unsat + b_extra + damping + d_fric)
                + (h * h) * (kp * unsat))
        A = M + torch.diag_embed(diag * dm)
        if implicit is not None:
            A = A + torch.einsum(
                "epad,epab,epbf->edf", implicit.Jp, implicit.N, implicit.Jp)
        return A

    # Pass 1: fully implicit (ignore effort limits), then read off the
    # end-of-step drive torque each dof would need.  Deciding saturation from
    # the *implicit* torque (not τ₀) avoids bang-bang chatter at the limit.
    ones = torch.ones_like(q)
    rhs1 = (tau_d0 + tau_fric + tau_ext - bias) * dm
    qacc1 = spd_solve(assemble(ones), rhs1) * dm
    tau_imp = tau_d0 - (h * h * kp + h * kd) * qacc1
    sat = (torch.abs(tau_imp) > effort).to(q.dtype)
    unsat = 1.0 - sat

    # Pass 2: saturated dofs run an effort-limited velocity servo toward the
    # time-optimal approach speed
    #     v*(err) = sign(err)·min(vel_limit, |err|/h, √(2·β·a_max·|err|)),
    #     a_max   = effort / M_d   (M_d = the dof's true diagonal inertia),
    # applied as the *implicit* servo  τ_sat(q̇⁺) = b·(v* − q̇⁺)  with the
    # adaptive slope  b = effort / max(|v*−q̇|, ε): |τ| = effort at the
    # linearization point, q̇⁺ lands monotonically between q̇ and v*, and as
    # |v*−q̇| → ε the servo becomes a hard velocity constraint.  Unsaturated
    # dofs stay fully implicit (clipped-PD semantics unchanged where the
    # clamp is inactive).
    M_diag = torch.diagonal(M, dim1=-2, dim2=-1)
    vel_lim = spec.dof_vel_limit.expand(E, D)
    a_max = effort / torch.clamp(M_diag, min=1e-9)
    err = pos_targets - q
    v_opt = torch.sign(err) * torch.minimum(
        vel_lim, torch.minimum(torch.abs(err) / h,
                               torch.sqrt(2.0 * _BRAKE_BETA * a_max
                                          * torch.abs(err))))
    dv = v_opt - qv
    b_imp = sat * effort / torch.clamp(torch.abs(dv), min=_SAT_VEPS)
    tau_drive = b_imp * dv + unsat * tau_d0
    rhs = (tau_drive + tau_fric + tau_ext - bias) * dm
    qacc = spd_solve(assemble(unsat, b_imp), rhs) * dm

    qv_new = torch.clamp(qv + h * qacc, -vel_lim, vel_lim)
    q_new = q + h * qv_new
    lower = spec.dof_lower.expand(E, D)
    upper = spec.dof_upper.expand(E, D)
    q_clamped = torch.clamp(q_new, lower, upper)
    # kill velocity into an active limit
    at_lo = (q_new < lower) & (qv_new < 0)
    at_hi = (q_new > upper) & (qv_new > 0)
    qv_new = torch.where(at_lo | at_hi, 0.0, qv_new) * dm
    return state._replace(qpos=q_clamped * dm, qvel=qv_new)
