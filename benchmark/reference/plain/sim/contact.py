"""SDF penalty contacts + free rigid-body dynamics (PyTorch).

Counterpart of ``partmanip_tpu/sim/contact.py``: robot collision spheres
against analytic box SDFs and the ground plane.  Forces are regularized
Coulomb penalties, mapped into joint space via point Jacobians; the
normal/tangential damping also feeds the implicit solve blocks of
:mod:`dynamics` for stiff-stable integration.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..ops import rotations as rot
from ..ops.linalg import inv3
from . import kinematics
from .types import FreeBodySpec, FreeBodyState, SimParams, SphereGeoms, TreeSpec


def box_sdf(p: torch.Tensor, half: torch.Tensor):
    """Signed distance and outward normal of axis-aligned box(es) at local
    points p.  Branchless; correct inside and outside.

    Args:
        p: [..., 3] points in box frame.
        half: [..., 3] half extents.
    Returns:
        (dist [...], normal [..., 3] in box frame)
    """
    q = torch.abs(p) - half
    q_out = torch.clamp(q, min=0.0)
    d_out = torch.linalg.norm(q_out, dim=-1)
    q_max = torch.max(q, dim=-1, keepdim=True).values
    d_in = torch.clamp(q_max[..., 0], max=0.0)
    dist = d_out + d_in

    sgn = torch.where(p >= 0, 1.0, -1.0)
    n_out = sgn * q_out / torch.clamp(d_out, min=1e-9)[..., None]
    # inside: face of least penetration
    inside_face = (q == q_max).to(p.dtype)
    n_in = sgn * inside_face
    n_in = n_in / torch.clamp(
        torch.linalg.norm(n_in, dim=-1, keepdim=True), min=1e-9)
    outside = (d_out > 0)[..., None]
    normal = torch.where(outside, n_out, n_in)
    return dist, normal


class ContactSet(NamedTuple):
    """A batch of candidate contacts on robot spheres.

    All tensors [E, C, ...]; inactive entries masked by ``active``.
    """

    point: torch.Tensor    # world contact point (sphere center)
    normal: torch.Tensor   # world normal, pointing toward the sphere
    depth: torch.Tensor    # signed gap (negative = penetrating)
    active: torch.Tensor   # f32 mask
    sphere_idx: torch.Tensor  # i64 which robot sphere
    friction: torch.Tensor    # combined μ
    # velocity of the *other* body at the contact point (world)
    v_other: torch.Tensor


def _unit_z(like: torch.Tensor) -> torch.Tensor:
    n = torch.zeros_like(like)
    n[..., 2] = 1.0
    return n


def sphere_positions(spec: TreeSpec, fk, spheres: SphereGeoms, E: int):
    """World positions of robot collision spheres [E, S, 3]."""
    S = spheres.link_idx.shape[0]
    li = spheres.link_idx[None].expand(E, S)
    lp = kinematics._take_env(fk.link_pos, li)
    lq = kinematics._take_env(fk.link_quat, li)
    off = spheres.offset[None].expand(E, S, 3)
    return lp + rot.quat_rotate(lq, off)


def spheres_vs_ground(centers, radii, mu_s, ground_mu: float = 0.1):
    """Contacts of spheres against the z=0 plane (plane friction 0.1)."""
    E, S = centers.shape[:2]
    depth = centers[..., 2] - radii[None]
    return ContactSet(
        point=centers,
        normal=_unit_z(centers),
        depth=depth,
        active=centers.new_ones((E, S)),
        sphere_idx=torch.arange(S, device=centers.device)[None].expand(E, S),
        friction=(0.5 * (mu_s + ground_mu))[None].expand(E, S),
        v_other=torch.zeros_like(centers),
    )


def spheres_vs_boxes(
    centers, radii, mu_s,
    box_pos, box_quat, box_half, box_mask, box_mu,
    v_box_fn,
):
    """All-pairs sphere × box contacts.

    Args:
        centers: [E, S, 3]; radii, mu_s: [S]
        box_pos/quat/half/mask/mu: [E, G, ...] world box poses
        v_box_fn: callable(point [E, S, G, 3]) → velocity of box surface
            points [E, S, G, 3] (captures the owning body's state)
    Returns:
        ContactSet with C = S*G, plus the box index per contact [E, C].
    """
    E, S = centers.shape[:2]
    G = box_pos.shape[1]
    # sphere centers in each box frame
    rel = centers[:, :, None, :] - box_pos[:, None, :, :]          # [E,S,G,3]
    bq = box_quat[:, None].expand(E, S, G, 4)
    p_local = rot.quat_rotate_inverse(bq, rel)
    dist, n_local = box_sdf(p_local, box_half[:, None].expand(E, S, G, 3))
    n_world = rot.quat_rotate(bq, n_local)
    depth = dist - radii[None, :, None]

    pts = centers[:, :, None, :].expand(E, S, G, 3)
    v_other = v_box_fn(pts)

    dev = centers.device
    cs = ContactSet(
        point=pts.reshape(E, S * G, 3),
        normal=n_world.reshape(E, S * G, 3),
        depth=depth.reshape(E, S * G),
        active=box_mask[:, None].expand(E, S, G).reshape(E, S * G),
        sphere_idx=torch.arange(S, device=dev)[None, :, None].expand(
            E, S, G).reshape(E, S * G),
        friction=(0.5 * (mu_s[None, :, None] + box_mu[:, None, :])
                  ).reshape(E, S * G),
        v_other=v_other.reshape(E, S * G, 3),
    )
    box_idx = torch.arange(G, device=dev)[None, None].expand(
        E, S, G).reshape(E, S * G)
    return cs, box_idx


def penalty_forces(cs: ContactSet, v_self, params: SimParams, m_eff: float = 0.1,
                   tangential: bool = True, recede_damp: float = 0.0):
    """Regularized penalty contact forces, strictly dissipative per step.

    F = fn·n + ft with

    * spring   fn_k = max(0, −kn·φ), capped so one inner step cannot impart
      more than ``max_depenetration_velocity``;
    * damping  fn_d = cd·max(0, −vn), impulse-capped at m_eff·(−vn)/h so a
      discrete step can stop the approach but never reverse it (inelastic
      impact);
    * friction ft = −min(μ·fn, kt·|vt|, m_eff·|vt|/h)·t̂ with the same
      no-reversal cap.

    ``m_eff`` is the reduced mass of the pair (pass the lighter body's mass).
    Returns (force [E, C, 3], fn [E, C], active mask [E, C]).
    """
    kn = params.contact_kn
    h = params.h
    cd = 2.0 * params.contact_damping_ratio * math.sqrt(kn * m_eff)
    v_rel = v_self - cs.v_other
    vn = torch.sum(v_rel * cs.normal, dim=-1)
    vt = v_rel - vn[..., None] * cs.normal
    vt_norm = torch.linalg.norm(vt, dim=-1)

    touching = (cs.depth < 0.0).to(cs.depth.dtype) * cs.active
    # The impulse caps budget the *total* momentum change of the body, so
    # each of n simultaneous contacts gets 1/n of it — otherwise multiple
    # pads over-stop the body, reversing its velocity and pumping energy.
    n_act = torch.clamp(torch.sum(touching, dim=-1, keepdim=True), min=1.0)
    m_c = m_eff / n_act
    # velocity-anticipating spring: evaluate the penalty at the predicted
    # end-of-step gap φ + h·vn
    depth_pred = cs.depth + h * vn
    # The depenetration budget counts the already-achieved separation speed
    # (a cap on the total velocity depenetration may introduce, not a
    # per-inner-step increment).  While approaching (vn ≤ 0) this is
    # identical to the plain cap, so the change is strictly dissipative.
    depen_budget = torch.clamp(
        params.max_depenetration_velocity - torch.clamp(vn, min=0.0), min=0.0)
    fn_spring = torch.minimum(
        torch.clamp(-kn * torch.minimum(cs.depth, depth_pred), min=0.0),
        m_c * depen_budget / h,
    )
    approach = torch.clamp(-vn, min=0.0)
    fn_damp = torch.minimum(cd * approach, m_c * approach / h)
    # Recede damping (restitution → 0) for light FREE bodies: the damper is
    # impulse-capped so it can at most cancel the recede velocity (inelastic,
    # never sticky); gated off by default.
    recede = torch.clamp(vn, min=0.0)
    fn_rec = recede_damp * torch.minimum(cd * recede, m_c * recede / h)
    fn = torch.clamp(fn_spring + fn_damp - fn_rec, min=0.0) * touching
    if tangential:
        ft_mag = torch.minimum(
            torch.minimum(cs.friction * fn, params.contact_kt * vt_norm),
            m_c * vt_norm / h,
        )
        ft = -ft_mag[..., None] * vt / torch.clamp(vt_norm, min=1e-6)[..., None]
        force = fn[..., None] * cs.normal + ft
    else:
        # tangential handled by the stick-slip anchors (engine level)
        force = fn[..., None] * cs.normal
    return force, fn, touching


def integrate_free_body(
    spec: FreeBodySpec, state: FreeBodyState, force, torque, h: float,
    gravity: torch.Tensor,
):
    """Semi-implicit Newton-Euler step for a free rigid body (the cube)."""
    E = state.pos.shape[0]
    m = spec.mass.expand(E)[:, None]
    gscale = spec.gravity_scale.expand(E)[:, None]
    R = rot.quat_to_mat(state.quat)
    Iw = torch.einsum("eab,ebc,edc->ead", R, spec.inertia.expand(E, 3, 3), R)
    Iw_inv = inv3(Iw)

    linacc = force / m + gravity[None] * gscale
    gyro = rot._cross(state.angvel,
                      torch.einsum("eab,eb->ea", Iw, state.angvel))
    angacc = torch.einsum("eab,eb->ea", Iw_inv, torque - gyro)

    linvel = torch.clamp(state.linvel + h * linacc, -20.0, 20.0)
    angvel = torch.clamp(state.angvel + h * angacc, -50.0, 50.0)
    pos = state.pos + h * linvel
    dq = 0.5 * h * torch.cat([angvel, angvel.new_zeros((E, 1))], dim=-1)
    quat = rot.quat_unit(state.quat + rot.quat_mul(dq, state.quat))
    return FreeBodyState(pos=pos, quat=quat, linvel=linvel, angvel=angvel)


def free_body_point_velocity(state: FreeBodyState, points):
    """Velocity of world points rigidly attached to the body. points [E,...,3]."""
    shape = (state.pos.shape[0],) + (1,) * (points.ndim - 2) + (3,)
    r = points - state.pos.reshape(shape)
    return state.linvel.reshape(shape) + rot._cross(
        state.angvel.reshape(shape), r)


def box_corners(half: torch.Tensor, E: int):
    """The 8 corners of a box, body frame. half: [E?, 3] → [E, 8, 3]."""
    signs = torch.tensor(
        [[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)],
        dtype=torch.float32, device=half.device,
    )
    return signs[None] * half.expand(E, 3)[:, None, :]


class AnchorState(NamedTuple):
    """Per-sphere tangential stick anchors (static friction state).

    A spring-clutch: each sphere stores the contact point in its partner
    body's local frame; the tangential force is a stiff spring to that
    anchor, clamped to the friction cone with return mapping (sliding drags
    the anchor along).
    """

    point: torch.Tensor   # f32 [E, S, 3] anchor in partner-local coordinates
    body: torch.Tensor    # i32 [E, S] partner id (-1 none; engine-defined)


def init_anchors(E: int, S: int, device=None) -> AnchorState:
    return AnchorState(
        point=torch.zeros((E, S, 3), device=device),
        body=torch.full((E, S), -1, dtype=torch.int32, device=device))


ANCHOR_KS = 2.0e3       # tangential spring stiffness [N/m]
ANCHOR_ZETA = 1.0       # damping ratio of the tangential spring
# Per-inner-step velocity margin of the free-body-side anchor reaction cap
# (engine.py / the fused kernel): at perfect stick the tangential contact may
# still exert m·HOLD/h to hold a grasped body, but a sweep can only
# accelerate it to ~the finger's tangential speed.
FREE_BODY_HOLD_VEL = 0.05  # [m/s]


def anchor_friction(
    sphere_pos, sphere_vel, normal, fn, mu, touching, partner_id,
    anchor: AnchorState, to_local, to_world, partner_vel,
    params: SimParams, m_eff,
):
    """Stick-slip tangential forces for one sphere set.

    Args:
        sphere_pos/vel: [E, S, 3] current sphere state (world).
        normal, fn, mu, touching: [E, S(,3)] of the *selected* contact.
        partner_id: [E, S] i32 partner body id of the selected contact.
        anchor: previous AnchorState.
        to_local(points, pid): world → partner-local for the given partner.
        to_world(points, pid): partner-local → world.
        partner_vel: [E, S, 3] partner surface velocity at the sphere.
    Returns:
        (force [E, S, 3] to apply to the sphere, new AnchorState,
         stick mask [E, S]).
    """
    cdt = 2.0 * ANCHOR_ZETA * math.sqrt(ANCHOR_KS * m_eff)

    touch = touching > 0
    same = (anchor.body == partner_id) & (partner_id >= 0) & touch
    anchor_world = to_world(anchor.point, anchor.body)
    # tangential offset from the anchor (project out the current normal)
    delta = sphere_pos - anchor_world
    delta_t = delta - torch.sum(delta * normal, -1, keepdim=True) * normal
    v_rel = sphere_vel - partner_vel
    vt = v_rel - torch.sum(v_rel * normal, -1, keepdim=True) * normal

    ft_raw = -ANCHOR_KS * delta_t - cdt * vt
    ft_raw = torch.where(same[..., None], ft_raw, -cdt * vt * touch[..., None])
    ft_mag = torch.linalg.norm(ft_raw, dim=-1)
    limit = mu * fn
    stick = (ft_mag <= limit) & same
    scale = torch.where(
        ft_mag > 1e-9,
        torch.clamp(limit / torch.clamp(ft_mag, min=1e-9), max=1.0), 0.0)
    ft = ft_raw * scale[..., None]
    ft = ft * touch[..., None]

    # return mapping: when sliding, drag the anchor so the spring force
    # equals the clamped (cone-boundary) force
    slid_world = sphere_pos + ft / ANCHOR_KS
    new_world = torch.where(stick[..., None], anchor_world, slid_world)
    new_local = to_local(new_world, partner_id)
    new_anchor = AnchorState(
        point=torch.where(touch[..., None], new_local, anchor.point),
        body=torch.where(touch, partner_id, -1).to(anchor.body.dtype),
    )
    return ft, new_anchor, stick
