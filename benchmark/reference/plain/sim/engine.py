"""Scene-level physics step (PyTorch).

Counterpart of ``partmanip_tpu/sim/engine.py`` for scenes made of the
articulated robot, the ground, and either a free body (the cube) or an
articulated object with box collision geoms and, optionally, baked mesh-SDF
collision geoms (the cabinet; its mesh handles), with SDF penalty
contacts.  :func:`_inner_step` is the plain PyTorch version of the fused CUDA
kernels in :mod:`fused`: it runs when the state lies on the CPU and is what
the kernels are held against on the GPU.  State on a CUDA device always goes
through a kernel (:func:`physics_step`).

Per-contact quantities are aggregated **per collision sphere** (robot side)
and **per box wrench** (object side) before they touch a Jacobian; the
contact stiffness/damping enters the implicit solve as per-sphere 3×3 normal
operators N = Σ_c coef·n nᵀ with A += Jᵀ N J — algebraically exact.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ..ops import rotations as rot
from ..ops import sdf as sdf_ops
from . import contact, dynamics, kinematics
from .types import (BoxGeoms, FreeBodySpec, FreeBodyState, GridGeoms,
                    HostCache, SimParams, SphereGeoms, TreeSpec, TreeState)

# free-body masses as python floats (env 0), read to the host once
_MASS0 = HostCache()


def _mass0(fb: FreeBodySpec) -> float:
    return _MASS0.get(fb.mass, lambda: float(fb.mass.reshape(-1)[0]))


class SceneSpec(NamedTuple):
    robot: TreeSpec
    spheres: SphereGeoms
    params: SimParams
    obj_tree: Optional[TreeSpec] = None
    obj_boxes: Optional[BoxGeoms] = None
    free_body: Optional[FreeBodySpec] = None
    obj_grids: Optional[GridGeoms] = None
    grid_stack: Optional[object] = None


class SceneState(NamedTuple):
    robot: TreeState
    obj: Optional[TreeState] = None
    body: Optional[FreeBodyState] = None
    anchors: Optional[contact.AnchorState] = None  # stick-friction state


def check_supported(scene: SceneSpec) -> None:
    """Raise with the reason when the scene has a part without what it
    needs."""
    if (scene.obj_tree is None) != (scene.obj_boxes is None):
        raise NotImplementedError(
            "an articulated object needs both its tree and its collision "
            "boxes (obj_tree and obj_boxes); one without the other is not "
            "a scene the engine simulates")
    if (scene.obj_grids is None) != (scene.grid_stack is None):
        raise NotImplementedError(
            "mesh-SDF collision geoms (obj_grids) need their grid stack "
            "(grid_stack), and a grid stack its geoms; one without the other "
            "is not a scene the engine simulates")
    if scene.obj_grids is not None and scene.obj_tree is None:
        raise NotImplementedError(
            "mesh-SDF collision geoms (obj_grids) ride on an articulated "
            "object's tree; the scene has none")


def _nnT(normal, coef):
    """coef·n nᵀ per sphere → [E, S, 3, 3]."""
    return coef[..., None, None] * normal[..., :, None] * normal[..., None, :]


def obj_box_world(spec: TreeSpec, boxes: BoxGeoms, fk, E: int):
    """World poses of object collision boxes [E, G, ...]."""
    G = boxes.link_idx.shape[-1]
    li = boxes.link_idx.expand(E, G)
    lp = kinematics._take_env(fk.link_pos, li)
    lq = kinematics._take_env(fk.link_quat, li)
    return rot.transform_compose(lp, lq, boxes.offset_pos.expand(E, G, 3),
                                 boxes.offset_quat.expand(E, G, 4))


def _box_gather(x, g):
    """x [E, G, k] at per-(env, sphere) box indices g [E, S] → [E, S, k]."""
    return torch.gather(x, 1, g[..., None].expand(g.shape + x.shape[-1:]))


def _inner_step(scene: SceneSpec, state: SceneState, pos_targets, h,
                gravity, coriolis=True) -> SceneState:
    E = state.robot.qpos.shape[0]
    dev = state.robot.qpos.device
    p = scene.params
    rspec = scene.robot
    fk_r = kinematics.forward_kinematics(rspec, state.robot)
    M_r = dynamics.mass_matrix(rspec, fk_r, E)

    # robot collision spheres: world positions, per-sphere Jacobians, vels
    S = scene.spheres.link_idx.shape[0]
    centers = contact.sphere_positions(rspec, fk_r, scene.spheres, E)
    sphere_link = scene.spheres.link_idx[None].expand(E, S)
    Jp_s = kinematics.point_jacobian(rspec, fk_r, sphere_link, centers)
    v_s = torch.einsum("esad,ed->esa", Jp_s, state.robot.qvel)
    radii = scene.spheres.radius
    mu_s = scene.spheres.friction

    def imp_coef(touching, m_eff):
        cd = 2.0 * p.contact_damping_ratio * math.sqrt(p.contact_kn * m_eff)
        return touching * (h * cd + h * h * p.contact_kn)

    # Per-sphere best-partner bookkeeping for the stick-slip anchors:
    # partner ids: 0 ground, 1 cube, 2+g object box g, 2+G+k grid geom k.
    best_depth = torch.full((E, S), 1e9, device=dev)
    best = {
        "id": torch.full((E, S), -1, dtype=torch.int32, device=dev),
        "normal": torch.zeros((E, S, 3), device=dev),
        "fn": torch.zeros((E, S), device=dev),
        "mu": torch.zeros((E, S), device=dev),
        "touch": torch.zeros((E, S), device=dev),
        "pvel": torch.zeros((E, S, 3), device=dev),
    }

    def consider(depth, pid, normal, fn, mu, touch, pvel):
        nonlocal best_depth
        better = (depth < best_depth) & (touch > 0)
        best_depth = torch.where(better, depth, best_depth)
        best["id"] = torch.where(better, pid, best["id"])
        best["normal"] = torch.where(better[..., None], normal, best["normal"])
        best["fn"] = torch.where(better, fn, best["fn"])
        best["mu"] = torch.where(better, mu, best["mu"])
        best["touch"] = torch.maximum(best["touch"], touch * better)
        best["pvel"] = torch.where(better[..., None], pvel, best["pvel"])

    # 1) robot vs ground
    cs_g = contact.spheres_vs_ground(centers, radii, mu_s)
    f_g, fn_g, t_g = contact.penalty_forces(cs_g, v_s, p, 0.5)
    F_sphere = f_g
    N_sphere = _nnT(cs_g.normal, imp_coef(t_g, 0.5))
    consider(cs_g.depth, torch.zeros((E, S), dtype=torch.int32, device=dev),
             cs_g.normal, fn_g, cs_g.friction, t_g,
             torch.zeros((E, S, 3), device=dev))

    # 2) robot vs free body (cube)
    cube_wrench = None
    if scene.free_body is not None:
        fb = scene.free_body
        half = fb.half_extents.expand(E, 3)[:, None, :]
        cs_b, _ = contact.spheres_vs_boxes(
            centers, radii, mu_s,
            state.body.pos[:, None, :], state.body.quat[:, None, :],
            half, centers.new_ones((E, 1)), fb.friction.expand(E)[:, None],
            lambda pts: contact.free_body_point_velocity(
                state.body, pts.reshape(E, -1, 3)).reshape(pts.shape),
        )
        m_cube = _mass0(fb)
        f_b, fn_b, t_b = contact.penalty_forces(cs_b, v_s, p, m_cube,
                                                recede_damp=1.0)
        F_sphere = F_sphere + f_b
        N_sphere = N_sphere + _nnT(cs_b.normal, imp_coef(t_b, m_cube))
        # reaction wrench on the cube about its COM (normal part)
        r = cs_b.point - state.body.pos[:, None, :]
        cube_wrench = (-torch.sum(f_b, dim=1),
                       -torch.sum(rot._cross(r, f_b), dim=1))
        consider(cs_b.depth, torch.ones((E, S), dtype=torch.int32, device=dev),
                 cs_b.normal, fn_b, cs_b.friction, t_b,
                 contact.free_body_point_velocity(state.body, centers))

    # 3) robot vs articulated object boxes
    G = 0
    if scene.obj_tree is not None:
        ospec = scene.obj_tree
        fk_o = kinematics.forward_kinematics(ospec, state.obj)
        bp, bq = obj_box_world(ospec, scene.obj_boxes, fk_o, E)
        G = bp.shape[1]
        box_link = scene.obj_boxes.link_idx.expand(E, G)

        # per-box spatial jacobians at link origin → shifted to box center
        J6 = kinematics.frame_jacobian(ospec, fk_o, box_link)  # [E,G,6,Do]
        Jw_box = J6[:, :, 3:, :]
        r_box = bp - kinematics._take_env(fk_o.link_pos, box_link)
        # Jv at box center: Jv_o + Jw × r  (column-wise cross)
        Jv_box = J6[:, :, :3, :] + rot._cross(
            Jw_box.transpose(-1, -2), r_box[:, :, None, :]).transpose(-1, -2)
        qv_o = state.obj.qvel
        v_bc = torch.einsum("egad,ed->ega", Jv_box, qv_o)   # box center vel
        w_b = torch.einsum("egad,ed->ega", Jw_box, qv_o)    # box angular vel

        def v_box_fn(pts):  # pts [E, S, G, 3]
            r = pts - bp[:, None, :, :]
            return v_bc[:, None, :, :] + rot._cross(w_b[:, None, :, :], r)

        cs_o, _ = contact.spheres_vs_boxes(
            centers, radii, mu_s, bp, bq,
            scene.obj_boxes.half_extents.expand(E, G, 3),
            scene.obj_boxes.geom_mask.expand(E, G),
            scene.obj_boxes.friction.expand(E, G),
            v_box_fn,
        )
        vs_o = v_s[:, :, None, :].expand(E, S, G, 3).reshape(E, -1, 3)
        # one impulse budget over all S×G pairs of the env
        f_o, fn_o, t_o = contact.penalty_forces(cs_o, vs_o, p, 0.3)
        f_osg = f_o.reshape(E, S, G, 3)
        t_osg = t_o.reshape(E, S, G)
        n_osg = cs_o.normal.reshape(E, S, G, 3)
        # best box per sphere for the anchor bookkeeping (first minimum)
        d_sg = cs_o.depth.reshape(E, S, G)
        masked_d = torch.where(t_osg > 0, d_sg, 1e9)
        gbest = torch.argmin(masked_d, dim=-1)                 # [E, S]
        take = lambda a: torch.gather(
            a, 2, gbest.reshape(E, S, 1, *([1] * (a.ndim - 3))).expand(
                E, S, 1, *a.shape[3:]))[:, :, 0]
        fn_sg = fn_o.reshape(E, S, G)
        mu_sg = cs_o.friction.reshape(E, S, G)
        pv = cs_o.v_other.reshape(E, S, G, 3)
        consider(take(d_sg), (2 + gbest).to(torch.int32), take(n_osg),
                 take(fn_sg), take(mu_sg),
                 (take(masked_d) < 0).to(centers.dtype), take(pv))
        F_sphere = F_sphere + torch.sum(f_osg, dim=2)
        N_sphere = N_sphere + torch.einsum(
            "esg,esga,esgb->esab", imp_coef(t_osg, 0.3), n_osg, n_osg)

        # reaction on the object: per-box wrench about the box center
        rr = centers[:, :, None, :] - bp[:, None, :, :]
        F_box = -torch.sum(f_osg, dim=1)                     # [E, G, 3]
        T_box = -torch.sum(rot._cross(rr, f_osg), dim=1)     # [E, G, 3]
        tau_o = (torch.einsum("egad,ega->ed", Jv_box, F_box)
                 + torch.einsum("egad,ega->ed", Jw_box, T_box))
        N_box = torch.einsum("esg,esga,esgb->egab",
                             imp_coef(t_osg, 0.3), n_osg, n_osg)
        obj_reaction = (tau_o, Jv_box, N_box)

    # 3b) robot vs baked mesh-SDF geoms on the object tree.  Same penalty
    # and implicit treatment as the boxes, with an impulse budget of their
    # own; the trilinear gradient supplies the contact normal.
    KOFF = 2 + G                       # partner ids of grid geoms start here
    K = 0
    if scene.obj_grids is not None:
        gg = scene.obj_grids
        K = gg.link_idx.shape[-1]
        glink = gg.link_idx.expand(E, K)
        gp, gq = rot.transform_compose(
            kinematics._take_env(fk_o.link_pos, glink),
            kinematics._take_env(fk_o.link_quat, glink),
            gg.offset_pos.expand(E, K, 3), gg.offset_quat.expand(E, K, 4))
        J6g = kinematics.frame_jacobian(scene.obj_tree, fk_o, glink)
        Jw_g = J6g[:, :, 3:, :]
        r_gl = gp - kinematics._take_env(fk_o.link_pos, glink)
        Jv_g = J6g[:, :, :3, :] + rot._cross(
            Jw_g.transpose(-1, -2), r_gl[:, :, None, :]).transpose(-1, -2)
        qv_o = state.obj.qvel
        v_gc = torch.einsum("ekad,ed->eka", Jv_g, qv_o)
        w_g = torch.einsum("ekad,ed->eka", Jw_g, qv_o)

        relg = centers[:, :, None, :] - gp[:, None, :, :]       # [E,S,K,3]
        gq_b = gq[:, None].expand(E, S, K, 4)
        p_locg = rot.quat_rotate_inverse(gq_b, relg)
        gid = gg.grid_id.expand(E, K)[:, None, :].expand(E, S, K)
        val, grad = sdf_ops.grid_query_grad(scene.grid_stack, gid, p_locg,
                                            outside_value=1.0)
        gnorm = torch.linalg.norm(grad, dim=-1)
        n_locg = grad / torch.clamp(gnorm, min=1e-9)[..., None]
        n_g2 = rot.quat_rotate(gq_b, n_locg)                    # [E,S,K,3]
        depth_g2 = val - radii[None, :, None]
        v_og = v_gc[:, None] + rot._cross(w_g[:, None], relg)
        mu_g2 = 0.5 * (mu_s[None, :, None] + gg.friction.expand(E, K)[:, None, :])
        act_g2 = (gg.geom_mask.expand(E, K)[:, None, :]
                  * (gnorm > 1e-6).to(gnorm.dtype))
        cs_g2 = contact.ContactSet(
            point=centers[:, :, None, :].expand(E, S, K, 3).reshape(E, S * K, 3),
            normal=n_g2.reshape(E, S * K, 3),
            depth=depth_g2.reshape(E, S * K),
            active=act_g2.reshape(E, S * K),
            sphere_idx=torch.arange(S, device=dev)[None, :, None].expand(
                E, S, K).reshape(E, S * K),
            friction=mu_g2.reshape(E, S * K),
            v_other=v_og.reshape(E, S * K, 3),
        )
        vs_g2 = v_s[:, :, None, :].expand(E, S, K, 3).reshape(E, -1, 3)
        # one impulse budget over all S×K grid pairs of the env
        f_g2, fn_g2, t_g2 = contact.penalty_forces(cs_g2, vs_g2, p, 0.3)
        f_skc = f_g2.reshape(E, S, K, 3)
        t_skc = t_g2.reshape(E, S, K)
        F_sphere = F_sphere + torch.sum(f_skc, dim=2)
        N_sphere = N_sphere + torch.einsum(
            "esk,eska,eskb->esab", imp_coef(t_skc, 0.3), n_g2, n_g2)
        # best grid per sphere for the anchors (first minimum)
        masked_dk = torch.where(t_skc > 0, depth_g2, 1e9)
        kbest = torch.argmin(masked_dk, dim=-1)                 # [E, S]
        take_k = lambda a: torch.gather(
            a, 2, kbest.reshape(E, S, 1, *([1] * (a.ndim - 3))).expand(
                E, S, 1, *a.shape[3:]))[:, :, 0]
        consider(take_k(depth_g2), (KOFF + kbest).to(torch.int32),
                 take_k(n_g2), take_k(fn_g2.reshape(E, S, K)), take_k(mu_g2),
                 (take_k(masked_dk) < 0).to(centers.dtype), take_k(v_og))
        # reactions on the object through the grid-link Jacobians
        F_gr = -torch.sum(f_skc, dim=1)
        T_gr = -torch.sum(rot._cross(relg, f_skc), dim=1)
        tau_gr = (torch.einsum("ekad,eka->ed", Jv_g, F_gr)
                  + torch.einsum("ekad,eka->ed", Jw_g, T_gr))
        N_gr = torch.einsum("esk,eska,eskb->ekab",
                            imp_coef(t_skc, 0.3), n_g2, n_g2)
        tau_o0, Jv0, N0 = obj_reaction
        obj_reaction = (tau_o0 + tau_gr, torch.cat([Jv0, Jv_g], dim=1),
                        torch.cat([N0, N_gr], dim=1))

    # ---- stick-slip tangential friction via anchors ----
    anchors = state.anchors
    if anchors is None:
        anchors = contact.init_anchors(E, S, dev)

    def to_world(local, pid):
        out = local  # ground: identity
        if scene.free_body is not None:
            cube_w = (rot.quat_rotate(state.body.quat[:, None], local)
                      + state.body.pos[:, None])
            out = torch.where((pid == 1)[..., None], cube_w, out)
        if G > 0:
            g = torch.clamp(pid.long() - 2, 0, G - 1)
            box_w = (rot.quat_rotate(_box_gather(bq, g), local)
                     + _box_gather(bp, g))
            out = torch.where(((pid >= 2) & (pid < KOFF))[..., None],
                              box_w, out)
        if K > 0:
            k = torch.clamp(pid.long() - KOFF, 0, K - 1)
            grid_w = (rot.quat_rotate(_box_gather(gq, k), local)
                      + _box_gather(gp, k))
            out = torch.where((pid >= KOFF)[..., None], grid_w, out)
        return out

    def to_local(world, pid):
        out = world
        if scene.free_body is not None:
            cube_l = rot.quat_rotate_inverse(
                state.body.quat[:, None], world - state.body.pos[:, None])
            out = torch.where((pid == 1)[..., None], cube_l, out)
        if G > 0:
            g = torch.clamp(pid.long() - 2, 0, G - 1)
            box_l = rot.quat_rotate_inverse(_box_gather(bq, g),
                                            world - _box_gather(bp, g))
            out = torch.where(((pid >= 2) & (pid < KOFF))[..., None],
                              box_l, out)
        if K > 0:
            k = torch.clamp(pid.long() - KOFF, 0, K - 1)
            grid_l = rot.quat_rotate_inverse(_box_gather(gq, k),
                                             world - _box_gather(gp, k))
            out = torch.where((pid >= KOFF)[..., None], grid_l, out)
        return out

    sticky = scene.spheres.sticky[None].expand(E, S)
    ft, new_anchors, _ = contact.anchor_friction(
        centers, v_s, best["normal"], best["fn"], best["mu"],
        best["touch"] * sticky, best["id"], anchors, to_local, to_world,
        best["pvel"], p, 0.1)
    ft = ft * sticky[..., None]
    F_sphere = F_sphere + ft
    # implicit tangential operator (I − n nᵀ) for anchored spheres
    cdt = 2.0 * contact.ANCHOR_ZETA * math.sqrt(contact.ANCHOR_KS * 0.1)
    eye = torch.eye(3, device=dev).expand(E, S, 3, 3)
    P_t = eye - best["normal"][..., :, None] * best["normal"][..., None, :]
    N_sphere = N_sphere + ((h * cdt + h * h * contact.ANCHOR_KS)
                           * best["touch"][..., None, None] * P_t)

    # friction reactions to partners
    if scene.free_body is not None:
        is_cube = (best["id"] == 1).to(ft.dtype)[..., None]
        f_c, t_c = cube_wrench
        ftc = ft * is_cube
        # Velocity-matching cap on the cube-side reaction (the sphere side
        # keeps full stiction): friction may bring the free body to the
        # finger's tangential speed plus a small holding margin in one inner
        # step — enough to hold a grasped cube against gravity but never to
        # fling it.
        vrel = v_s - best["pvel"]
        vt_c = vrel - torch.sum(
            vrel * best["normal"], -1, keepdim=True) * best["normal"]
        m_cube_e = scene.free_body.mass.expand(E)[:, None]
        n_touch = torch.clamp(torch.sum(
            is_cube[..., 0] * best["touch"], -1, keepdim=True), min=1.0)
        cap = (m_cube_e / n_touch) * (
            torch.linalg.norm(vt_c, dim=-1)
            + contact.FREE_BODY_HOLD_VEL) / p.h
        mag = torch.linalg.norm(ftc, dim=-1)
        ftc = ftc * (torch.minimum(mag, cap)
                     / torch.clamp(mag, min=1e-9))[..., None]
        f_c = f_c - torch.sum(ftc, dim=1)
        t_c = t_c - torch.sum(
            rot._cross(centers - state.body.pos[:, None], ftc), dim=1)
        cube_wrench = (f_c, t_c)
    if G > 0:
        onehot = (best["id"][..., None] - 2 == torch.arange(
            G, device=dev)[None, None]).to(ft.dtype)           # [E, S, G]
        F_fric = -torch.einsum("esg,esa->ega", onehot, ft)
        r_sb = centers[:, :, None, :] - bp[:, None, :, :]
        T_fric = -torch.einsum("esg,esga->ega", onehot,
                               rot._cross(r_sb, ft[:, :, None, :]))
        tau_o_f, Jp_o, N_o = obj_reaction
        tau_o_f = tau_o_f + (torch.einsum("egad,ega->ed", Jv_box, F_fric)
                             + torch.einsum("egad,ega->ed", Jw_box, T_fric))
        obj_reaction = (tau_o_f, Jp_o, N_o)
    if K > 0:
        onehot_k = (best["id"][..., None] - KOFF == torch.arange(
            K, device=dev)[None, None]).to(ft.dtype)           # [E, S, K]
        F_fk = -torch.einsum("esk,esa->eka", onehot_k, ft)
        r_sk = centers[:, :, None, :] - gp[:, None, :, :]
        T_fk = -torch.einsum("esk,eska->eka", onehot_k,
                             rot._cross(r_sk, ft[:, :, None, :]))
        tau_o_f, Jp_o, N_o = obj_reaction
        tau_o_f = tau_o_f + (torch.einsum("ekad,eka->ed", Jv_g, F_fk)
                             + torch.einsum("ekad,eka->ed", Jw_g, T_fk))
        obj_reaction = (tau_o_f, Jp_o, N_o)

    implicit = dynamics.ImplicitBlocks(Jp=Jp_s, N=N_sphere)
    tau_r = torch.einsum("esad,esa->ed", Jp_s, F_sphere)

    robot_new = dynamics.step_tree(
        rspec, state.robot, fk_r, M_r, pos_targets, tau_r, h, gravity,
        implicit=implicit, coriolis=coriolis,
    )

    # --- object-side integration ---
    body_new = state.body
    if scene.free_body is not None:
        f_cube, torque_cube = cube_wrench
        # cube corners vs ground
        corners_l = contact.box_corners(scene.free_body.half_extents, E)
        corners_w = state.body.pos[:, None, :] + rot.quat_rotate(
            state.body.quat[:, None, :], corners_l)
        v_c = contact.free_body_point_velocity(state.body, corners_w)
        cs_c = contact.ContactSet(
            point=corners_w, normal=contact._unit_z(corners_w),
            depth=corners_w[..., 2],
            active=corners_w.new_ones((E, 8)),
            sphere_idx=torch.zeros((E, 8), dtype=torch.int64, device=dev),
            friction=(0.5 * (scene.free_body.friction + 0.1)
                      ).expand(E)[:, None].expand(E, 8),
            v_other=torch.zeros_like(corners_w),
        )
        force_c, _, _ = contact.penalty_forces(
            cs_c, v_c, p, _mass0(scene.free_body) / 4.0, recede_damp=1.0)
        f_cube = f_cube + torch.sum(force_c, dim=1)
        torque_cube = torque_cube + torch.sum(
            rot._cross(corners_w - state.body.pos[:, None, :], force_c), dim=1)
        # Net per-body contact Δv cap (a per-BODY budget of
        # max_depenetration_velocity): purely per-contact budgets still ring
        # when opposing stiff contacts squeeze the body.
        m_body = scene.free_body.mass.expand(E)[:, None]
        dv = torch.linalg.norm(f_cube, dim=-1, keepdim=True) * h / m_body
        dv_scale = torch.clamp(
            p.max_depenetration_velocity / torch.clamp(dv, min=1e-9), max=1.0)
        f_cube = f_cube * dv_scale
        # Scale the torque by the same factor: an uncapped contact torque
        # would re-convert to linear motion at the next contact.
        torque_cube = torque_cube * dv_scale
        body_new = contact.integrate_free_body(
            scene.free_body, state.body, f_cube, torque_cube, h, gravity)

    obj_new = state.obj
    if scene.obj_tree is not None:
        # the object is undriven: its own qpos is the drive target, so only
        # joint damping / friction and the contact reactions act on it
        ospec = scene.obj_tree
        tau_o, Jv_box, N_box = obj_reaction
        implicit_o = dynamics.ImplicitBlocks(Jp=Jv_box, N=N_box)
        M_o = dynamics.mass_matrix(ospec, fk_o, E)
        obj_new = dynamics.step_tree(
            ospec, state.obj, fk_o, M_o, state.obj.qpos, tau_o, h, gravity,
            implicit=implicit_o, coriolis=coriolis,
        )

    return SceneState(robot=robot_new, obj=obj_new, body=body_new,
                      anchors=new_anchors)


def physics_step(scene: SceneSpec, state: SceneState,
                 pos_targets) -> SceneState:
    """Advance one control step: substeps × inner_substeps inner steps with
    constant PD targets.

    The benchmark's frozen copy: the loop over :func:`_inner_step` on every
    device (no kernel)."""
    return plain_physics_step(scene, state, pos_targets)


def plain_physics_step(scene: SceneSpec, state: SceneState,
                       pos_targets, n_steps: Optional[int] = None
                       ) -> SceneState:
    """The plain PyTorch version of :func:`physics_step` on whatever device
    the state lies on: ``n_steps`` (default substeps × inner_substeps) calls
    of :func:`_inner_step`."""
    check_supported(scene)
    p = scene.params
    n = p.substeps * p.inner_substeps
    h = p.dt / n
    dev = state.robot.qpos.device
    gravity = torch.tensor([0.0, 0.0, p.gravity], device=dev)
    if state.anchors is None:
        S = scene.spheres.link_idx.shape[0]
        E = state.robot.qpos.shape[0]
        state = state._replace(anchors=contact.init_anchors(E, S, dev))
    for _ in range(n if n_steps is None else n_steps):
        state = _inner_step(scene, state, pos_targets, h, gravity, p.coriolis)
    return state


def rigid_body_state(spec: TreeSpec, fk, state: TreeState, link_idx):
    """13-dim rigid body state rows [pos, quat, linvel, angvel] for the
    requested links.

    link_idx: i64 [E, P]
    """
    J = kinematics.frame_jacobian(spec, fk, link_idx)  # [E, P, 6, D]
    vel = torch.einsum("epad,ed->epa", J, state.qvel)    # [E, P, 6]
    pos = kinematics._take_env(fk.link_pos, link_idx)
    quat = kinematics._take_env(fk.link_quat, link_idx)
    return torch.cat([pos, quat, vel[..., :3], vel[..., 3:]], dim=-1)
