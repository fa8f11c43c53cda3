"""Hand-made contact-rich states for checking the physics step.

Random policies rarely touch the cube or the cabinet, so a check that only
rolls the env compares free motion.  These states put every contact branch
of the inner step to work at once.

grasp_cube (:func:`grasp_contact_states`):

* even envs — the cube pinched **in the air** between the closed finger pads
  (pad ↔ cube contacts, anchors on the cube, friction reaction on the cube);
* odd envs — the robot lowered so the finger pads press into the **ground**
  with the cube resting on the ground between them (sphere ↔ ground, sphere ↔
  cube, cube corner ↔ ground, both partners competing per sphere).

open_drawer (:func:`drawer_contact_states`), by ``env % 4``:

* 0 — the gripper centred **inside** the handle bar;
* 1 — a finger pad centred where the bar meets its stand-off post
  (a sphere touching two boxes at once);
* 2 — the gripper pushed through the bar toward the drawer front (bar and
  front panel at once);
* 3 — the robot lowered until its finger pads press into the **ground**;
* 4 (mesh-handle scenes only, ``env % 5``) — a finger pad hooked just
  behind the bar's **back face** (toward the panel), overlapping it by
  0.8 of its radius: the SDF gradient there is along the drawer axis, so
  the contact pulls the drawer (the case of the JAX package's
  ``tests/test_mesh_collision.py``).  On a mesh handle kinds 0-2 put
  spheres inside and against the mesh bar, kind 1 on a post box as well.

The fingers close onto the bar (each pad 1 mm into it along the finger
separation axis, or fully open where the bar is longer than the grip).

open_drawer with grasp_cube's free cube beside the cabinet
(:func:`body_drawer_contact_states`, the scene of kernel B1e): the states
above, and the cube placed by the same kinds:

* 0-2 and 4 — resting 2 mm deep on the hand's first sphere (that sphere
  touches the cube, the pads the handle);
* 3, every other one of them — on the ground, 0.5 mm into it, its side
  6 mm into the lowest finger pad, which also presses 2 mm into the ground:
  the pad chooses the cube (the deeper partner) and its anchor goes into
  the cube's frame; the others as kinds 0-2 (their pads keep the ground).

Everything is numpy in the ``[E, ...]`` layout both packages share, made from
a seed, so the same arrays can be handed to either.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from ..sim import contact, kinematics
from ..sim.types import TreeState

FINGER_GAP = 0.024     # per-finger opening: pads 1 mm into the 5 cm cube
LOWERED_ROOT_Z = -0.247  # puts the two lowest pad spheres into the ground
FINGER_OPEN = 0.04     # finger joint limit (m per finger)
PAD_OFFSET = 0.01      # pad centre to gripper centre, fingers closed (m)


def grasp_contact_states(env, num_envs: int, seed: int):
    """Returns ``(state, targets)``: ``state`` as the nested numpy dict of
    ``utils.convert.scene_state_from_numpy``, ``targets`` f32 [E, D].

    ``env`` is a ``GraspCubeEnv`` of the port (any device); only its specs
    and defaults are read.
    """
    rs = np.random.RandomState(seed)
    E, D = num_envs, env.default_dof.shape[0]
    S = env.spheres.link_idx.shape[0]
    half = float(env.scene.free_body.half_extents.reshape(-1)[0])

    qpos = np.tile(env.default_dof, (E, 1)).astype(np.float32)
    qpos[:, :D - 2] += rs.uniform(-0.002, 0.002, (E, D - 2))
    qpos[:, D - 2:] = FINGER_GAP
    root_pos = np.tile(env.default_root[:3], (E, 1)).astype(np.float32)
    root_quat = np.tile(env.default_root[3:7]
                        / np.linalg.norm(env.default_root[3:7]),
                        (E, 1)).astype(np.float32)
    on_ground = (np.arange(E) % 2) == 1
    root_pos[on_ground, 2] = LOWERED_ROOT_Z

    # midpoint of the pads: mean of the two tip frames, moved back along the
    # fingers to the middle of the pad column
    dev = env.scene.robot.parent.device
    t = lambda x: torch.as_tensor(x, device=dev)
    fk = kinematics.forward_kinematics(
        env.scene.robot,
        TreeState(qpos=t(qpos), qvel=t(np.zeros_like(qpos)),
                  root_pos=t(root_pos), root_quat=t(root_quat)))
    lp = fk.link_pos.cpu().numpy()
    ltip, rtip = lp[:, env.ctrl.lefttip_idx], lp[:, env.ctrl.righttip_idx]
    tips = 0.5 * (ltip + rtip)
    sep = (ltip - rtip) / np.linalg.norm(ltip - rtip, axis=-1, keepdims=True)
    bpos = tips.copy()
    bpos[:, 2] += 0.0125                       # pads span ~0.040 above the tip
    bpos[on_ground, 2] = half - 0.0005         # resting, 0.5 mm into the ground
    bpos += rs.uniform(-0.0005, 0.0005, (E, 3))
    yaw = rs.uniform(-0.02, 0.02, E)
    bquat = np.stack([np.zeros(E), np.zeros(E), np.sin(yaw / 2),
                      np.cos(yaw / 2)], -1)

    state = {
        "robot": {"qpos": qpos,
                  "qvel": rs.uniform(-0.05, 0.05, (E, D)),
                  "root_pos": root_pos, "root_quat": root_quat},
        "body": {"pos": bpos, "quat": bquat,
                 "linvel": rs.uniform(-0.05, 0.05, (E, 3)),
                 "angvel": rs.uniform(-0.2, 0.2, (E, 3))},
        "anchors": {"point": np.zeros((E, S, 3)),
                    "body": np.full((E, S), -1)},
    }
    state = {k: {kk: np.asarray(vv, np.int32 if kk == "body" and k == "anchors"
                                else np.float32)
                 for kk, vv in v.items()} for k, v in state.items()}
    targets = qpos + rs.uniform(-0.02, 0.02, (E, D)).astype(np.float32)
    targets[:, D - 2:] = 0.0                   # keep squeezing
    return state, targets.astype(np.float32)


def drawer_contact_states(env, num_envs: int, seed: int):
    """Returns ``(state, targets)`` for an ``OpenDrawerEnv`` of the port
    (any device; only its specs and defaults are read): ``state`` as the
    nested numpy dict of ``utils.convert.scene_state_from_numpy`` (robot,
    obj, anchors), ``targets`` f32 [E, D].  ``num_envs`` must be the env's
    own count (the cabinet differs per env)."""
    rs = np.random.RandomState(seed)
    E, D = num_envs, env.default_dof.shape[0]
    if E != env.num_envs:
        raise ValueError(f"{E} states for an env of {env.num_envs}")
    S = env.spheres.link_idx.shape[0]
    dev = env.scene.robot.parent.device
    t = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
    o = env.scene.obj_tree
    Do = o.dof_mask.shape[-1]
    upper = o.dof_upper.cpu().numpy()
    obj = {"qpos": (upper * rs.uniform(0.0, 0.3, (E, Do))).astype(np.float32),
           "qvel": rs.uniform(-0.05, 0.05, (E, Do)) * o.dof_mask.cpu().numpy(),
           "root_pos": (np.tile(env._obj_default_pos_t.cpu().numpy(), (E, 1))
                        + rs.uniform(-0.02, 0.02, (E, 3))),
           "root_quat": np.tile(env._obj_default_quat_t.cpu().numpy(), (E, 1))}
    obj = {k: np.asarray(v, np.float32) for k, v in obj.items()}

    qpos = np.tile(env.default_dof, (E, 1)).astype(np.float32)
    qpos[:, :D - 2] += rs.uniform(-0.002, 0.002, (E, D - 2))
    root_pos = np.tile(env.default_root[:3], (E, 1)).astype(np.float32)
    root_quat = np.tile(env.default_root[3:7]
                        / np.linalg.norm(env.default_root[3:7]),
                        (E, 1)).astype(np.float32)
    fk = kinematics.forward_kinematics(
        env.scene.robot,
        TreeState(qpos=t(qpos), qvel=t(np.zeros_like(qpos)),
                  root_pos=t(root_pos), root_quat=t(root_quat)))
    lp = fk.link_pos.cpu().numpy()
    ltip, rtip = lp[:, env.ctrl.lefttip_idx], lp[:, env.ctrl.righttip_idx]
    tips = 0.5 * (ltip + rtip)
    sep = (ltip - rtip) / np.linalg.norm(ltip - rtip, axis=-1, keepdims=True)

    # handle frame of each env's cabinet (only sim.obj is read)
    bbox = env._part_bbox(SimpleNamespace(obj=TreeState(
        *[t(obj[k]) for k in TreeState._fields])))
    out, long, short, mid, ol, ll, sl = (x.cpu().numpy()
                                         for x in env._handle_axes(bbox))
    # close the fingers onto the bar: each pad 1 mm into the bar, measured
    # from the bar's centre along the finger separation axis
    half_ext = np.min(np.stack([
        0.5 * ext / np.maximum(np.abs(np.sum(sep * ax, -1)), 1e-6)
        for ext, ax in ((ll, long), (sl, short), (ol, out))]), axis=0)
    pad_r = float(env.spheres.radius[env.spheres.sticky > 0].max())
    pad_q = half_ext + pad_r - 0.001 - PAD_OFFSET
    qpos[:, D - 2:] = np.clip(pad_q, 0.0, FINGER_OPEN)[:, None]
    has_grids = env.scene.obj_grids is not None
    kind = np.arange(E) % (5 if has_grids else 4)
    goal = mid.copy()
    goal[kind == 2] -= 1.5 * ol[kind == 2, None] * out[kind == 2]
    goal += rs.uniform(-0.002, 0.002, (E, 3))
    root_pos += (goal - tips).astype(np.float32)
    fk = kinematics.forward_kinematics(
        env.scene.robot,
        TreeState(qpos=t(qpos), qvel=t(np.zeros_like(qpos)),
                  root_pos=t(root_pos), root_quat=t(root_quat)))
    centers = contact.sphere_positions(env.scene.robot, fk, env.spheres, E)
    pads = env.spheres.sticky.cpu().numpy() > 0
    # kind 1: the first finger pad's centre where the bar's back face meets
    # its stand-off post (posts sit 0.01 in from the bar ends, generator
    # geometry at obj_scale 0.5)
    junction = (mid + (0.5 * ll - 0.01)[:, None] * long
                - 0.5 * ol[:, None] * out)
    pad0 = centers[:, int(np.argmax(pads))].cpu().numpy()
    shift = junction - pad0 + rs.uniform(-0.001, 0.001, (E, 3))
    root_pos[kind == 1] += shift[kind == 1].astype(np.float32)
    # kind 4: the first finger pad 0.2 of its radius beyond the bar's back
    # face, mid-bar
    hook = mid - (0.5 * ol + 0.2 * pad_r)[:, None] * out
    shift = hook - pad0 + rs.uniform(-0.001, 0.001, (E, 3))
    root_pos[kind == 4] += shift[kind == 4].astype(np.float32)
    # kind 3: the lowest finger pad 2 mm into the ground
    bottom = (centers[..., 2] - env.spheres.radius[None]).cpu().numpy()
    pad_bottom = bottom[:, pads].min(1)
    root_pos[kind == 3, 2] -= pad_bottom[kind == 3] + 0.002

    state = {
        "robot": {"qpos": qpos,
                  "qvel": rs.uniform(-0.05, 0.05, (E, D)),
                  "root_pos": root_pos, "root_quat": root_quat},
        "obj": obj,
        "anchors": {"point": np.zeros((E, S, 3)),
                    "body": np.full((E, S), -1)},
    }
    state = {k: {kk: np.asarray(vv, np.int32 if kk == "body" and k == "anchors"
                                else np.float32)
                 for kk, vv in v.items()} for k, v in state.items()}
    targets = qpos + rs.uniform(-0.02, 0.02, (E, D)).astype(np.float32)
    targets[:, D - 2:] = 0.0                   # keep squeezing
    return state, targets.astype(np.float32)


def body_drawer_contact_states(env, free_body, num_envs: int, seed: int):
    """Returns ``(state, targets)`` for an ``OpenDrawerEnv`` of the port
    with ``free_body`` (grasp_cube's cube spec) added to its scene:
    :func:`drawer_contact_states` plus the cube's ``"body"`` part, placed as
    the module docstring says, with small random velocities."""
    state, targets = drawer_contact_states(env, num_envs, seed)
    rs = np.random.RandomState(seed + 1)
    E = num_envs
    dev = env.scene.robot.parent.device
    t = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
    half = float(free_body.half_extents.reshape(-1)[0])
    fk = kinematics.forward_kinematics(
        env.scene.robot, TreeState(*[t(state["robot"][k]) for k in TreeState._fields]))
    centers = contact.sphere_positions(env.scene.robot, fk, env.spheres, E).cpu().numpy()
    radius = env.spheres.radius.cpu().numpy()
    links = env.spheres.link_idx.cpu().numpy()
    hand = int(np.argmax(links == env.built.link_index["panda_hand"]))
    pos = centers[:, hand] + np.array([0.0, 0.0, half + radius[hand] - 0.002])
    n_kinds = 5 if env.scene.obj_grids is not None else 4
    kind = np.arange(E) % n_kinds
    kind[(np.arange(E) // n_kinds) % 2 == 1] = -1     # every other kind 3: cube on the hand
    pads = np.flatnonzero(env.spheres.sticky.cpu().numpy() > 0)
    low = pads[np.argmin(centers[:, pads, 2] - radius[pads], axis=1)]      # [E]
    pad_c = centers[np.arange(E), low]
    beside = pad_c + (half + radius[low] - 0.006)[:, None] * np.array([1.0, 0.0, 0.0])
    beside[:, 2] = half - 0.0005
    pos[kind == 3] = beside[kind == 3]
    yaw = rs.uniform(-0.3, 0.3, E)
    state["body"] = {
        "pos": pos.astype(np.float32),
        "quat": np.stack([np.zeros(E), np.zeros(E), np.sin(yaw / 2),
                          np.cos(yaw / 2)], -1).astype(np.float32),
        "linvel": rs.uniform(-0.02, 0.02, (E, 3)).astype(np.float32),
        "angvel": rs.uniform(-0.1, 0.1, (E, 3)).astype(np.float32)}
    return state, targets


def sphere_box_depths(env, state):
    """Signed depth of every (env, sphere, object box) pair of a
    ``SceneState`` with an articulated object, [E, S, G] (+inf for inactive
    boxes)."""
    import math
    from ..ops import rotations as rot
    from ..sim import engine
    scene = env.scene
    E = state.robot.qpos.shape[0]
    fk = kinematics.forward_kinematics(scene.robot, state.robot)
    centers = contact.sphere_positions(scene.robot, fk, env.spheres, E)
    fk_o = kinematics.forward_kinematics(scene.obj_tree, state.obj)
    bp, bq = engine.obj_box_world(scene.obj_tree, scene.obj_boxes, fk_o, E)
    G, S = bp.shape[1], centers.shape[1]
    p_local = rot.quat_rotate_inverse(bq[:, None].expand(E, S, G, 4),
                                      centers[:, :, None] - bp[:, None])
    dist, _ = contact.box_sdf(
        p_local, scene.obj_boxes.half_extents.expand(E, G, 3)[:, None])
    depth = dist - env.spheres.radius[None, :, None]
    active = scene.obj_boxes.geom_mask.expand(E, G)[:, None] > 0
    return torch.where(active, depth, torch.full_like(depth, math.inf))


def _grid_queries(env, state):
    """(depth, active, inside), each [E, S, K], of every (env, sphere,
    mesh-SDF geom) pair of a ``SceneState`` as the engine computes them:
    ``active`` = unmasked geom with a gradient norm > 1e-6, ``inside`` =
    unmasked geom and a query inside its grid's interior cells (where the
    trilinear lookup loads its 8 cells)."""
    from ..ops import rotations as rot
    from ..ops import sdf as sdf_ops
    scene = env.scene
    gg = scene.obj_grids
    E = state.robot.qpos.shape[0]
    K = gg.link_idx.shape[-1]
    fk = kinematics.forward_kinematics(scene.robot, state.robot)
    centers = contact.sphere_positions(scene.robot, fk, env.spheres, E)
    S = centers.shape[1]
    fk_o = kinematics.forward_kinematics(scene.obj_tree, state.obj)
    glink = gg.link_idx.expand(E, K)
    gp, gq = rot.transform_compose(
        kinematics._take_env(fk_o.link_pos, glink),
        kinematics._take_env(fk_o.link_quat, glink),
        gg.offset_pos.expand(E, K, 3), gg.offset_quat.expand(E, K, 4))
    p_loc = rot.quat_rotate_inverse(gq[:, None].expand(E, S, K, 4),
                                    centers[:, :, None] - gp[:, None])
    val, grad = sdf_ops.grid_query_grad(
        scene.grid_stack, gg.grid_id.expand(E, K)[:, None].expand(E, S, K),
        p_loc, outside_value=1.0)
    depth = val - env.spheres.radius[None, :, None]
    live = gg.geom_mask.expand(E, K)[:, None] > 0
    # grids hold values within ±trunc < 1, so 1.0 marks a query outside
    return (depth, live & (torch.linalg.norm(grad, dim=-1) > 1e-6),
            live & (val != 1.0))


def touching_counts(env, state) -> dict:
    """How many (env, sphere) pairs touch each partner in a ``SceneState`` of
    the port, and how many anchors are attached to each: the evidence that a
    check on these states exercises the contact branches.  For a scene with
    an articulated object: spheres touching a box, spheres touching two or
    more boxes at once, touching (sphere, box) pairs; with mesh-SDF geoms
    also spheres touching a grid geom, touching (sphere, grid) pairs, the
    queries that land inside their grid (what the kernel's lookups load) and
    the anchors on grid geoms (partner ids from 2 + G on); with a free body
    the spheres touching it and the anchors on it (partner id 1)."""
    from ..ops import rotations as rot
    E = state.robot.qpos.shape[0]
    fk = kinematics.forward_kinematics(env.scene.robot, state.robot)
    centers = contact.sphere_positions(env.scene.robot, fk, env.spheres, E)
    radii = env.spheres.radius
    ground = (centers[..., 2] - radii[None]) < 0
    counts = {"ground": int(ground.sum()),
              "anchors_on_ground": int((state.anchors.body == 0).sum())}
    if env.scene.obj_tree is not None:
        touch = sphere_box_depths(env, state) < 0
        per_sphere = touch.sum(-1)
        koff = 2 + env.scene.obj_boxes.link_idx.shape[-1]
        body = state.anchors.body
        counts.update(boxes=int((per_sphere > 0).sum()),
                      two_boxes=int((per_sphere > 1).sum()),
                      box_pairs=int(touch.sum()),
                      anchors_on_boxes=int(((body >= 2) & (body < koff)).sum()))
        if env.scene.obj_grids is not None:
            depth, active, inside = _grid_queries(env, state)
            touch_g = active & (depth < 0)
            counts.update(grids=int((touch_g.sum(-1) > 0).sum()),
                          grid_pairs=int(touch_g.sum()),
                          grid_queries_inside=int(inside.sum()),
                          anchors_on_grids=int((body >= koff).sum()))
    if env.scene.free_body is None:          # no cube
        return counts
    p_local = rot.quat_rotate_inverse(
        state.body.quat[:, None], centers - state.body.pos[:, None])
    dist, _ = contact.box_sdf(
        p_local, env.scene.free_body.half_extents.expand(E, 3)[:, None])
    cube = (dist - radii[None]) < 0
    counts.update(cube=int(cube.sum()),
                  anchors_on_cube=int((state.anchors.body == 1).sum()))
    return counts

