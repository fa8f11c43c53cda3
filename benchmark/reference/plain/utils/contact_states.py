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

