"""Hand-made contact-rich grasp_cube states for checking the physics step.

Random policies rarely touch the cube, so a check that only rolls the env
compares free motion.  These states put every contact branch of the inner
step to work at once:

* even envs — the cube pinched **in the air** between the closed finger pads
  (pad ↔ cube contacts, anchors on the cube, friction reaction on the cube);
* odd envs — the robot lowered so the finger pads press into the **ground**
  with the cube resting on the ground between them (sphere ↔ ground, sphere ↔
  cube, cube corner ↔ ground, both partners competing per sphere).

Everything is numpy in the ``[E, ...]`` layout both packages share, made from
a seed, so the same arrays can be handed to either.
"""

from __future__ import annotations

import numpy as np
import torch

from ..sim import kinematics
from ..sim.types import TreeState

FINGER_GAP = 0.024     # per-finger opening: pads 1 mm into the 5 cm cube
LOWERED_ROOT_Z = -0.247  # puts the two lowest pad spheres into the ground


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
    tips = 0.5 * (lp[:, env.ctrl.lefttip_idx] + lp[:, env.ctrl.righttip_idx])
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


def touching_counts(env, state) -> dict:
    """How many (env, sphere) pairs touch each partner in a ``SceneState`` of
    the port, and how many anchors are attached to each: the evidence that a
    check on these states exercises the contact branches."""
    from ..ops import rotations as rot
    from ..sim import contact
    E = state.robot.qpos.shape[0]
    fk = kinematics.forward_kinematics(env.scene.robot, state.robot)
    centers = contact.sphere_positions(env.scene.robot, fk, env.spheres, E)
    radii = env.spheres.radius
    ground = (centers[..., 2] - radii[None]) < 0
    p_local = rot.quat_rotate_inverse(
        state.body.quat[:, None], centers - state.body.pos[:, None])
    dist, _ = contact.box_sdf(
        p_local, env.scene.free_body.half_extents.expand(E, 3)[:, None])
    cube = (dist - radii[None]) < 0
    return {"ground": int(ground.sum()), "cube": int(cube.sum()),
            "anchors_on_ground": int((state.anchors.body == 0).sum()),
            "anchors_on_cube": int((state.anchors.body == 1).sum())}
