"""The open_drawer task's state observation and reward, written for the
benchmark from the task's definitions (PartManip ``open_drawer``: the
fingertips' rigid-body rows, the handle's box, ``compute_reward``), apart
from the port and from the frozen copy in ``reference/plain``.

The mobile Franka's forward kinematics is a chain of 4x4 transforms built
from its URDF joint table (``franka_panda_sdf_mobile.urdf``), computed in
float64; the fingertips' linear and angular velocities are the time
derivative of their poses along ``qvel`` (``torch.func.jvp``), not a
Jacobian.  The cabinet's per-env data (the handle's box in the cabinet's
frame at a closed drawer, the drawer's axis and joint, its limits) is read
from the reference's own generated cabinets.

``observe`` gives, from a captured scene state, the 53 numbers of
``normal_state`` and the reward; ``gaps`` holds the program's against them.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

SUC_PROP = 0.5               # the share of the drawer's travel that counts as open

# The mobile base: three prismatic joints along the root's x, y, z.
BASE_LIMITS = ((-0.2, 0.2), (-0.2, 0.2), (-0.1, 0.1))
# The arm: (origin xyz, origin rpy, lower, upper) of panda_joint1..7, each
# turning about its own z.
ARM = (
    ((0.0, 0.0, 0.333), (0.0, 0.0, 0.0), -2.8973, 2.8973),
    ((0.0, 0.0, 0.0), (-math.pi / 2, 0.0, 0.0), -1.7628, 1.7628),
    ((0.0, -0.316, 0.0), (math.pi / 2, 0.0, 0.0), -2.8973, 2.8973),
    ((0.0825, 0.0, 0.0), (math.pi / 2, 0.0, 0.0), -3.0718, -0.0698),
    ((-0.0825, 0.384, 0.0), (-math.pi / 2, 0.0, 0.0), -2.8973, 2.8973),
    ((0.0, 0.0, 0.0), (math.pi / 2, 0.0, 0.0), -0.0175, 3.7525),
    ((0.088, 0.0, 0.0), (math.pi / 2, 0.0, 0.0), -2.8973, 2.8973),
)
HAND = ((0.0, 0.0, 0.107), (0.0, 0.0, -math.pi / 4))
FINGER_Z, FINGER_LIMITS, TIP_Z = 0.0584, (0.0, 0.04), 0.0445
QUAT = slice(3, 7)           # the tip quaternion's place in normal_state


def dof_limits(dtype=torch.float64, device="cpu"):
    lims = [*BASE_LIMITS, *[(lo, up) for *_, lo, up in ARM], FINGER_LIMITS, FINGER_LIMITS]
    t = torch.tensor(lims, dtype=dtype, device=device)
    return t[:, 0], t[:, 1]


def _rot(axis: str, a: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(a), torch.sin(a)
    o, z = torch.ones_like(a), torch.zeros_like(a)
    rows = {"x": ((o, z, z), (z, c, -s), (z, s, c)),
            "y": ((c, z, s), (z, o, z), (-s, z, c)),
            "z": ((c, -s, z), (s, c, z), (z, z, o))}[axis]
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def _rpy(rpy, like: torch.Tensor) -> torch.Tensor:
    """URDF rpy: R = Rz(yaw) Ry(pitch) Rx(roll)."""
    r, p, y = (torch.tensor(v, dtype=like.dtype, device=like.device) for v in rpy)
    return _rot("z", y) @ _rot("y", p) @ _rot("x", r)


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """xyzw unit quaternion → rotation matrix."""
    q = q / q.norm(dim=-1, keepdim=True)
    x, y, z, w = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], -1),
        torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], -1),
        torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


def matrix_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix → xyzw quaternion (its sign is not compared)."""
    m = R
    t = torch.stack([1 + m[..., 0, 0] - m[..., 1, 1] - m[..., 2, 2],
                     1 - m[..., 0, 0] + m[..., 1, 1] - m[..., 2, 2],
                     1 - m[..., 0, 0] - m[..., 1, 1] + m[..., 2, 2],
                     1 + m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2]], -1)
    k = t.argmax(-1, keepdim=True)          # the largest component, computed first
    x = torch.stack([t[..., 0], m[..., 0, 1] + m[..., 1, 0], m[..., 0, 2] + m[..., 2, 0],
                     m[..., 2, 1] - m[..., 1, 2]], -1)
    y = torch.stack([m[..., 0, 1] + m[..., 1, 0], t[..., 1], m[..., 1, 2] + m[..., 2, 1],
                     m[..., 0, 2] - m[..., 2, 0]], -1)
    z = torch.stack([m[..., 0, 2] + m[..., 2, 0], m[..., 1, 2] + m[..., 2, 1], t[..., 2],
                     m[..., 1, 0] - m[..., 0, 1]], -1)
    w = torch.stack([m[..., 2, 1] - m[..., 1, 2], m[..., 0, 2] - m[..., 2, 0],
                     m[..., 1, 0] - m[..., 0, 1], t[..., 3]], -1)
    q = torch.gather(torch.stack([x, y, z, w], -2), -2,
                     k[..., None].expand(*k.shape[:-1], 1, 4))[..., 0, :]
    return q / q.norm(dim=-1, keepdim=True)


def fingertips(qpos: torch.Tensor, root_pos: torch.Tensor, root_R: torch.Tensor):
    """World (position, rotation) of the left and the right fingertip:
    ``[E, 2, 3]``, ``[E, 2, 3, 3]``."""
    R, p = root_R, root_pos
    for i in range(3):                                      # the base's prismatic joints
        p = p + R[..., :, i] * qpos[:, i:i + 1]
    for j, (xyz, rpy, _, _) in enumerate(ARM):
        p = p + R @ torch.tensor(xyz, dtype=R.dtype, device=R.device)
        R = R @ _rpy(rpy, R) @ _rot("z", qpos[:, 3 + j])
    p = p + R @ torch.tensor(HAND[0], dtype=R.dtype, device=R.device)
    R = R @ _rpy(HAND[1], R)
    pos = []
    for side, q in ((1.0, qpos[:, 10]), (-1.0, qpos[:, 11])):   # fingers along ±y
        pos.append(p + R[..., :, 2] * (FINGER_Z + TIP_Z) + R[..., :, 1] * (side * q[:, None]))
    return torch.stack(pos, 1), torch.stack([R, R], 1)


def _tip_rows(qpos, qvel, root_pos, root_R):
    """[E, 2, 13] rows (position, xyzw quaternion, linear and angular
    velocity) of the two fingertips."""
    f = lambda q: fingertips(q, root_pos, root_R)
    (pos, R), (dpos, dR) = torch.func.jvp(f, (qpos,), (qvel,))
    W = dR @ R.transpose(-1, -2)                            # the skew matrix of ω
    ang = torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], -1)
    return torch.cat([pos, matrix_to_quat(R), dpos, ang], -1), R


def task_data(env) -> Dict[str, torch.Tensor]:
    """The cabinets' per-env data from the reference's env: the handle's
    eight corners in the cabinet's frame at a closed drawer, the drawer's
    axis there, which joint it is and its limits."""
    return {"bbox": env._bbox_init_t, "axis": env._axis_dir_t, "dof": env._target_dof_t,
            "lower": env._joint_lower_t, "upper": env._joint_upper_t}


@torch.no_grad()
def observe(data: Dict[str, torch.Tensor], sim: dict, dtype=torch.float64):
    """(``normal_state`` [E, 53], reward [E]) of a captured scene state
    (``sim``: the snapshot's fields, ``robot`` and ``obj`` with their
    ``qpos``, ``qvel``, ``root_pos``, ``root_quat``), computed in ``dtype``."""
    rf, of = sim["robot"]["fields"], sim["obj"]["fields"]
    cast = lambda t: t.to(dtype)
    qpos, qvel = cast(rf["qpos"]), cast(rf["qvel"])
    rows, Rt = _tip_rows(qpos, qvel, cast(rf["root_pos"]), quat_to_matrix(cast(rf["root_quat"])))
    ltip, rtip = rows[:, 0], rows[:, 1]
    tip = 0.5 * (ltip + rtip)
    lower, upper = dof_limits(dtype, qpos.device)
    qn = 2.0 * (qpos - lower) / (upper - lower) - 1.0

    q = torch.gather(cast(of["qpos"]), 1, data["dof"].long()[:, None])[:, 0]
    corners = cast(data["bbox"]) + q[:, None, None] * cast(data["axis"])[:, None, :]
    bbox = corners @ quat_to_matrix(cast(of["root_quat"])).transpose(-1, -2) \
        + cast(of["root_pos"])[:, None, :]
    edge = lambda a, b: bbox[:, a] - bbox[:, b]
    out, long, short = edge(0, 4), edge(1, 0), edge(3, 0)
    ol, ll, sl = out.norm(dim=-1), long.norm(dim=-1), short.norm(dim=-1)
    out, long, short = out / ol[:, None], long / ll[:, None], short / sl[:, None]
    mid = 0.5 * (bbox[:, 0] + bbox[:, 6])
    obs = torch.cat([tip, mid, out, short, long, ol[:, None], ll[:, None], sl[:, None],
                     qn, qvel, q[:, None]], -1)

    dot = lambda a, b: (a * b).sum(-1)
    d = tip[:, :3] - mid
    reached_out = dot(d, out).abs() < ol / 2
    reached_short = dot(ltip[:, :3] - mid, short) * dot(rtip[:, :3] - mid, short) < 0
    reached_long = dot(d, long).abs() < ll / 2
    reached = reached_out & reached_short & reached_long
    reaching = -d.norm(dim=-1) + 0.1 * (reached_out.to(dtype) + reached_short.to(dtype)
                                        + reached_long.to(dtype))
    R = Rt[:, 0]                                            # both tips turn with the hand
    rot_reward = (dot(-R[..., :, 2], out) + dot(R[..., :, 1], short).abs()
                  + dot(R[..., :, 0], long).abs() - 3.0)
    grip = (ltip[:, :3] - rtip[:, :3]).norm(dim=-1)
    close = torch.where(reached, 0.1 - grip, 0.1 * (grip - 0.1))
    grasped = reached & (grip < sl + 0.01) & (rot_reward > -0.2)
    lo, up = cast(data["lower"]), cast(data["upper"])
    open_frac = (q - lo) / up
    joint = torch.where(grasped, 0.1 + open_frac.clamp(max=SUC_PROP), torch.zeros_like(q))
    rew = reaching + 0.5 * rot_reward + 5.0 * close + 5.0 * joint
    rew = rew + rew.abs() * rot_reward
    rew = rew + 2.0 * (grasped & (q - lo >= SUC_PROP * up)).to(dtype)
    return obs, rew


def _quantiles(name: str, per_env: torch.Tensor) -> Dict[str, float]:
    per_env = per_env.double()
    return {name: float(per_env.max()),
            f"{name}.p99": float(torch.quantile(per_env, 0.99)),
            f"{name}.median": float(torch.quantile(per_env, 0.5))}


def gaps(prefix: str, ref: tuple, obs: torch.Tensor, rew: torch.Tensor) -> Dict[str, float]:
    """The program's ``normal_state`` and reward against :func:`observe`'s:
    per env the widest gap (the tip quaternion up to its sign), then the
    widest over envs, the 99th percentile and the median (interpolated)."""
    ref_obs, ref_rew = ref
    d = (obs.double() - ref_obs.double()).abs()
    flip = (obs[:, QUAT].double() + ref_obs[:, QUAT].double()).abs()
    d[:, QUAT] = torch.minimum(d[:, QUAT], flip)
    out = _quantiles(f"{prefix}.obs", d.amax(dim=1))
    out.update(_quantiles(f"{prefix}.reward", (rew.double() - ref_rew.double()).abs()))
    return out
