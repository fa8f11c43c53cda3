"""Franka Panda articulation spec (fixed and mobile-base variants).

Counterpart of ``partmanip_tpu/sim/franka.py`` (numpy only).

Kinematic parameters (joint origins/axes/limits/efforts) transcribed from the
reference URDFs
(``assets/franka_description/robots/franka_panda_sdf_mobile.urdf:3-277`` and
the fixed-base ``franka_panda_sdf.urdf``); the mobile variant prepends three
prismatic world joints (x/y ±0.2 m, z ±0.1 m, ``...sdf_mobile.urdf:3-23``).
Mass/inertia values are the public franka_ros estimates (the reference URDF
carries no inertials — Isaac fills in defaults the same way).

Drive gains follow ``tasks/load_robot.py:68-79``: arm 1e6/1e3,
gripper 1e4/1e2, mobile base 1e6/1e3, all DOF_MODE_POS.

Body order is depth-first URDF order: [base0-2,] link0..7, hand, leftfinger,
lefttip, rightfinger, righttip — giving the named indices exported below
(≙ ``find_actor_rigid_body_index``, ``tasks/load_robot.py:85-89``).
"""

from __future__ import annotations

import numpy as np

from .builder import BuiltTree, LinkDef, build_tree
from .types import JOINT_PRISMATIC, JOINT_REVOLUTE, SphereGeoms

PI2 = 1.57079632679

ARM_STIFFNESS, ARM_DAMPING = 1.0e6, 1.0e3
GRIPPER_STIFFNESS, GRIPPER_DAMPING = 1.0e4, 1.0e2
BASE_STIFFNESS, BASE_DAMPING = 1.0e6, 1.0e3

# (origin_xyz, origin_rpy, lower, upper, effort, velocity) per arm joint,
# franka_panda_sdf_mobile.urdf:48-187.
_ARM_JOINTS = [
    ((0, 0, 0.333), (0, 0, 0), -2.8973, 2.8973, 87, 2.1750),
    ((0, 0, 0), (-PI2, 0, 0), -1.7628, 1.7628, 87, 2.1750),
    ((0, -0.316, 0), (PI2, 0, 0), -2.8973, 2.8973, 87, 2.1750),
    ((0.0825, 0, 0), (PI2, 0, 0), -3.0718, -0.0698, 87, 2.1750),
    ((-0.0825, 0.384, 0), (-PI2, 0, 0), -2.8973, 2.8973, 12, 2.6100),
    ((0, 0, 0), (PI2, 0, 0), -0.0175, 3.7525, 12, 2.6100),
    ((0.088, 0, 0), (PI2, 0, 0), -2.8973, 2.8973, 12, 2.6100),
]

# franka_ros-style link masses / rough COM offsets / diagonal inertias.
_ARM_MASS = [4.970, 0.647, 3.228, 3.587, 1.226, 1.666, 0.735]
_ARM_COM = [
    (0.0, -0.035, -0.07), (0.0, -0.07, 0.03), (0.03, 0.03, -0.07),
    (-0.05, 0.10, 0.03), (0.0, 0.04, -0.12), (0.06, -0.01, 0.0),
    (0.01, 0.01, 0.08),
]
_ARM_INERTIA = [
    (0.07, 0.07, 0.01), (0.03, 0.03, 0.01), (0.04, 0.04, 0.01),
    (0.03, 0.03, 0.01), (0.03, 0.03, 0.01), (0.005, 0.005, 0.005),
    (0.003, 0.003, 0.003),
]


def build_franka(mobile: bool) -> BuiltTree:
    """Build the Franka TreeSpec. 13 links / 9 dofs fixed-base; 16 / 12 mobile."""
    links = []
    if mobile:
        links.append(LinkDef("panda_base0", mass=1e-3, inertia=(1e-4,) * 3))
        base_axes = [(1, 0, 0), (0, 1, 0), (0, 0, 1)]
        base_lims = [(-0.2, 0.2, 0.2), (-0.2, 0.2, 0.2), (-0.1, 0.1, 0.1)]
        child = ["panda_base1", "panda_base2", "panda_link0"]
        parentn = ["panda_base0", "panda_base1", "panda_base2"]
        for i in range(3):
            lo, up, vel = base_lims[i]
            links.append(
                LinkDef(
                    child[i], parent=parentn[i], joint_type=JOINT_PRISMATIC,
                    axis=base_axes[i], lower=lo, upper=up, vel_limit=vel,
                    effort=10.0, joint_name=f"panda_virtual{i}",
                    mass=(1e-3 if i < 2 else 3.06),
                    inertia=((1e-4,) * 3 if i < 2 else (0.03, 0.03, 0.03)),
                )
            )
    else:
        links.append(LinkDef("panda_link0", mass=3.06, inertia=(0.03, 0.03, 0.03)))

    for j in range(7):
        xyz, rpy, lo, up, eff, vel = _ARM_JOINTS[j]
        links.append(
            LinkDef(
                f"panda_link{j + 1}", parent=(f"panda_link{j}"),
                joint_type=JOINT_REVOLUTE, origin_pos=xyz, origin_rpy=rpy,
                axis=(0, 0, 1), lower=lo, upper=up, effort=eff, vel_limit=vel,
                joint_name=f"panda_joint{j + 1}",
                # intrinsic joint damping from the URDF (<dynamics
                # damping="10"/>, franka_panda_sdf_mobile.urdf:54...) —
                # unconditional dissipation outside the drive's effort clamp;
                # without it the effort-limited bang-bang drives sustain a
                # high-amplitude limit cycle once violently excited.
                damping=10.0,
                mass=_ARM_MASS[j], com=_ARM_COM[j], inertia=_ARM_INERTIA[j],
                # gear-reflected rotor inertia (harmonic drives); also what
                # keeps the wrist joints well-conditioned under effort-limited
                # bang-bang drive forces.
                armature=0.12 if j < 4 else 0.06,
            )
        )
    # hand: fixed, xyz (0,0,0.107), rpy (0,0,-pi/4)  (urdf:198-208)
    links.append(
        LinkDef(
            "panda_hand", parent="panda_link7",
            origin_pos=(0, 0, 0.107), origin_rpy=(0, 0, -0.785398163397),
            mass=0.73, com=(0, 0, 0.03), inertia=(0.002, 0.002, 0.002),
        )
    )
    # fingers: prismatic ±y at z 0.0584 (urdf:249-265); tips at +0.0445
    # (urdf:266-277).
    for name, ax in [("panda_leftfinger", (0, 1, 0)),
                     ("panda_rightfinger", (0, -1, 0))]:
        links.append(
            LinkDef(
                name, parent="panda_hand", joint_type=JOINT_PRISMATIC,
                origin_pos=(0, 0, 0.0584), axis=ax, lower=0.0, upper=0.04,
                effort=20.0, vel_limit=0.2, damping=10.0,
                joint_name=("panda_finger_joint1" if "left" in name
                            else "panda_finger_joint2"),
                mass=0.015, com=(0, 0, 0.02), inertia=(1e-5, 1e-5, 1e-5),
            )
        )
        tip = name.replace("finger", "tip").replace("panda_", "panda_")
        tip = "panda_lefttip" if "left" in name else "panda_righttip"
        links.append(LinkDef(tip, parent=name, origin_pos=(0, 0, 0.0445)))

    # Reorder so dofs come out as [base…, arm…, fingers] like Isaac:
    # current order interleaves tips after each finger which is fine —
    # tips are fixed links, dof numbering skips them.
    built = build_tree(links)

    spec = built.spec
    D = spec.dof_mask.shape[-1]
    kp = np.zeros(D, np.float32)
    kd = np.zeros(D, np.float32)
    nb = 3 if mobile else 0
    kp[:nb] = BASE_STIFFNESS
    kd[:nb] = BASE_DAMPING
    kp[nb:nb + 7] = ARM_STIFFNESS
    kd[nb:nb + 7] = ARM_DAMPING
    kp[nb + 7:nb + 9] = GRIPPER_STIFFNESS
    kd[nb + 7:nb + 9] = GRIPPER_DAMPING
    spec = spec._replace(
        drive_kp=kp[None], drive_kd=kd[None],
        gravity_scale=np.zeros(1, np.float32),  # disable_gravity, load_robot.py:40
    )
    built.spec = spec
    return built


def franka_body_indices(built: BuiltTree) -> dict:
    li = built.link_index
    return {
        "hand": li["panda_hand"],
        "leftfinger": li["panda_leftfinger"],
        "rightfinger": li["panda_rightfinger"],
        "lefttip": li["panda_lefttip"],
        "righttip": li["panda_righttip"],
    }


def franka_collision_spheres(built: BuiltTree) -> SphereGeoms:
    """Sphere-decomposition collision proxy for the Franka.

    Replaces the PhysX SDF-mode mesh collision (URDF ``<sdf resolution>``,
    franka_panda_sdf_mobile.urdf:231): spheres on the hand/fingers (the parts
    that touch objects) plus coarse spheres along the arm to keep it out of
    the floor/cabinet.
    """
    li = built.link_index
    entries = []  # (link name, offset, radius, friction)

    def add(link, off, r, mu=1.0, sticky=0.0):
        entries.append((li[link], off, r, mu, sticky))

    # forearm / wrist coarse proxies
    add("panda_link2", (0, -0.05, 0.03), 0.075)
    add("panda_link3", (0.04, 0.03, -0.04), 0.065)
    add("panda_link4", (-0.04, 0.06, 0.02), 0.065)
    add("panda_link5", (0, 0.04, -0.12), 0.065)
    add("panda_link5", (0, 0.01, -0.22), 0.06)
    add("panda_link6", (0.04, 0.0, 0.0), 0.055)
    add("panda_link7", (0.0, 0.0, 0.07), 0.05)
    # hand body (palm) — spheres across its width, kept above the finger mount
    add("panda_hand", (0, -0.04, 0.022), 0.03)
    add("panda_hand", (0, 0.04, 0.022), 0.03)
    add("panda_hand", (0, 0.0, 0.022), 0.03)
    # Finger pads: the left finger sits at +y (joint axis (0,1,0), opening
    # increases y) with its contact face on the finger-frame y=0 plane, so
    # tip-to-tip gripper_length == grasped width, preserving the reference's
    # gripper_length reward semantics (tasks/open_drawer.py:207-209).  Sphere
    # centers are offset outward by one radius so surfaces are tangent to y=0.
    for f, s in [("panda_leftfinger", +1.0), ("panda_rightfinger", -1.0)]:
        for z, r in [(0.012, 0.010), (0.027, 0.009), (0.040, 0.008),
                     (0.052, 0.0065)]:
            add(f, (0, s * r, z), r, sticky=1.0)

    link_idx = np.array([e[0] for e in entries], np.int32)
    offset = np.array([e[1] for e in entries], np.float32)
    radius = np.array([e[2] for e in entries], np.float32)
    friction = np.array([e[3] for e in entries], np.float32)
    sticky = np.array([e[4] for e in entries], np.float32)
    return SphereGeoms(link_idx=link_idx, offset=offset, radius=radius,
                       friction=friction, sticky=sticky)
