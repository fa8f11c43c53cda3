"""Wrapper of the fused physics inner-step CUDA kernels: variant B1a (robot
+ ground + one free box, grasp_cube), variant B1b (robot + ground + one
articulated object with box geoms, open_drawer), variant B1c (B1b plus
baked mesh-SDF geoms on the object, open_drawer with mesh handles),
variant B1d (the robot and the ground alone, the controller-calibration
scene of ``tune_pid_torch.py``) and variant B1e (B1b or B1c with B1a's
free box beside the object: grasp_cube's cube in open_drawer's scene).

Counterpart of ``partmanip_tpu/sim/fused.py`` (``fused_physics_step`` around
the Pallas kernel ``_inner_step_tiled``, whose ``has_body`` / ``has_obj`` /
``n_grid > 0`` variants, and the one with neither flag, become kernels
here; the TPU build's separate grid narrowphase ``_grid_narrowphase`` runs
inside B1c).  The kernel sources are ``csrc/fused_inner_step.cu`` (B1a; B1d
is the same file compiled with ``FIS_BODY=0``) and
``csrc/fused_inner_step_obj.cu`` (B1b; B1c is the same file compiled with
``FIS_K > 0``, B1e with ``FIS_BODY=1``, with or without grids), sharing
``csrc/fused_common.cuh``, ``fused_geom.cuh``, ``fused_warp.cuh`` and
``fused_bias.cuh``; each is compiled with ``nvcc``
for ``sm_90a`` at first use into a shared library with a plain C interface,
keyed on every compile-time size, and loaded with ``ctypes``
(``utils/cuda_lib.py``, shared by every kernel of the port).  Nothing here
needs ``nvcc`` or a GPU at import time.

A scene with ``coriolis=True`` or a tree under gravity (a non-zero
``gravity_scale``) runs the same variant built with ``FIS_BIAS=1``: its
solves subtract each tree's bias (``dynamics.bias_forces``), which the
kernel computes from what its mass-matrix phase holds.  The TPU kernel
declined such scenes and left them to XLA; here a CUDA state is launched or
raises, so the kernel computes them.  The other scenes, which are all that
the shipped configs make, run the builds they ran before.

* :func:`fused_physics_step` — what ``engine.physics_step`` calls: all
  ``substeps × inner_substeps`` inner steps of one physics step in ONE
  launch.
* :func:`fused_inner_steps` — the same with an explicit ``n_steps``
  (``n_steps=1`` is the mode a kernel is held against its plain version in,
  ``engine._inner_step``).
* ``launch_counts`` — per variant, rises by one wherever that kernel is
  launched, and nowhere else.

State on a CUDA device is launched or raises; only state that lies on the CPU
takes the plain version.  The kernels want the state env-minor
(``[feature, E]``: a warp's loads are contiguous), the rest of the port keeps
``[E, feature]`` like the JAX package, so the wrapper packs before and
unpacks after each launch (two small transposes per physics step).

The robot and the contact constants go to the kernel's ``Spec`` struct (one
robot for all envs, in device memory, copied to shared memory by each
block).  B1b's object differs
between envs: the per-env object spec is reduced on the host, once per
scene, to a table of its distinct rows (one ``ObjSpec`` record each) plus an
object id per env, both uploaded to device memory.  B1c adds a ``GridSpec``
record per distinct object (the mesh geoms, same id) and reads the scene's
grid stack, which already lies on the device.

B1b and B1c run one warp per env, B1a (one tree, whose serial phases fit
in 16 lanes) a half-warp per env, two envs a warp.  The TPU kernel ran each
env serially on one lane of a tile; carried over, one thread per env left
64 warps for 132 SMs at 2048 envs, each a long dependent chain with its
working set spilled.  Here the lanes split every phase of the inner step
(links, (link, dof) Jacobian columns, mass-matrix entries, spheres,
(sphere, geom) pairs or touching spheres, J^T N J entries, dofs of the
Cholesky solve, B1a's box corners and axes), the env's records and
working set sit in shared memory, and sums have one fixed order, so n
inner steps in one launch equal n launches bit for bit; the contact
geometry is rounded as the plain version rounds it
(``csrc/fused_geom.cuh``).  What bounds them on an H100 is the latency of
one env's chain (the link chains, the Cholesky columns and
substitutions), not memory (``scripts/prof_torch_fused_phases.py`` reads
where one env's cycles go).  :func:`launch_config` gives the launch (envs
a block, the block's shared memory from the dims), which the wrapper
checks against the library's own once per loaded library.
"""

from __future__ import annotations

import ctypes
import math
import os

import numpy as np
import torch

from ..utils import cuda_lib
from . import contact, dynamics, engine
from .types import FreeBodyState, HostCache, TreeState

KERNEL_SOURCE = os.path.join(cuda_lib.CSRC, "fused_inner_step.cu")          # B1a
KERNEL_SOURCE_OBJ = os.path.join(cuda_lib.CSRC, "fused_inner_step_obj.cu")  # B1b
# B1c is B1b's source compiled with FIS_K > 0, B1d B1a's with FIS_BODY=0,
# B1e B1b's (or B1c's) with FIS_BODY=1
KERNEL_SOURCES = {"b1a": KERNEL_SOURCE, "b1b": KERNEL_SOURCE_OBJ, "b1c": KERNEL_SOURCE_OBJ,
                  "b1d": KERNEL_SOURCE, "b1e": KERNEL_SOURCE_OBJ}
DIM_NAMES = ("L", "D", "S", "Lo", "Do", "G", "K", "X", "Y", "Z")
DIM_MACROS = ("FIS_L", "FIS_D", "FIS_S", "FIS_LO", "FIS_DO", "FIS_G", "FIS_K",
              "FIS_GX", "FIS_GY", "FIS_GZ")

# Number of kernel launches made by this module since import / the last
# reset, per variant.
launch_counts = cuda_lib.launch_counter("b1a", "b1b", "b1c", "b1d", "b1e")

# B1b / B1c give each env a warp: WARPS envs a block, the robot's Spec once
# per block and each env's records and working set (struct Work) in shared
# memory (csrc/fused_inner_step_obj.cu).  B1a gives each env a half-warp:
# B1A_WARPS warps, 2 x B1A_WARPS envs a block (csrc/fused_inner_step.cu).
WARPS = 4
B1A_WARPS = 2
SMEM_LIMIT = 232_448          # shared memory a block may use on sm_90 (227 KB)

_PACKED = HostCache()  # scene.robot.parent tensor -> {key, packed Spec, ...}
_UPLOADED = {}        # library path -> id of the packed spec on the device
_CONFIG_CHECKED = set()  # library paths whose launch configuration was checked


def library(variant: str, dims, bias: bool = False) -> cuda_lib.Library:
    """``variant``'s kernel library for these array sizes (every
    compile-time size is a macro and is in the library's name), built with
    the tree bias when ``bias`` (``FIS_BIAS=1``, ``_bias`` in the name).
    B1d is B1a's source with ``FIS_BODY=0`` (``_robot`` in the name), B1e
    B1b's with ``FIS_BODY=1`` (``_body``; with grids, B1c's dims); the
    other builds pass neither macro."""
    dims = tuple(int(d) for d in dims)
    tag = "_".join(f"{n}{d}" for n, d in zip(DIM_NAMES, dims))
    defines = list(zip(DIM_MACROS, dims))
    if variant == "b1d":
        defines.append(("FIS_BODY", 0))
        tag += "_robot"
    if variant == "b1e":
        defines.append(("FIS_BODY", 1))
        tag += "_body"
    if bias:
        defines.append(("FIS_BIAS", 1))
        tag += "_bias"
    stem = os.path.splitext(os.path.basename(KERNEL_SOURCES[variant]))[0]
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    sig = {"fis_spec_bytes": ((), i32), "fis_state_rows": ((), i32),
           "fis_dims": ((i32,), i32), "fis_set_spec": ((ptr, i32, ptr), i32),
           "fis_launch_config": ((i32,), i32), "fis_occupancy": ((ptr,), i32)}
    if variant in ("b1a", "b1d"):
        sig["fis_launch"] = ((ptr, ptr, ptr, ptr, i32, i32, ptr), i32)
    elif len(dims) == 6:                       # B1b, B1e without grids
        sig["fis_obj_bytes"] = ((), i32)
        sig["fis_launch"] = ((ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, ptr), i32)
    else:
        sig["fis_obj_bytes"] = ((), i32)
        sig["fis_grid_bytes"] = ((), i32)
        sig["fis_launch"] = ((ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32, ptr, ptr, ptr, i32,
                              i32, i32, ptr), i32)
    name = variant + ("_bias" if bias else "")
    return cuda_lib.Library(name, KERNEL_SOURCES[variant], f"lib{stem}_{tag}.so",
                            sig, defines=defines)


def scene_library(scene: engine.SceneSpec) -> cuda_lib.Library:
    """The library that runs this scene: its variant at its sizes, with the
    tree bias when it needs one (:func:`needs_bias`)."""
    return library(variant(scene), _dims(scene), needs_bias(scene))


# ----------------------------------------------------------------------
# scene description -> the kernel's Spec struct
# ----------------------------------------------------------------------

def check_scene(scene: engine.SceneSpec) -> None:
    """Raise with the reason when the kernel cannot run this scene (the
    counterpart of the JAX package's ``fused_supported`` predicate, which
    silently switched paths instead)."""
    engine.check_supported(scene)
    if scene.robot.parent.shape[0] != 1:
        raise NotImplementedError(
            "the fused kernel needs one robot topology shared by all envs")
    if scene.obj_tree is not None:
        if scene.obj_boxes.link_idx.shape[-1] > 32:
            raise NotImplementedError(
                "kernel B1b keeps a sphere's touching boxes in a 32-bit "
                "mask: at most 32 object boxes")
        if scene.obj_grids is not None:
            _check_grids(scene)
    if scene.free_body is None:
        return
    for name, leaf in zip(scene.free_body._fields, scene.free_body):
        if leaf.shape[0] != 1:
            raise NotImplementedError(
                f"the fused kernel needs a shared free body spec "
                f"(free_body.{name} has env axis {leaf.shape[0]})")


def _check_grids(scene: engine.SceneSpec) -> None:
    """Raise with the reason when kernel B1c cannot run the scene's mesh-SDF
    geoms and grid stack."""
    gg, st = scene.obj_grids, scene.grid_stack
    if gg.link_idx.shape[-1] > 32:
        raise NotImplementedError(
            "kernel B1c keeps a sphere's touching grid geoms in a 32-bit "
            "mask: at most 32 mesh geoms per object")
    if st.sdf.dim() != 4 or min(st.sdf.shape[1:]) < 3:
        raise NotImplementedError(
            f"kernel B1c needs a grid stack [M, X, Y, Z] with X, Y, Z >= 3 "
            f"(interior cells to interpolate in), got {tuple(st.sdf.shape)}")
    M = st.sdf.shape[0]
    if st.bbox_min.shape != (M, 3) or st.voxel_size.shape != (M,):
        raise NotImplementedError(
            f"grid stack fields disagree: sdf {tuple(st.sdf.shape)}, bbox_min "
            f"{tuple(st.bbox_min.shape)}, voxel_size {tuple(st.voxel_size.shape)}")
    if any(x.dtype != torch.float32 or not x.is_contiguous() for x in st):
        raise NotImplementedError("kernel B1c reads a contiguous f32 grid stack")
    if st.sdf.numel() >= 2 ** 31:
        raise NotImplementedError("kernel B1c indexes the grid stack with 32-bit cell offsets")


def _i32(x):
    return np.asarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
                      else x).astype(np.int32).reshape(-1).view(np.float32)


def _f32(x):
    return np.asarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
                      else x).astype(np.float32).reshape(-1)


def _scalars(*xs):
    return np.asarray(xs, np.float32)


def _robot_words(scene: engine.SceneSpec):
    """The robot tree and the sphere table, as the leading fields of both
    kernels' ``Spec`` structs."""
    r, s = scene.robot, scene.spheres
    return [
        _i32(r.parent[0]), _i32(r.joint_type[0]), _i32(r.dof_idx[0]),
        _i32(r.dof_child[0]), _i32(s.link_idx),
        _f32(r.origin_pos[0]), _f32(r.origin_quat[0]), _f32(r.axis[0]),
        _f32(r.mass[0] * r.link_mask[0]), _f32(r.com[0]), _f32(r.inertia[0]),
        _f32(r.ancestor[0]),
        _f32(r.dof_mask[0]), _f32(r.dof_lower[0]), _f32(r.dof_upper[0]),
        _f32(r.dof_vel_limit[0]), _f32(r.dof_effort[0]),
        _f32(r.dof_armature[0]), _f32(r.dof_damping[0]),
        _f32(r.dof_friction[0]), _f32(r.drive_kp[0]), _f32(r.drive_kd[0]),
        _f32(s.offset), _f32(s.radius), _f32(s.friction), _f32(s.sticky),
    ]


def _contact_coefs(p):
    """(cd(m_eff), coef(m_eff), anchor cdt) with the plain version's
    formulas."""
    zeta, kn, h = p.contact_damping_ratio, p.contact_kn, p.h
    cd = lambda m_eff: 2.0 * zeta * math.sqrt(kn * m_eff)
    coef = lambda m_eff: h * cd(m_eff) + h * h * kn
    cdt = 2.0 * contact.ANCHOR_ZETA * math.sqrt(contact.ANCHOR_KS * 0.1)
    return cd, coef, cdt


def needs_bias(scene: engine.SceneSpec) -> bool:
    """Whether the scene's solves need the tree bias (the ``FIS_BIAS``
    build): the velocity-product term is on, or a tree is under gravity."""
    if scene.params.coriolis:
        return True
    trees = [scene.robot] + ([] if scene.obj_tree is None else [scene.obj_tree])
    return any(float(t.gravity_scale.abs().max()) != 0.0 for t in trees)


def _bias_words(scene: engine.SceneSpec):
    """The bias build's last ``Spec`` fields: the robot's gravity_scale and
    the coriolis flag."""
    gs = _f32(scene.robot.gravity_scale)
    if not np.all(gs == gs[0]):
        raise NotImplementedError(
            "the fused kernel needs one robot gravity_scale shared by all envs")
    return [_scalars(gs[0], 1.0 if scene.params.coriolis else 0.0)]


def pack_spec(scene: engine.SceneSpec, bias: bool = False) -> np.ndarray:
    """The scene as kernel B1a's ``Spec`` struct (field order of
    ``csrc/fused_inner_step.cu``), a flat array of 4-byte words; without a
    free body, B1d's (``FIS_BODY=0``: the box's fields left out); with
    ``bias``, the ``FIS_BIAS`` build's (the bias fields at the end)."""
    fb, p = scene.free_body, scene.params
    h, kn = p.h, p.contact_kn
    cd, coef, cdt = _contact_coefs(p)
    tail = [dynamics._FRICTION_VEPS, dynamics._BRAKE_BETA, dynamics._SAT_VEPS]
    if fb is None:
        words = _robot_words(scene) + [
            _scalars(h, p.gravity, kn, p.contact_kt, p.max_depenetration_velocity,
                     0.1,                          # ground friction
                     cd(0.5), coef(0.5),
                     contact.ANCHOR_KS, cdt, h * cdt + h * h * contact.ANCHOR_KS, *tail),
        ]
    else:
        m_cube = float(_f32(fb.mass)[0])
        words = _robot_words(scene) + [
            _f32(fb.mass[:1]), _f32(fb.inertia[0]), _f32(fb.half_extents[0]),
            _f32(fb.gravity_scale[:1]), _f32(fb.friction[:1]),
            _scalars(h, p.gravity, kn, p.contact_kt, p.max_depenetration_velocity,
                     0.1,                          # ground friction
                     cd(0.5), cd(m_cube), cd(m_cube / 4.0), coef(0.5), coef(m_cube),
                     contact.ANCHOR_KS, cdt, h * cdt + h * h * contact.ANCHOR_KS,
                     contact.FREE_BODY_HOLD_VEL, *tail),
        ]
    if bias:
        words += _bias_words(scene)
    return np.ascontiguousarray(np.concatenate(words))


def pack_spec_obj(scene: engine.SceneSpec, bias: bool = False) -> np.ndarray:
    """The robot and the contact constants as kernel B1b's ``Spec`` struct
    (field order of ``csrc/fused_inner_step_obj.cu``); with a free body,
    B1e's (``FIS_BODY=1``: the cube's fields after the constants); with
    ``bias``, the ``FIS_BIAS`` build's (the bias fields at the end)."""
    p, fb = scene.params, scene.free_body
    h, kn = p.h, p.contact_kn
    cd, coef, cdt = _contact_coefs(p)
    words = _robot_words(scene) + [
        _scalars(h, p.gravity, kn, p.contact_kt, p.max_depenetration_velocity,
                 0.1,                              # ground friction
                 cd(0.5), cd(0.3), coef(0.5), coef(0.3),
                 contact.ANCHOR_KS, cdt, h * cdt + h * h * contact.ANCHOR_KS,
                 dynamics._FRICTION_VEPS, dynamics._BRAKE_BETA,
                 dynamics._SAT_VEPS),
    ]
    if fb is not None:
        m_cube = float(_f32(fb.mass)[0])
        words += [_f32(fb.mass[:1]), _f32(fb.inertia[0]), _f32(fb.half_extents[0]),
                  _f32(fb.gravity_scale[:1]), _f32(fb.friction[:1]),
                  _scalars(cd(m_cube), cd(m_cube / 4.0), coef(m_cube),
                           contact.FREE_BODY_HOLD_VEL)]
    if bias:
        words += _bias_words(scene)
    return np.ascontiguousarray(np.concatenate(words))


def pack_obj_table(scene: engine.SceneSpec, bias: bool = False):
    """The per-env articulated object as kernel B1b's ``ObjSpec`` records:
    ``(tables, obj_id i32 [E])`` with ``tables = (f32 [n_obj, words],)``,
    one record per distinct object, ``tables[0][obj_id]`` equal to the
    per-env spec it was made from (checked).  With mesh-SDF geoms (B1c)
    ``tables`` also holds each object's ``GridSpec`` record:
    ``(objs, grids)``, indexed by the same ``obj_id``.  With ``bias`` each
    record ends with the object's gravity_scale (the ``FIS_BIAS`` build)."""
    o, b, gg = scene.obj_tree, scene.obj_boxes, scene.obj_grids
    leaves = (*o, *b) if gg is None else (*o, *b, *gg)
    E = max(leaf.shape[0] for leaf in leaves)
    mask = _f32(b.geom_mask)
    if not np.all((mask == 0.0) | (mask == 1.0)):
        raise NotImplementedError("kernel B1b takes box masks of 0 or 1 only")

    def per_env(x, dtype):
        a = np.asarray(x.detach().cpu().numpy(), dtype)
        return np.broadcast_to(a, (E,) + a.shape[1:]).reshape(E, -1)

    i32 = lambda x: per_env(x, np.int32).view(np.float32)
    f32 = lambda x: per_env(x, np.float32)
    cols = [
        i32(o.parent), i32(o.joint_type), i32(o.dof_idx), i32(o.dof_child),
        i32(b.link_idx),
        f32(o.origin_pos), f32(o.origin_quat), f32(o.axis),
        f32(o.mass * o.link_mask), f32(o.com), f32(o.inertia), f32(o.ancestor),
        f32(o.dof_mask), f32(o.dof_lower), f32(o.dof_upper),
        f32(o.dof_vel_limit), f32(o.dof_effort), f32(o.dof_armature),
        f32(o.dof_damping), f32(o.dof_friction), f32(o.drive_kp),
        f32(o.drive_kd),
        f32(b.offset_pos), f32(b.offset_quat), f32(b.half_extents),
        f32(b.geom_mask), f32(b.friction),
    ] + ([f32(o.gravity_scale)] if bias else [])
    n_obj_words = sum(c.shape[1] for c in cols)
    if gg is not None:
        gmask = _f32(gg.geom_mask)
        if not np.all((gmask == 0.0) | (gmask == 1.0)):
            raise NotImplementedError("kernel B1c takes mesh geom masks of 0 or 1 only")
        gid, M = _i32(gg.grid_id).view(np.int32), scene.grid_stack.sdf.shape[0]
        if gid.min() < 0 or gid.max() >= M:
            raise NotImplementedError(f"grid ids outside the stack of {M} grids")
        cols += [i32(gg.link_idx), i32(gg.grid_id), f32(gg.offset_pos),
                 f32(gg.offset_quat), f32(gg.geom_mask), f32(gg.friction)]
    rows = np.ascontiguousarray(np.concatenate(cols, axis=1))
    # distinct records, compared bit for bit
    table, obj_id = np.unique(rows.view(np.int32), axis=0, return_inverse=True)
    table = np.ascontiguousarray(table.view(np.float32))
    obj_id = obj_id.reshape(-1).astype(np.int32)
    if not np.array_equal(table[obj_id].view(np.int32), rows.view(np.int32)):
        raise RuntimeError("object table does not reproduce the per-env spec")
    tables = (table,) if gg is None else (np.ascontiguousarray(table[:, :n_obj_words]),
                                          np.ascontiguousarray(table[:, n_obj_words:]))
    return tables, obj_id


def _packed(scene: engine.SceneSpec) -> dict:
    """The packed ``Spec`` (and for B1b the object table and ids), done once
    per scene: packing reads the device back."""
    slot = _PACKED.get(scene.robot.parent, dict)
    # scenes may share a robot and differ in the rest
    key = (scene.params, id(scene.spheres.link_idx), id(scene.robot.gravity_scale),
           None if scene.free_body is None else id(scene.free_body.mass),
           None if scene.obj_tree is None else (id(scene.obj_tree.parent),
                                                id(scene.obj_boxes.link_idx),
                                                id(scene.obj_tree.gravity_scale)),
           None if scene.obj_grids is None else (id(scene.obj_grids.link_idx),
                                                 id(scene.grid_stack.sdf)))
    if slot.get("key") != key:
        slot.clear()
        bias = needs_bias(scene)
        if variant(scene) in ("b1a", "b1d"):
            slot.update(key=key, spec=pack_spec(scene, bias), bias=bias)
        else:
            tables, obj_id = pack_obj_table(scene, bias)
            slot.update(key=key, spec=pack_spec_obj(scene, bias), tables=tables,
                        obj_id=obj_id, device={}, bias=bias)
    return slot


def _packed_spec(scene: engine.SceneSpec) -> np.ndarray:
    """:func:`pack_spec` / :func:`pack_spec_obj`, done once per scene."""
    return _packed(scene)["spec"]


def variant(scene: engine.SceneSpec) -> str:
    """The kernel that runs this scene: B1e with an articulated object and
    a free body, B1c with mesh-SDF geoms, B1b with an articulated object,
    B1a with a free body, B1d with neither."""
    if scene.obj_tree is not None and scene.free_body is not None:
        return "b1e"
    if scene.obj_grids is not None:
        return "b1c"
    if scene.obj_tree is not None:
        return "b1b"
    return "b1a" if scene.free_body is not None else "b1d"


def _dims(scene: engine.SceneSpec):
    """The kernel's compile-time sizes: (L, D, S) for B1a and B1d, (L, D, S,
    Lo, Do, G) for B1b, and for B1c also K and the grid stack's (X, Y, Z);
    B1e's are B1b's or, with grids, B1c's."""
    dims = (scene.robot.num_links, scene.robot.num_dofs,
            scene.spheres.link_idx.shape[0])
    if scene.obj_tree is None:
        return dims
    dims += (scene.obj_tree.num_links, scene.obj_tree.num_dofs,
             scene.obj_boxes.link_idx.shape[-1])
    if scene.obj_grids is None:
        return dims
    return dims + (scene.obj_grids.link_idx.shape[-1],
                   *scene.grid_stack.sdf.shape[1:])


def state_rows(D: int, S: int) -> int:
    """Rows of B1a's env-minor state buffer: qpos, qvel, root pose, body
    pose and velocities, anchor points, targets."""
    return D + D + 3 + 4 + 3 + 4 + 3 + 3 + 3 * S + D


def state_rows_robot(D: int, S: int) -> int:
    """Rows of B1d's env-minor state buffer: qpos, qvel, root pose, anchor
    points, targets (B1a's without the body rows)."""
    return D + D + 3 + 4 + 3 * S + D


def state_rows_obj(D: int, S: int, Do: int) -> int:
    """Rows of B1b's env-minor state buffer: qpos, qvel, root pose, object
    qpos, qvel and root pose, anchor points, targets."""
    return D + D + 3 + 4 + Do + Do + 3 + 4 + 3 * S + D


def state_rows_obj_body(D: int, S: int, Do: int) -> int:
    """Rows of B1e's env-minor state buffer: B1b's, with B1a's body pose and
    velocities after the object's rows (before the anchor points)."""
    return state_rows_obj(D, S, Do) + 3 + 4 + 3 + 3


def _rows(variant: str, dims) -> int:
    L, D, S = dims[:3]
    if variant == "b1a":
        return state_rows(D, S)
    if variant == "b1e":
        return state_rows_obj_body(D, S, dims[4])
    return state_rows_robot(D, S) if variant == "b1d" else state_rows_obj(D, S, dims[4])


def _bias_scratch(L: int, D: int) -> int:
    """Scratch floats the bias adds after a tree's mass matrix
    (``FIS_BIAS_SCRATCH`` of ``csrc/fused_bias.cuh``)."""
    return L * 12 + D * 6


def struct_words(dims, body: bool = None, bias: bool = False) -> dict:
    """4-byte words of the kernel's structs at these sizes: for B1a (dims
    (L, D, S)) ``Spec`` and the per-env working set ``Work`` of
    ``csrc/fused_inner_step.cu`` (B1d: ``body`` False, the box's fields
    and rows left out), for B1b / B1c ``Spec``, ``ObjSpec``, ``GridSpec``
    and ``Work`` of ``csrc/fused_inner_step_obj.cu`` (B1e: ``body`` True,
    the cube's Spec fields and state rows added); with ``bias`` the
    ``FIS_BIAS`` build's.  ``body`` None: the family's default build (B1a,
    B1b / B1c).  The scratch area is the largest of the phases that reuse
    it."""
    if body is None:
        body = len(dims) == 3
    if len(dims) == 3:
        L, D, S = dims
        mass = L * 12 + L * D * 6 + (_bias_scratch(L, D) if bias else 0)
        scratch = max(7 * L, D * D, mass, S * D * 3 + S * 12)
        work = (12 * D + 7 * L + D * (D + 1)          # state, targets, poses, axes, M, Ac, tau
                + (20 + 13 * S if body else 7 + 9 * S)   # roots and body, sphere records
                + scratch + (D if bias else 0))      # scratch, the bias
        spec = 26 * L + L * D + 11 * D + 7 * S + (33 if body else 14) + (2 if bias else 0)
        return {"spec": spec, "work": work}
    L, D, S, Lo, Do, G = dims[:6]
    K = dims[6] if len(dims) > 6 else 0
    KG = max(K, 1)
    tri, trio = D * (D + 1) // 2, Do * (Do + 1) // 2
    extra = (lambda nl, nd: _bias_scratch(nl, nd)) if bias else (lambda nl, nd: 0)
    scratch = max(7 * (L + Lo), 2 * D * D, L * 12 + L * D * 6 + extra(L, D),
                  Lo * 12 + Lo * Do * 6 + extra(Lo, Do),
                  S * D * 3 + max(S * G + S * KG, S * D * 3))
    work = (2 * D + 2 * Do + 14 + (13 if body else 0) + D  # state rows, targets
            + 7 * L + 8 * D + 2 * tri + D                 # robot poses, axes, M, Ac, tau
            + 7 * Lo + 8 * Do + 2 * trio + Do             # the object's
            + 8 * G + 8 * KG                              # geom poses, active lists
            + 16 * S + scratch                            # sphere records, scratch
            + (D + Do if bias else 0))                    # the biases
    return {"spec": 26 * L + L * D + 11 * D + 7 * S + 16 + (19 if body else 0)
                    + (2 if bias else 0),
            "obj": 26 * Lo + Lo * Do + 11 * Do + 13 * G + (1 if bias else 0),
            "grid": 11 * K, "work": work}


def launch_config(E: int, dims, body: bool = None, bias: bool = False) -> dict:
    """The kernel's launch for E envs at these sizes.  B1a / B1d (dims (L,
    D, S); B1d without the ``body``): two envs a warp, B1A_WARPS warps a
    block, and the block's dynamic shared memory: the Spec once, then a
    Work per env.  B1b / B1c (B1e with the ``body``): a warp per env, WARPS
    envs a block, the Spec once, then WARPS x (Work, ObjSpec, GridSpec).
    ``bias``: the ``FIS_BIAS`` build."""
    w = struct_words(dims, body, bias)
    if len(dims) == 3:
        envs = 2 * B1A_WARPS
        return {"envs_per_warp": 2, "warps_per_block": B1A_WARPS, "envs_per_block": envs,
                "threads": 32 * B1A_WARPS, "blocks": -(-E // envs),
                "dynamic_smem_bytes": 4 * (w["spec"] + envs * w["work"]),
                "work_bytes": 4 * w["work"]}
    smem = 4 * (w["spec"] + WARPS * (w["work"] + w["obj"] + w["grid"]))
    return {"warps_per_block": WARPS, "threads": 32 * WARPS, "blocks": -(-E // WARPS),
            "dynamic_smem_bytes": smem, "work_bytes": 4 * w["work"]}


def occupancy(scene: engine.SceneSpec) -> int:
    """Blocks of the scene's kernel resident on one SM at once
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` on the current
    device)."""
    kind = variant(scene)
    out = ctypes.c_int(0)
    err = scene_library(scene).load().fis_occupancy(ctypes.byref(out))
    cuda_lib.check_launch(err, f"fused_inner_step ({kind}) occupancy query")
    return out.value


# ----------------------------------------------------------------------
# state layout: [E, feature] (the port) <-> [feature, E] (the kernel)
# ----------------------------------------------------------------------

def pack_state(state: engine.SceneState, pos_targets):
    """SceneState + targets → (f32 [rows, E], i32 [S, E]), env-minor; the
    free body's rows for B1a, the object's for B1b, the object's then the
    body's for B1e, neither for B1d."""
    E = state.robot.qpos.shape[0]
    r = state.robot
    part = []
    if state.obj is not None:
        o = state.obj
        part += [o.qpos, o.qvel, o.root_pos, o.root_quat]
    if state.body is not None:
        b = state.body
        part += [b.pos, b.quat, b.linvel, b.angvel]
    flat = torch.cat([r.qpos, r.qvel, r.root_pos, r.root_quat, *part,
                      state.anchors.point.reshape(E, -1), pos_targets], dim=1)
    return (flat.t().contiguous(),
            state.anchors.body.to(torch.int32).t().contiguous())


def unpack_state(buf, anc_b, like: engine.SceneState) -> engine.SceneState:
    """The inverse of :func:`pack_state` (targets dropped)."""
    D = like.robot.qpos.shape[1]
    S = anc_b.shape[0]
    rows = buf.t()
    E = rows.shape[0]
    c = lambda x: x.contiguous()
    part = []
    if like.obj is not None:
        Do = like.obj.qpos.shape[1]
        part += [Do, Do, 3, 4]
    if like.body is not None:
        part += [3, 4, 3, 3]
    qpos, qvel, root_pos, root_quat, *p, anc_p, _ = torch.split(
        rows, [D, D, 3, 4, *part, 3 * S, D], dim=1)
    obj, body = like.obj, like.body
    if like.obj is not None:
        obj = TreeState(qpos=c(p[0]), qvel=c(p[1]), root_pos=c(p[2]), root_quat=c(p[3]))
        p = p[4:]
    if like.body is not None:
        body = FreeBodyState(pos=c(p[0]), quat=c(p[1]), linvel=c(p[2]), angvel=c(p[3]))
    return engine.SceneState(
        robot=TreeState(qpos=c(qpos), qvel=c(qvel), root_pos=c(root_pos),
                        root_quat=c(root_quat)),
        obj=obj, body=body,
        anchors=contact.AnchorState(point=c(anc_p.reshape(E, S, 3)),
                                    body=c(anc_b.t())))


# ----------------------------------------------------------------------
# launch
# ----------------------------------------------------------------------

def launch_packed(scene: engine.SceneSpec, buf, anc_b, n_steps: int):
    """Launch the scene's kernel on an env-minor state (see
    :func:`pack_state`); returns new (buf, anc_b) of the same layout.  CUDA
    tensors only."""
    kind = variant(scene)
    dims = _dims(scene)
    S = dims[2]
    rows = _rows(kind, dims)
    if not (buf.is_cuda and anc_b.is_cuda and buf.device == anc_b.device):
        raise ValueError("launch_packed needs CUDA tensors on one device")
    if buf.dtype != torch.float32 or anc_b.dtype != torch.int32:
        raise TypeError(f"state must be f32 / i32, got {buf.dtype} / {anc_b.dtype}")
    E = buf.shape[1]
    if buf.shape != (rows, E) or anc_b.shape != (S, E) or E < 1:
        raise ValueError(f"state shapes {tuple(buf.shape)} / {tuple(anc_b.shape)} "
                         f"do not match ({rows}, E) / ({S}, E)")
    if not (buf.is_contiguous() and anc_b.is_contiguous()):
        raise ValueError("state buffers must be contiguous")
    check_scene(scene)

    packed = _packed(scene)
    bias = packed["bias"]
    lib_def = library(kind, dims, bias)
    lib = lib_def.load()
    got = tuple(lib.fis_dims(i) for i in range(len(dims)))
    if got != tuple(dims):
        raise RuntimeError(f"{kind} library was built for sizes {got}, not {dims}")
    spec = packed["spec"]
    if spec.nbytes != lib.fis_spec_bytes() or rows != lib.fis_state_rows():
        raise RuntimeError(
            f"packing disagrees with the kernel: spec {spec.nbytes} vs "
            f"{lib.fis_spec_bytes()} bytes, rows {rows} vs {lib.fis_state_rows()}")
    grids = scene.obj_grids is not None
    if lib_def.path not in _CONFIG_CHECKED:
        cfg = launch_config(E, dims, scene.free_body is not None, bias)
        if kind in ("b1a", "b1d"):
            got = tuple(lib.fis_launch_config(i) for i in range(4))
            want = (cfg["envs_per_block"], cfg["threads"], cfg["dynamic_smem_bytes"],
                    cfg["envs_per_warp"])
        else:
            got = tuple(lib.fis_launch_config(i) for i in range(3))
            want = (cfg["warps_per_block"], cfg["threads"], cfg["dynamic_smem_bytes"])
        if got != want:
            raise RuntimeError(f"launch configuration disagrees with the kernel: {got} vs {cfg}")
        _CONFIG_CHECKED.add(lib_def.path)
    if kind not in ("b1a", "b1d"):
        tables = packed["tables"]
        if grids:
            if tables[1].shape[1] * 4 != lib.fis_grid_bytes():
                raise RuntimeError(
                    f"grid packing disagrees with the kernel: {tables[1].shape[1] * 4}"
                    f" vs {lib.fis_grid_bytes()} bytes per record")
        if tables[0].shape[1] * 4 != lib.fis_obj_bytes():
            raise RuntimeError(
                f"object packing disagrees with the kernel: {tables[0].shape[1] * 4}"
                f" vs {lib.fis_obj_bytes()} bytes per record")
        if packed["obj_id"].shape[0] != E:
            raise ValueError(f"the scene has {packed['obj_id'].shape[0]} envs, "
                             f"the state {E}")
        on_dev = packed["device"].get(buf.device)
        if on_dev is None:
            on_dev = packed["device"][buf.device] = (
                [torch.as_tensor(t, device=buf.device) for t in tables],
                torch.as_tensor(packed["obj_id"], device=buf.device))
        if grids:
            stack = scene.grid_stack
            if any(x.device != buf.device for x in stack):
                raise ValueError(f"the grid stack lies on {stack.sdf.device}, "
                                 f"the state on {buf.device}")
    with torch.cuda.device(buf.device):
        stream = torch.cuda.current_stream().cuda_stream
        if _UPLOADED.get(lib_def.path) != id(spec):
            err = lib.fis_set_spec(spec.ctypes.data, spec.nbytes, stream)
            if err != 0:
                raise RuntimeError(f"uploading the scene spec failed: CUDA error {err}")
            _UPLOADED[lib_def.path] = id(spec)
        out = torch.empty_like(buf)
        anc_out = torch.empty_like(anc_b)
        if kind in ("b1a", "b1d"):
            err = lib.fis_launch(buf.data_ptr(), anc_b.data_ptr(), out.data_ptr(),
                                 anc_out.data_ptr(), E, int(n_steps), stream)
        elif not grids:
            (table_t,), ids_t = on_dev
            err = lib.fis_launch(buf.data_ptr(), anc_b.data_ptr(), out.data_ptr(),
                                 anc_out.data_ptr(), table_t.data_ptr(),
                                 ids_t.data_ptr(), table_t.shape[0], E,
                                 int(n_steps), stream)
        else:
            (table_t, grid_t), ids_t = on_dev
            err = lib.fis_launch(buf.data_ptr(), anc_b.data_ptr(), out.data_ptr(),
                                 anc_out.data_ptr(), table_t.data_ptr(),
                                 grid_t.data_ptr(), ids_t.data_ptr(), table_t.shape[0],
                                 stack.sdf.data_ptr(), stack.bbox_min.data_ptr(),
                                 stack.voxel_size.data_ptr(), stack.sdf.shape[0], E,
                                 int(n_steps), stream)
    cuda_lib.check_launch(err, f"fused_inner_step ({kind})")
    launch_counts[kind] += 1
    return out, anc_out


def fused_inner_steps(scene: engine.SceneSpec, state: engine.SceneState,
                      pos_targets, n_steps: int) -> engine.SceneState:
    """``n_steps`` inner steps with held targets: one kernel launch for state
    on a CUDA device, the plain version for state that lies on the CPU."""
    if not state.robot.qpos.is_cuda:
        return engine.plain_physics_step(scene, state, pos_targets, n_steps)
    if state.anchors is None:
        E = state.robot.qpos.shape[0]
        state = state._replace(anchors=contact.init_anchors(
            E, scene.spheres.link_idx.shape[0], state.robot.qpos.device))
    buf, anc_b = pack_state(state, pos_targets)
    out, anc_out = launch_packed(scene, buf, anc_b, n_steps)
    return unpack_state(out, anc_out, state)


def fused_physics_step(scene: engine.SceneSpec, state: engine.SceneState,
                       pos_targets) -> engine.SceneState:
    """One physics step (substeps × inner_substeps inner steps) in one
    launch."""
    p = scene.params
    return fused_inner_steps(scene, state, pos_targets,
                             p.substeps * p.inner_substeps)
