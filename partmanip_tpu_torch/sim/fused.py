"""Wrapper of the fused physics inner-step CUDA kernel (variant B1a: robot +
ground + one free box).

Counterpart of ``partmanip_tpu/sim/fused.py`` (``fused_physics_step`` around
the Pallas kernel ``_inner_step_tiled``).  The kernel source is
``csrc/fused_inner_step.cu``; it is compiled with ``nvcc`` for ``sm_90a`` at
first use into a shared library with a plain C interface and loaded with
``ctypes``.  Nothing here needs ``nvcc`` or a GPU at import time.

* :func:`fused_physics_step` — what ``engine.physics_step`` calls: all
  ``substeps × inner_substeps`` inner steps of one control step in ONE launch.
* :func:`fused_inner_steps` — the same with an explicit ``n_steps``
  (``n_steps=1`` is the mode the kernel is held against its plain version in,
  ``engine._inner_step``).
* ``launch_count`` — rises by one wherever the kernel is launched, and
  nowhere else.

State on a CUDA device is launched or raises; only state that lies on the CPU
takes the plain version.  The kernel wants the state env-minor
(``[feature, E]``: a warp's loads are contiguous), the rest of the port keeps
``[E, feature]`` like the JAX package, so the wrapper packs before and
unpacks after each launch (two small transposes per control step).
"""

from __future__ import annotations

import ctypes
import math
import os
import shutil
import subprocess

import numpy as np
import torch

from . import contact, dynamics, engine
from .types import FreeBodyState, HostCache, TreeState

KERNEL_SOURCE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "csrc", "fused_inner_step.cu")
# <checkout>/build, listed in .gitignore
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "build")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# Number of kernel launches made by this module since import / the last reset.
launch_count = 0

_LIBS = {}            # (L, D, S) -> loaded library
_PACKED = HostCache()  # scene.robot.parent tensor -> {key, packed Spec}
_UPLOADED = {}        # (L, D, S) -> id of the packed spec now in constant memory


def reset_launch_count() -> None:
    global launch_count
    launch_count = 0


def _find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                            "bin", "nvcc")
        if os.path.exists(cand):
            nvcc = cand
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found: the fused inner-step kernel is compiled at first "
            "use and needs the CUDA toolkit (PATH or CUDA_HOME)")
    return nvcc


def library_path(L: int, D: int, S: int) -> str:
    return os.path.join(BUILD_DIR, f"libfused_inner_step_L{L}_D{D}_S{S}.so")


def build_command(L: int, D: int, S: int):
    """The nvcc command line that builds the kernel for these array sizes."""
    return [_find_nvcc(), *NVCC_FLAGS, f"-DFIS_L={L}", f"-DFIS_D={D}",
            f"-DFIS_S={S}", "-o", library_path(L, D, S), KERNEL_SOURCE]


def start_build(L: int, D: int, S: int) -> subprocess.Popen:
    """Start nvcc without waiting (so several sources can build side by
    side); hand the process to :func:`load_library` via ``finish_build``."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    return subprocess.Popen(build_command(L, D, S), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def finish_build(proc: subprocess.Popen, L: int, D: int, S: int) -> str:
    """Wait for nvcc, keep its report (registers, spills) beside the
    library, raise if it failed.  Returns the report."""
    report, _ = proc.communicate()
    with open(library_path(L, D, S) + ".ptxas.txt", "w") as f:
        f.write(report)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{report}")
    return report


def load_library(L: int, D: int, S: int):
    """Build (when the library is not there yet) and load the kernel for
    these array sizes."""
    key = (L, D, S)
    if key in _LIBS:
        return _LIBS[key]
    path = library_path(L, D, S)
    if not os.path.exists(path):
        finish_build(start_build(L, D, S), L, D, S)
    lib = ctypes.CDLL(path)
    lib.fis_spec_bytes.restype = ctypes.c_int
    lib.fis_state_rows.restype = ctypes.c_int
    lib.fis_dims.argtypes = [ctypes.c_int]
    lib.fis_dims.restype = ctypes.c_int
    lib.fis_set_spec.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    lib.fis_set_spec.restype = ctypes.c_int
    lib.fis_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                               ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                               ctypes.c_void_p]
    lib.fis_launch.restype = ctypes.c_int
    got = tuple(lib.fis_dims(i) for i in range(3))
    if got != key:
        raise RuntimeError(f"{path} was built for (L, D, S)={got}, not {key}")
    _LIBS[key] = lib
    return lib


# ----------------------------------------------------------------------
# scene description -> the kernel's constant-memory struct
# ----------------------------------------------------------------------

def check_scene(scene: engine.SceneSpec) -> None:
    """Raise with the reason when the kernel cannot run this scene (the
    counterpart of the JAX package's ``fused_supported`` predicate, which
    silently switched paths instead)."""
    engine.check_supported(scene)
    if scene.free_body is None:
        raise NotImplementedError(
            "the fused kernel is built for the robot + ground + free-box "
            "variant (B1a); scenes without a free body are not ported yet")
    if scene.robot.parent.shape[0] != 1:
        raise NotImplementedError(
            "the fused kernel needs one robot topology shared by all envs")
    for name, leaf in zip(scene.free_body._fields, scene.free_body):
        if leaf.shape[0] != 1:
            raise NotImplementedError(
                f"the fused kernel needs a shared free body spec "
                f"(free_body.{name} has env axis {leaf.shape[0]})")


def pack_spec(scene: engine.SceneSpec) -> np.ndarray:
    """The scene as the kernel's ``Spec`` struct (field order of
    ``csrc/fused_inner_step.cu``), a flat array of 4-byte words."""
    r, s, fb, p = scene.robot, scene.spheres, scene.free_body, scene.params
    if float(r.gravity_scale.abs().max()) != 0.0:
        raise NotImplementedError(
            "the fused kernel assumes robot gravity_scale == 0 (gravity "
            "disabled for the arm, as the Franka spec sets it)")

    def i32(x):
        return x.detach().cpu().numpy().astype(np.int32).reshape(-1).view(np.float32)

    def f32(x):
        return x.detach().cpu().numpy().astype(np.float32).reshape(-1)

    def scalars(*xs):
        return np.asarray(xs, np.float32)

    h = p.h
    zeta, kn = p.contact_damping_ratio, p.contact_kn
    m_cube = float(f32(fb.mass)[0])
    cd = lambda m_eff: 2.0 * zeta * math.sqrt(kn * m_eff)
    coef = lambda m_eff: h * cd(m_eff) + h * h * kn
    cdt = 2.0 * contact.ANCHOR_ZETA * math.sqrt(contact.ANCHOR_KS * 0.1)
    words = [
        i32(r.parent[0]), i32(r.joint_type[0]), i32(r.dof_idx[0]),
        i32(r.dof_child[0]), i32(s.link_idx),
        f32(r.origin_pos[0]), f32(r.origin_quat[0]), f32(r.axis[0]),
        f32(r.mass[0] * r.link_mask[0]), f32(r.com[0]), f32(r.inertia[0]),
        f32(r.ancestor[0]),
        f32(r.dof_mask[0]), f32(r.dof_lower[0]), f32(r.dof_upper[0]),
        f32(r.dof_vel_limit[0]), f32(r.dof_effort[0]), f32(r.dof_armature[0]),
        f32(r.dof_damping[0]), f32(r.dof_friction[0]), f32(r.drive_kp[0]),
        f32(r.drive_kd[0]),
        f32(s.offset), f32(s.radius), f32(s.friction), f32(s.sticky),
        f32(fb.mass[:1]), f32(fb.inertia[0]), f32(fb.half_extents[0]),
        f32(fb.gravity_scale[:1]), f32(fb.friction[:1]),
        scalars(h, p.gravity, kn, p.contact_kt, p.max_depenetration_velocity,
                0.1,                              # ground friction
                cd(0.5), cd(m_cube), cd(m_cube / 4.0), coef(0.5), coef(m_cube),
                contact.ANCHOR_KS, cdt, h * cdt + h * h * contact.ANCHOR_KS,
                contact.FREE_BODY_HOLD_VEL, dynamics._FRICTION_VEPS,
                dynamics._BRAKE_BETA, dynamics._SAT_VEPS),
    ]
    return np.ascontiguousarray(np.concatenate(words))


def _packed_spec(scene: engine.SceneSpec) -> np.ndarray:
    """:func:`pack_spec`, done once per scene (it reads the device back)."""
    slot = _PACKED.get(scene.robot.parent, dict)
    # scenes may share a robot and differ in the rest
    key = (scene.params, id(scene.spheres.link_idx), id(scene.free_body.mass))
    if slot.get("key") != key:
        slot.update(key=key, spec=pack_spec(scene))
    return slot["spec"]


def _dims(scene: engine.SceneSpec):
    return (scene.robot.num_links, scene.robot.num_dofs,
            scene.spheres.link_idx.shape[0])


def state_rows(D: int, S: int) -> int:
    """Rows of the env-minor state buffer: qpos, qvel, root pose, body pose
    and velocities, anchor points, targets."""
    return D + D + 3 + 4 + 3 + 4 + 3 + 3 + 3 * S + D


# ----------------------------------------------------------------------
# state layout: [E, feature] (the port) <-> [feature, E] (the kernel)
# ----------------------------------------------------------------------

def pack_state(state: engine.SceneState, pos_targets):
    """SceneState + targets → (f32 [rows, E], i32 [S, E]), env-minor."""
    E = state.robot.qpos.shape[0]
    flat = torch.cat([
        state.robot.qpos, state.robot.qvel, state.robot.root_pos,
        state.robot.root_quat, state.body.pos, state.body.quat,
        state.body.linvel, state.body.angvel,
        state.anchors.point.reshape(E, -1), pos_targets], dim=1)
    return (flat.t().contiguous(),
            state.anchors.body.to(torch.int32).t().contiguous())


def unpack_state(buf, anc_b, like: engine.SceneState) -> engine.SceneState:
    """The inverse of :func:`pack_state` (targets dropped)."""
    D = like.robot.qpos.shape[1]
    S = anc_b.shape[0]
    rows = buf.t()
    E = rows.shape[0]
    qpos, qvel, root_pos, root_quat, bpos, bquat, blin, bang, anc_p, _ = \
        torch.split(rows, [D, D, 3, 4, 3, 4, 3, 3, 3 * S, D], dim=1)
    return engine.SceneState(
        robot=TreeState(qpos=qpos.contiguous(), qvel=qvel.contiguous(),
                        root_pos=root_pos.contiguous(),
                        root_quat=root_quat.contiguous()),
        obj=like.obj,
        body=FreeBodyState(pos=bpos.contiguous(), quat=bquat.contiguous(),
                           linvel=blin.contiguous(), angvel=bang.contiguous()),
        anchors=contact.AnchorState(
            point=anc_p.reshape(E, S, 3).contiguous(),
            body=anc_b.t().contiguous()))


# ----------------------------------------------------------------------
# launch
# ----------------------------------------------------------------------

def launch_packed(scene: engine.SceneSpec, buf, anc_b, n_steps: int):
    """Launch the kernel on an env-minor state (see :func:`pack_state`);
    returns new (buf, anc_b) of the same layout.  CUDA tensors only."""
    global launch_count
    L, D, S = _dims(scene)
    rows = state_rows(D, S)
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

    lib = load_library(L, D, S)
    spec = _packed_spec(scene)
    if spec.nbytes != lib.fis_spec_bytes() or rows != lib.fis_state_rows():
        raise RuntimeError(
            f"packing disagrees with the kernel: spec {spec.nbytes} vs "
            f"{lib.fis_spec_bytes()} bytes, rows {rows} vs {lib.fis_state_rows()}")
    with torch.cuda.device(buf.device):
        stream = torch.cuda.current_stream().cuda_stream
        if _UPLOADED.get((L, D, S)) != id(spec):
            err = lib.fis_set_spec(spec.ctypes.data, spec.nbytes, stream)
            if err != 0:
                raise RuntimeError(f"uploading the scene spec failed: CUDA error {err}")
            _UPLOADED[(L, D, S)] = id(spec)
        out = torch.empty_like(buf)
        anc_out = torch.empty_like(anc_b)
        err = lib.fis_launch(buf.data_ptr(), anc_b.data_ptr(), out.data_ptr(),
                             anc_out.data_ptr(), E, int(n_steps), stream)
    if err != 0:
        raise RuntimeError(f"fused_inner_step launch failed: CUDA error {err}")
    launch_count += 1
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
    """One control step (substeps × inner_substeps inner steps) in one launch."""
    p = scene.params
    return fused_inner_steps(scene, state, pos_targets,
                             p.substeps * p.inner_substeps)
