"""GPU smoke run of the PyTorch / CUDA port: build the kernels from the
sources in this checkout, hold each against its plain PyTorch version on the
card, drive the port's main paths through their entry point, and time the
kernels.

    python3 chip_smoke.py            # needs one NVIDIA GPU and nvcc

Four paths: the grasp_cube evaluation rollout (kernel B1a, robot + free
cube), the open_drawer evaluation of the committed expert checkpoint (kernel
B1b, robot + articulated cabinet), the same evaluation on cabinets whose
handle bars are mesh geoms (kernel B1c, baked-SDF contacts; the cabinets are
generated and baked into a fresh asset root under ``build/``), and the
open_drawer point-cloud DAgger student evaluation (kernels B2, the
sphere-tracing depth camera, and B3, farthest-point sampling, beside B1b's
physics).  Every phase runs once per path; the mesh-handle path also runs
``train``, five PPO iterations at the YAML's full width; the vision path
also ``dagger_train``, DAgger training of the point-cloud student at full
width (B1b, B2 and B3 on its collection); then ``dagger_loop``, the DAgger
loop proof of a normal_state student held against the JAX package's
recorded run; ``tsdf_student``, demos → BC → DAgger of the TSDF student;
``vision_modes``, DAgger of the depth-image and RGB ResNet students on
grasp_cube (B1a, B2 at 1 × 72×128; their teacher a PPO checkpoint written
by the port in the phase) and of the sparse-voxel PointNet student on
open_drawer (B1b, B2, B3 at N = 50³); the vision path's ``kernel_check``
and ``timing`` also hold and time B2 and B3 at those shapes; ``tooling``,
kernel B1d and the bias builds; ``b1e``, kernel B1e (the cabinet, with box
or mesh handles, and grasp_cube's cube in one scene, stepped through
``engine.physics_step``); ``multi_rank``, PPO and the expert's evaluation
on ranks (``parallel/mesh.py``: one NCCL rank, then two gloo ranks sharing
the card).  Prints one
JSON object per phase (``device``, ``bake``, ``build``, then
``kernel_check``, ``small_reference``, ``main_path`` and ``timing`` for
each path, ``train``, the vision path's ``step_breakdown`` and
``dagger_train``, ``dagger_loop``, ``tsdf_student*``, ``vision_modes*``),
then the ``kernels`` line, the
card's name and power limit, and ``{"ok": true, "device": {...}}`` as the
last line.  Any failed phase raises, so the script exits non-zero and prints
no result line.  ``--only`` runs a subset of the phases (for bringing up a
kernel); the default is all.
"""

import argparse
import contextlib
import copy
import json
import math
import os
import random
import shutil
import statistics
import subprocess
import sys
import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

NUM_ENVS = 2048
# one-inner-step tolerances, kernel vs plain version (f32 re-association and
# fma contraction only; the effort-clamped drives amplify them in velocities)
TOL = {"qpos": 1e-5, "qvel": 1e-3, "body_pos": 1e-5, "body_quat": 1e-5,
       "body_linvel": 1e-3, "body_angvel": 1e-2, "obj_qpos": 1e-5, "obj_qvel": 1e-3,
       "anchor_point": 1e-4}
ANCHOR_ID_MATCH = 0.999
ROOT = os.path.dirname(os.path.abspath(__file__))
DRAWER_CKPT = os.path.join(ROOT, "artifacts", "open_drawer_ppo", "expert_r3c_seed389",
                           "model_30000.ckpt")
# the mesh-handle cabinets and their bakes, made anew by every run (the
# checkout's git-ignored build/; the default asset root is shared with the
# JAX package, whose bakes would be read instead)
MESH_ASSETS = os.path.join(ROOT, "build", "chip_smoke_mesh_assets")
H100_F32_FLOPS = 67e12        # non-tensor f32 peak, NVIDIA data sheet (SXM)
H100_BYTES_PER_S = 3.35e12    # HBM3 peak, NVIDIA data sheet (SXM)


_START = time.time()


def emit(phase, **fields):
    """One JSON line of a phase's results, with the script's elapsed
    seconds."""
    print(json.dumps({"phase": phase, **fields,
                      "elapsed_s": round(time.time() - _START, 1)}), flush=True)


def nvidia_smi_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


# ----------------------------------------------------------------------
# the physics paths
# ----------------------------------------------------------------------

def random_policy(env, cfg):
    """A seeded random f32 policy whose actions move the arm."""
    from partmanip_tpu_torch.models.actor_critic import ActorCritic
    cfg["algo"]["model"]["network"]["dtype"] = "f32"
    ac = ActorCritic(env.num_obs["normal_state"], env.num_actions, cfg["algo"]["model"])
    ac.init(11)
    with torch.no_grad():
        ac.actor.head.weight.mul_(60.0)
    return ac.to(env.device)


def expert_policy(env, cfg, dtype=None):
    """The committed open_drawer expert, read from the JAX checkpoint."""
    from partmanip_tpu_torch.models.actor_critic import ActorCritic
    from partmanip_tpu_torch.utils import checkpoint, convert
    j = checkpoint.load_jax(DRAWER_CKPT)
    model_cfg = dict(cfg["algo"]["model"])
    if dtype is not None:
        model_cfg["network"] = dict(model_cfg["network"], dtype=dtype)
    ac = ActorCritic(env.num_obs["normal_state"], env.num_actions, model_cfg)
    ac.load_state_dict(convert.actor_critic_from_jax(j["params"]._asdict()))
    return ac.to(env.device)


@torch.no_grad()
def random_rollout(env, cfg, steps, seed):
    """SceneState and PD targets after ``steps`` control steps of seeded
    random actions (through the kernel, as the main path runs)."""
    from partmanip_tpu_torch.envs import control
    gen = env.make_generator(seed)
    state = env.init_state(env.make_generator(seed + 1))
    state, _ = env.reset(state)
    E, A = env.num_envs, env.num_actions

    def action():
        return torch.rand((E, A), generator=gen, device=env.device) * 2.0 - 1.0

    for _ in range(steps):
        state, *_ = env.step(state, action(), train=True)
    view, _ = env._robot_view(state.sim)
    targets = control.compute_targets(env.ctrl, env.scene.robot, view, action())
    return state.sim, targets


@torch.no_grad()
def expert_rollout(env, cfg, steps, seed):
    """SceneState and PD targets after ``steps`` evaluation steps of the
    committed expert (through the kernel): the gripper on or near the
    handle."""
    from partmanip_tpu_torch.envs import control
    ac = expert_policy(env, cfg)
    state = env.init_state(env.make_generator(seed))
    state, obs = env.reset(state)
    for _ in range(steps):
        state, obs, *_ = env.step(state, ac.act(obs["normal_state"]), train=False)
    view, _ = env._robot_view(state.sim)
    targets = control.compute_targets(env.ctrl, env.scene.robot, view,
                                      ac.act(obs["normal_state"]))
    return state.sim, targets


class Path(NamedTuple):
    """What differs between the physics paths; every phase takes one."""
    kernel: str                 # key of cuda_lib.launch_counts()
    source: str
    replaces: str
    replaces_function: str
    flags: list                 # task / algo flags of the env and the main path
    main_flags: list            # further flags of the main path's run
    part: str                   # the state part beside the robot: body / obj
    rollout: Callable           # (env, cfg, steps, seed) -> (sim, targets)
    rollout_steps: int
    policy: Callable            # (env, cfg) -> f32 policy of small_reference
    draws: Callable             # (RandomState, n) -> object placements
    chain_physics_steps: int    # physics steps of the n-in-one check
    chain_tol: float            # n-in-one vs n launches of one inner step
    min_success: Optional[float]  # floor of Test/succ_rate_max


PATHS = (
    Path(kernel="b1a",
         source="partmanip_tpu_torch/csrc/fused_inner_step.cu",
         replaces="partmanip_tpu/sim/fused.py:744",
         replaces_function="partmanip_tpu/sim/fused.py:_inner_step_tiled",
         flags=["--taskcfg", "grasp_cube", "--algocfg", "ppo"],
         main_flags=["--exp_name", "chip_smoke_seed7"],
         part="body", rollout=random_rollout, rollout_steps=20, policy=random_policy,
         draws=lambda rs, n: (rs.uniform(-0.15, 0.15, (n, 2)).astype(np.float32),
                              rs.uniform(-np.pi, np.pi, n).astype(np.float32)),
         chain_physics_steps=1, chain_tol=0.0, min_success=None),
    # the checkpoint was trained without observation normalisation: the
    # flag flips the YAML default, as for the JAX package's evaluation
    Path(kernel="b1b",
         source="partmanip_tpu_torch/csrc/fused_inner_step_obj.cu",
         replaces="partmanip_tpu/sim/fused.py:825",
         replaces_function="partmanip_tpu/sim/fused.py:_inner_step_tiled "
                           "(has_obj branch, :825-1063)",
         flags=["--taskcfg", "open_drawer", "--algocfg", "ppo",
                "--algo.tricks.use_state_norm"],
         main_flags=["--resume", DRAWER_CKPT, "--exp_name", "chip_smoke_drawer_seed389"],
         part="obj", rollout=expert_rollout, rollout_steps=40,
         policy=lambda env, cfg: expert_policy(env, cfg, dtype="f32"),
         draws=lambda rs, n: (rs.uniform(-0.05, 0.05, (n, 3)).astype(np.float32),
                              rs.uniform(-np.pi / 12, np.pi / 12, n).astype(np.float32)),
         chain_physics_steps=2, chain_tol=0.0, min_success=0.8),
    # the same cabinets with their handle bars as mesh geoms (baked SDFs)
    Path(kernel="b1c",
         source="partmanip_tpu_torch/csrc/fused_inner_step_obj.cu",
         replaces="partmanip_tpu/sim/fused.py:863",
         replaces_function="partmanip_tpu/sim/fused.py:_inner_step_tiled "
                           "(n_grid > 0, :863-890) with its narrowphase "
                           "_grid_narrowphase (:1415)",
         flags=["--taskcfg", "open_drawer", "--algocfg", "ppo",
                "--algo.tricks.use_state_norm", "--task.asset.mesh_handle",
                "--task.asset.assetRoot", MESH_ASSETS],
         main_flags=["--resume", DRAWER_CKPT, "--exp_name", "chip_smoke_mesh_seed389"],
         part="obj", rollout=expert_rollout, rollout_steps=40,
         policy=lambda env, cfg: expert_policy(env, cfg, dtype="f32"),
         draws=lambda rs, n: (rs.uniform(-0.05, 0.05, (n, 3)).astype(np.float32),
                              rs.uniform(-np.pi / 12, np.pi / 12, n).astype(np.float32)),
         chain_physics_steps=2, chain_tol=0.0, min_success=0.8),
)


def make_env(path, num_envs, device="cuda"):
    """(env, merged config) of the path's task at the YAML defaults, built
    by the entry point's factory.  open_drawer shuffles its objects with the
    global ``random``, seeded here so that every env built by this script
    holds the same cabinets."""
    import train_torch
    from partmanip_tpu_torch.config import process_cfgs
    cfg, sim_params = process_cfgs(path.flags + ["--algo.num_envs", str(num_envs)])
    random.seed(0)
    return train_torch.make_env(cfg, sim_params, device), cfg


def check_cases(path, env, cfg):
    """The states a kernel is held and timed on: the path's rollout, and the
    hand-made contact states two plain inner steps in (so that anchors exist
    and the stick branch is live)."""
    from partmanip_tpu_torch.sim import engine
    from partmanip_tpu_torch.utils import contact_states, convert
    rollout = path.rollout(env, cfg, path.rollout_steps, seed=5)
    make = (contact_states.grasp_contact_states if path.part == "body"
            else contact_states.drawer_contact_states)
    st, tg = make(env, env.num_envs, 6)
    sim = convert.scene_state_from_numpy(st, env.device)
    targets = torch.as_tensor(tg, device=env.device)
    sim = engine.plain_physics_step(env.scene, sim, targets, n_steps=2)
    return {f"rollout{path.rollout_steps}": rollout, "contact": (sim, targets)}


# ----------------------------------------------------------------------
# phases
# ----------------------------------------------------------------------

def phase_device():
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; none is available")
    from partmanip_tpu_torch.utils import cuda_lib
    nvcc = subprocess.run([cuda_lib.find_nvcc(), "--version"], capture_output=True,
                          text=True).stdout.strip().splitlines()[-1]
    emit("device", kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=nvidia_smi_line(),
         torch=torch.__version__, cuda=torch.version.cuda, nvcc=nvcc,
         python=sys.version.split()[0])


def phase_build(scenes):
    """Compile every kernel (the physics kernel of every scene, B2 and B3;
    one nvcc per library, all started together) and load the libraries.
    Returns the ptxas lines per kernel."""
    from partmanip_tpu_torch.ops import fps, raymarch_cuda
    from partmanip_tpu_torch.sim import fused
    from partmanip_tpu_torch.utils import cuda_lib
    libs = [fused.scene_library(s) for s in scenes]
    libs += [raymarch_cuda.LIBRARY, fps.LIBRARY]
    t0 = time.time()
    procs = [lib.start() for lib in libs]
    reports = [lib.finish(p) for lib, p in zip(libs, procs)]
    for lib in libs:
        lib.load()
    seconds = time.time() - t0
    ptxas = {lib.name: cuda_lib.ptxas_lines(r) for lib, r in zip(libs, reports)}
    emit("build", seconds=seconds,
         sources=[lib.source.split("/partmanip_tpu_torch/")[-1] for lib in libs],
         flags=cuda_lib.NVCC_FLAGS,
         extra_flags={lib.name: lib.extra_flags for lib in libs if lib.extra_flags},
         defines={lib.name: dict(lib.defines) for lib in libs if lib.defines},
         ptxas=ptxas)
    return ptxas


def _fields(s):
    """The state fields the kernel checks compare, by TOL's names: robot,
    free body or object, anchor points."""
    out = {"qpos": s.robot.qpos, "qvel": s.robot.qvel}
    if s.body is not None:
        out.update(body_pos=s.body.pos, body_quat=s.body.quat, body_linvel=s.body.linvel,
                   body_angvel=s.body.angvel)
    if s.obj is not None:
        out.update(obj_qpos=s.obj.qpos, obj_qvel=s.obj.qvel)
    out["anchor_point"] = s.anchors.point
    return out


def _field_errors(a, b):
    """Max abs difference per state field between two SceneStates, the
    share of equal anchor partner ids, and whether ``a`` is finite."""
    fa, fb = _fields(a), _fields(b)
    errs = {k: float((x - fb[k]).abs().max()) for k, x in fa.items()}
    same = float((a.anchors.body == b.anchors.body).float().mean())
    finite = all(bool(torch.isfinite(x).all()) for x in fa.values())
    return errs, same, finite


# the velocities a tree bias changes within one inner step
BIAS_FIELDS = ("qvel", "obj_qvel", "body_linvel", "body_angvel")
# the kernel's bias effect (bias build minus default build) against the
# plain version's, relative to the plain effect's largest magnitude
BIAS_EFFECT_REL = 1e-2


def _bias_effect(control, sim, targets, out, ref):
    """The bias's effect in one inner step, kernel against plain version:
    ``out`` / ``ref`` are the kernel's and the plain version's step on a
    bias build's scene, and the same step is taken on ``control``
    (the default build's scene).  Per velocity field: the default build's
    error against the plain version with the bias (the control: it must
    exceed TOL on some field, or the check could not tell a kernel that
    drops the bias), the plain effect's size, and, where the control
    fails, the kernel's effect against the plain one, relative."""
    from partmanip_tpu_torch.sim import engine, fused
    ctrl = _fields(fused.fused_inner_steps(control, sim, targets, 1))
    ref_ctrl = _fields(engine.plain_physics_step(control, sim, targets, n_steps=1))
    got, want = _fields(out), _fields(ref)
    report = {}
    for f in BIAS_FIELDS:
        if f not in got:
            continue
        eff_k, eff_p = got[f] - ctrl[f], want[f] - ref_ctrl[f]
        size = float(eff_p.abs().max())
        row = {"control_err": float((ctrl[f] - want[f]).abs().max()), "plain_effect": size}
        if row["control_err"] > TOL[f]:
            row["effect_rel_err"] = float((eff_k - eff_p).abs().max()) / size
        report[f] = row
    return report


@torch.no_grad()
def rounding_shares(n=200_000):
    """The share of ``n`` random inputs on which each formula that
    ``csrc/fused_geom.cuh`` copies from PyTorch's CUDA kernels equals their
    result bit for bit: ``torch.linalg.cross`` as ``fma(a1, b2, -(a2 b1))``
    (beside the plain ``a1 b2 - a2 b1``), ``torch.linalg.norm`` of three
    floats as ``sqrt((x^2 + z^2) + y^2)`` (beside the order x, y, z) and
    ``ops/rotations.quat_rotate`` as separately rounded operations.  A
    PyTorch whose kernels round otherwise lowers the copied formulas'
    shares, and the kernels' contact tests may then flip against the plain
    version."""
    from partmanip_tpu_torch.ops import rotations as rot
    from partmanip_tpu_torch.ops.fps import fma_f32 as fma
    rs = np.random.RandomState(0)
    share = lambda a, b: float((a == b).reshape(n, -1).all(-1).float().mean())
    cr = lambda p, r: torch.stack([fma(p[:, 1], r[:, 2], -(p[:, 2] * r[:, 1])),
                                   fma(p[:, 2], r[:, 0], -(p[:, 0] * r[:, 2])),
                                   fma(p[:, 0], r[:, 1], -(p[:, 1] * r[:, 0]))], -1)
    a, b = (torch.tensor(rs.randn(n, 3).astype(np.float32)) for _ in range(2))
    cross = torch.linalg.cross(a.cuda(), b.cuda()).cpu()
    (a0, a1, a2), (b0, b1, b2) = a.unbind(-1), b.unbind(-1)
    x = torch.tensor(np.abs(rs.randn(n, 3)).astype(np.float32))
    x0, x1, x2 = x.unbind(-1)
    norm = torch.linalg.norm(x.cuda(), dim=-1).cpu()
    q = torch.tensor(rs.randn(n, 4).astype(np.float32))
    v = torch.tensor(rs.randn(n, 3).astype(np.float32))
    t = 2.0 * cr(q[:, :3], v)
    return {"cross_fma(a1,b2,-(a2*b1))": share(cr(a, b), cross),
            "cross_mul_mul_sub": share(torch.stack(
                [a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], -1), cross),
            "norm_sqrt((x^2+z^2)+y^2)": share(torch.sqrt((x0 * x0 + x2 * x2) + x1 * x1), norm),
            "norm_sqrt((x^2+y^2)+z^2)": share(torch.sqrt((x0 * x0 + x1 * x1) + x2 * x2), norm),
            "quat_rotate": share((v + q[:, 3:] * t) + cr(q[:, :3], t),
                                 rot.quat_rotate(q.cuda(), v.cuda()).cpu())}


@torch.no_grad()
def phase_kernel_check(path, env, cases, scene=None, build="default", rounding=True,
                       control=None):
    """The kernel against ``engine._inner_step`` for one inner step on each
    case, plus k inner steps in one launch against k launches of one step
    (k = the inner steps of ``path.chain_physics_steps`` physics steps), on
    ``scene`` (default the env's; ``build`` names it in the output: the
    tooling phase holds the bias builds so).  With ``control`` (the scene
    of the default build) also :func:`_bias_effect` on each case: the
    default build must miss the plain version with the bias by more than
    TOL on some velocity, and on each such velocity the kernel's bias
    effect must be the plain version's within BIAS_EFFECT_REL.  Also
    reports :func:`rounding_shares`, the PyTorch rounding the kernels'
    contact geometry copies."""
    from partmanip_tpu_torch.sim import engine, fused
    from partmanip_tpu_torch.utils import contact_states
    scene = env.scene if scene is None else scene
    p = scene.params
    k = path.chain_physics_steps * p.substeps * p.inner_substeps
    report, worst, failures = {}, 0.0, []
    for name, (sim, targets) in cases.items():
        touching = contact_states.touching_counts(env, sim)
        ref = engine.plain_physics_step(scene, sim, targets, n_steps=1)
        out = fused.fused_inner_steps(scene, sim, targets, 1)
        torch.cuda.synchronize()
        errs, same, finite = _field_errors(out, ref)
        one = fused.fused_inner_steps(scene, sim, targets, k)
        chain = sim
        for _ in range(k):
            chain = fused.fused_inner_steps(scene, chain, targets, 1)
        torch.cuda.synchronize()
        errs_k, same_k, finite_k = _field_errors(one, chain)
        report[name] = {"touching": touching, "max_abs_err": errs,
                        "anchor_ids_equal": same,
                        "anchors": int((ref.anchors.body >= 0).sum()),
                        f"max_abs_err_{k}in1_vs_{k}x1": max(errs_k.values()),
                        "anchor_ids_equal_chain": same_k}
        if control is not None:
            effect = _bias_effect(control, sim, targets, out, ref)
            report[name]["bias_effect"] = effect
            gated = {f: r["effect_rel_err"] for f, r in effect.items() if "effect_rel_err" in r}
            if not gated:
                failures.append(f"{name}: the default build is within TOL of the plain "
                                f"version with the bias on every velocity: {effect}")
            failures += [f"{name}: {f} bias effect off by {e:.3g} of its size > "
                         f"{BIAS_EFFECT_REL:g}" for f, e in gated.items()
                         if not e <= BIAS_EFFECT_REL]
        worst = max(worst, *errs.values())
        if not (finite and finite_k):
            failures.append(f"{name}: non-finite output")
        failures += [f"{name}: {f} err {e:.3g} > {TOL[f]}"
                     for f, e in errs.items() if not e <= TOL[f]]
        if same <= ANCHOR_ID_MATCH:
            failures.append(f"{name}: anchor ids equal in only {same:.5f}")
        if not max(errs_k.values()) <= path.chain_tol or same_k < 1.0:
            failures.append(f"{name}: {k}-in-one launch differs from {k} launches "
                            f"by {max(errs_k.values()):.3g}")
    counts = report["contact"]["touching"]
    dead = [c for c, m in counts.items() if m == 0]
    if dead:
        failures.append(f"contact case has dead branches {dead}: {counts}")
    rounding = rounding_shares() if rounding else None
    emit("kernel_check", variant=path.kernel, build=build, num_envs=env.num_envs,
         library=fused.scene_library(scene).name, tolerances={f: TOL[f] for f in errs},
         bias_effect_rel=None if control is None else BIAS_EFFECT_REL, cases=report, failures=failures, rounding_share_bit_equal=rounding)
    if failures:
        raise RuntimeError(f"kernel_check ({path.kernel}, {build}) failed: "
                           + "; ".join(failures)
                           + f" (PyTorch's rounding, share bit-equal: {rounding})")
    return worst


@torch.no_grad()
def phase_small_reference(path, num_envs=45, steps=3):
    """The env on the card (kernel) against the same env on the CPU (plain
    version) on a small input: same object placements, same f32 policy,
    reset and a few eval steps; obs within 1e-3 (8 inner steps of
    effort-clamped drives per control step), bookkeeping exact.  45 envs
    also put the ragged edge of the last thread block to work."""
    rs = np.random.RandomState(3)
    draws = path.draws(rs, num_envs)
    traces = {}
    for device in ("cuda", "cpu"):
        env, cfg = make_env(path, num_envs, device)
        ac = path.policy(env, cfg)
        state = env.init_state(env.make_generator(0), draws)
        state, obs = env.reset(state, draws)
        trace = [obs["normal_state"].cpu()]
        for _ in range(steps):
            state, obs, *_ = env.step(state, ac.act(obs["normal_state"]), train=False)
            trace.append(obs["normal_state"].cpu())
        traces[device] = (torch.stack(trace), state.progress.cpu())
    (got, gp), (want, wp) = traces["cuda"], traces["cpu"]
    err = float((got - want).abs().max())
    moved = float((got[-1] - got[0]).abs().max())
    shape = (steps + 1, num_envs, env.num_obs["normal_state"])
    ok = (tuple(got.shape) == shape and err <= 1e-3
          and bool(torch.isfinite(got).all()) and torch.equal(gp, wp)
          and moved > 1e-3)
    emit("small_reference", variant=path.kernel, num_envs=num_envs, steps=steps,
         max_abs_obs_err=err, tolerance=1e-3, obs_moved=moved, ok=ok)
    if not ok:
        raise RuntimeError(f"GPU env ({path.kernel}) disagrees with the CPU reference: {err}")


def phase_main_path(path):
    """The evaluation at the YAML defaults through the CLI entry point: 2048
    envs, MLP 512-512-512, 200 steps, one eval round, every physics step
    through the path's kernel and none through another."""
    import train_torch
    from partmanip_tpu_torch.utils import cuda_lib
    cuda_lib.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    runner = train_torch.main(path.flags + path.main_flags
                              + ["--test_only", "--log.mode", "screen"])
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = cuda_lib.launch_counts()
    others = sum(n for v, n in launches.items() if v != path.kernel)
    env, cfg = runner.env, runner.cfg
    T, rounds = env.max_episode_length, cfg["eval_round"]
    expected = rounds * (1 + T * env.control_freq_inv) + 1
    log = runner.last_log
    sim = runner.last_env_state.sim
    finite_state = all(bool(torch.isfinite(x).all())
                       for part in (sim.robot, getattr(sim, path.part)) for x in part)
    hid = cfg["model"]["network"]["hid_dim"]
    succ = log.get("Test/succ_rate_max", float("nan"))
    emit("main_path", variant=path.kernel, num_envs=env.num_envs, hid_dim=hid, steps=T,
         eval_round=rounds, kernel_launches=launches[path.kernel],
         other_kernel_launches=others, expected_launches=expected,
         wall_seconds=wall, env_steps_per_second=rounds * T * env.num_envs / wall,
         succ_rate_max=succ, min_succ_rate_max=path.min_success, metrics=log)
    print(f"Test/succ_rate_max {succ}", flush=True)
    if (env.num_envs, list(hid), T) != (NUM_ENVS, [512, 512, 512], 200):
        raise RuntimeError("main path did not run at the full width of the config")
    if launches[path.kernel] != expected or others != 0:
        raise RuntimeError(f"kernel {path.kernel} launched {launches[path.kernel]} times "
                           f"(others {others}), expected {expected}: not every "
                           f"physics step went through it")
    bad = [k for k, v in log.items() if not np.isfinite(v)]
    if bad or not finite_state or not any(k.startswith("Test/") for k in log):
        raise RuntimeError(f"main path output not finite: {bad}, state ok={finite_state}")
    if path.min_success is not None and not succ >= path.min_success:
        raise RuntimeError(f"Test/succ_rate_max {succ} < {path.min_success}")
    return launches[path.kernel]


TRAIN_ITERATIONS = 5


def phase_train(path):
    """Five PPO iterations on the mesh-handle cabinets through the CLI entry
    point at the YAML's full width (2048 envs, n_steps 8, 5 epochs x 8
    minibatches, MLP 512-512-512 in the default compute dtype): every
    physics step through the path's kernel and none through another,
    finite parameters and Train/* metrics.  Reports the median seconds of
    iterations 2-5 and the env-steps/s they give, then (launches no longer
    counted) one more iteration of the same trainer taken apart: the
    rollout alone and the whole iteration, host clock around synchronised
    work; the update is their difference."""
    import train_torch
    from partmanip_tpu_torch.utils import cuda_lib
    from partmanip_tpu_torch.utils.fetch import fetch_scalars
    cuda_lib.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    runner = train_torch.main([
        "--taskcfg", "open_drawer", "--algocfg", "ppo", "--task.asset.mesh_handle",
        "--task.asset.assetRoot", MESH_ASSETS,
        "--algo.max_iterations", str(TRAIN_ITERATIONS),
        "--exp_name", "chip_smoke_train_seed7", "--log.mode", "screen"])
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = cuda_lib.launch_counts()
    others = sum(n for v, n in launches.items() if v != path.kernel)
    cfg, env = runner.cfg, runner.env
    # the first reset, then n_steps control steps per iteration (no eval or
    # reset in between: eval_frequence is far above the iteration count)
    expected = 1 + runner.curr_iter * runner.n_steps * env.control_freq_inv
    log = runner.last_log
    train_keys = [k for k in log if k.startswith("Train/")]
    bad = [k for k in train_keys if not np.isfinite(log[k])]
    finite = all(bool(torch.isfinite(p).all()) for p in runner.ac.parameters())
    secs = runner.iteration_seconds
    median = statistics.median(secs[1:])
    width = (env.num_envs, runner.n_steps, runner.n_updates, runner.num_mini_batches,
             list(cfg["model"]["network"]["hid_dim"]),
             cfg["model"]["network"].get("dtype", "bf16"))
    ts, env_state = runner.init_state(7)
    t0 = time.perf_counter()
    ts, env_state, _, _ = runner._rollout(ts, env_state)
    torch.cuda.synchronize()
    rollout_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    fetch_scalars(runner._train_iteration(ts, env_state, float(runner._lr_now()))[2])
    iteration_s = time.perf_counter() - t0
    emit("train", variant=path.kernel, iterations=runner.curr_iter, width=width,
         kernel_launches=launches[path.kernel], other_kernel_launches=others,
         expected_launches=expected, iteration_seconds=secs,
         seconds_per_iteration_median_2_to_5=median,
         env_steps_per_second=runner.n_steps * env.num_envs / median, wall_seconds=wall,
         finite_parameters=finite,
         breakdown={"rollout_s": rollout_s, "iteration_s": iteration_s,
                    "update_s": iteration_s - rollout_s}, metrics=log)
    print(f"train: {median:.4f} s per iteration (median of 2-{runner.curr_iter}), "
          f"{runner.n_steps * env.num_envs / median:.1f} env-steps/s", flush=True)
    if width != (NUM_ENVS, 8, 5, 8, [512, 512, 512], "bf16") or runner.curr_iter != TRAIN_ITERATIONS:
        raise RuntimeError(f"train phase did not run at full width: {width}")
    if launches[path.kernel] != expected or others != 0:
        raise RuntimeError(f"train: kernel {path.kernel} launched {launches[path.kernel]} "
                           f"times (others {others}), expected {expected}")
    if bad or not finite or not train_keys:
        raise RuntimeError(f"train output not finite: {bad}, parameters ok={finite}")
    return median


def inner_step_flops(env, touching):
    """f32 operations of ONE inner step of one env, counted from the
    kernel's source (csrc/fused_inner_step.cu, csrc/fused_inner_step_obj.cu;
    a multiply-add counts 2), with this run's contact counts (``touching``
    of ``contact_states.touching_counts``, over all envs): the force / anchor
    / J^T N J work runs only for touching spheres and (sphere, box) pairs."""
    scene = env.scene
    E = env.num_envs
    ROT, QMUL, JCOL, SDF = 30, 28, 26, 40    # quat_rotate, quat_mul, one Jacobian column
    tri = lambda n: n * (n + 1) / 2

    def fk_mass(L, D, tri_sum):              # FK, then the mass matrix
        return (L * (2 * ROT + 2 * QMUL + 40) + D * ROT
                + L * (ROT + 3 + 30 + 90) + L * D * (JCOL + 3 + 15) + tri_sum * 22)

    def tree(D):                             # Cholesky solve and integration
        return 2 * (D ** 3 / 3 + 2 * D ** 2) * 2 + D * 60 + 2 * D * D

    def bias(L, D):                          # fused_bias.cuh: v, w; anchors; jdot, gyro; tau
        if not scene.params.coriolis:
            return L * 3 + L * D * 8
        return (L * D * 12 + D * D * (JCOL + 6) + D * 9
                + L * D * 45 + L * 60 + L * D * 12)

    L, D = scene.robot.num_links, scene.robot.num_dofs
    S = env.spheres.link_idx.shape[0]
    n_anc = scene.robot.ancestor[0].cpu().numpy().sum(1)       # [L]
    sph_anc = n_anc[env.spheres.link_idx.cpu().numpy()]
    robot = (fk_mass(L, D, float(tri(n_anc).sum())) + tree(D)
             + S * (ROT + 3) + float(sph_anc.sum()) * (JCOL + 6))
    from partmanip_tpu_torch.sim import fused
    if fused.needs_bias(scene):
        robot += bias(L, D)
    spheres = (touching["ground"] + touching.get("cube", 0) + touching.get("boxes", 0)
               + touching.get("grids", 0)) / E
    # the free cube: its narrowphase per sphere (once, as the function needs
    # it), a partner more per touching sphere, the body integration
    cube = 0 if scene.free_body is None else S * (2 * ROT + 40) + 8 * (ROT + 3) + 200
    if scene.obj_tree is None and scene.free_body is None:
        # B1d: the ground is the only partner, nothing beside the robot
        partners, rest = 1, 0
    elif scene.obj_tree is None:
        partners, rest = 2, cube
    else:
        Lo, Do = scene.obj_tree.num_links, scene.obj_tree.num_dofs
        o_anc = scene.obj_tree.ancestor.cpu().numpy().sum(-1)  # [E, Lo]
        g_act = float(scene.obj_boxes.geom_mask.sum(-1).float().mean())
        boxes = scene.obj_boxes.link_idx.shape[-1] * (ROT + QMUL + 3)
        per_pair = ((2 * ROT + SDF + 3) + Do * (JCOL + 12) + Do * 12 + 12 + 70 + 27
                    + Do * 24 + 9 + (Do * (Do + 1) // 2) * 3)
        partners = 1
        rest = (fk_mass(Lo, Do, float(tri(o_anc).sum(-1).mean())) + tree(Do) + boxes
                + g_act * S * (ROT + 3 + SDF) + touching["box_pairs"] / E * per_pair
                + (bias(Lo, Do) if fused.needs_bias(scene) else 0) + cube)
        partners += scene.free_body is not None
        if scene.obj_grids is not None:
            # mesh-SDF geoms: poses; per (sphere, live geom) the local point
            # and a lookup (inside its grid: index 6, cell and fractions 6,
            # value and gradient 60, norm 6; outside: index and test 12);
            # per touching pair as a box pair with the lookup for the SDF
            # and the normal's rotation and normalisation
            QUERY_IN, QUERY_OUT = 78, 12
            K = scene.obj_grids.link_idx.shape[-1]
            k_act = float(scene.obj_grids.geom_mask.sum(-1).float().mean())
            inside = touching["grid_queries_inside"] / E
            per_grid_pair = per_pair - SDF + QUERY_IN + ROT + 10
            rest += (K * (ROT + QMUL + 3) + k_act * S * (ROT + 3) + inside * QUERY_IN
                     + (k_act * S - inside) * QUERY_OUT
                     + touching["grid_pairs"] / E * per_grid_pair)
    per_touch = (partners * 70 + 120 + 45 + D * (JCOL + 15)
                 + float(tri(sph_anc).mean()) * 6 + float(sph_anc.mean()) * 6)
    return robot + spheres * per_touch + rest


@torch.no_grad()
def phase_timing(path, env, sim, targets, contact_case, repeats=20):
    """Kernel, wrapper and plain-version times at the main path's shapes
    (E = 2048, one physics step = substeps x inner_substeps inner steps per
    launch), by CUDA events, on the path's rollout states; the kernel also
    on the hand-made contact states, where the contact branches run; and
    :func:`warp_kernel_timing` (device time, env sweep, occupancy)."""
    from partmanip_tpu_torch.sim import engine, fused
    from partmanip_tpu_torch.utils import contact_states
    p = env.scene.params
    n = p.substeps * p.inner_substeps

    buf, anc_b = fused.pack_state(sim, targets)
    for _ in range(3):
        fused.launch_packed(env.scene, buf, anc_b, n)
    kernel_ms = _timed(lambda: fused.launch_packed(env.scene, buf, anc_b, n), repeats)
    kernel1_ms = _timed(lambda: fused.launch_packed(env.scene, buf, anc_b, 1), repeats)
    wrapper_ms = _timed(lambda: fused.fused_physics_step(env.scene, sim, targets), repeats)
    cbuf, canc = fused.pack_state(*contact_case)
    contact_ms = _timed(lambda: fused.launch_packed(env.scene, cbuf, canc, n), repeats)
    engine.plain_physics_step(env.scene, sim, targets)
    plain_ms = _timed(lambda: engine.plain_physics_step(env.scene, sim, targets), 3)

    E = env.num_envs
    touching = contact_states.touching_counts(env, sim)
    flops = inner_step_flops(env, touching) * n * E
    # state in and out; B1b also reads its object table and ids once; B1c
    # its grid records and the 8 cells of every query inside a grid
    packed = fused._packed(env.scene)
    nbytes = 2 * (buf.numel() * 4 + anc_b.numel() * 4)
    if "tables" in packed:
        nbytes += sum(t.nbytes for t in packed["tables"]) + packed["obj_id"].nbytes
    if env.scene.obj_grids is not None:
        nbytes += touching["grid_queries_inside"] * 8 * 4
    ops_ms, bytes_ms = flops / H100_F32_FLOPS * 1e3, nbytes / H100_BYTES_PER_S * 1e3
    out = {"ms": kernel_ms, "kernel_ms": kernel_ms, "one_inner_step_ms": kernel1_ms,
           "control_step_ms": env.control_freq_inv * kernel_ms,
           "contact_case_ms": contact_ms, "wrapper_ms": wrapper_ms,
           "plain_ms": plain_ms,
           "bound_ms": max(ops_ms, bytes_ms),
           "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
           "bound_operations_ms": ops_ms, "bound_bytes_ms": bytes_ms,
           "flops_per_launch": flops, "bytes_per_launch": nbytes,
           "touching": touching, "num_envs": E, "n_steps": n, "library_ms": None}
    out.update(warp_kernel_timing(env.scene, buf, anc_b, n))
    return out


SWEEP_ENVS = (256, 1024, 2048, 4096, 16384)


def repeat_envs(scene, idx):
    """The scene with its per-env object specs taken at ``idx`` (env e of
    the new scene is env idx[e] of this one; shared leaves stay).  A free-
    body scene has none and comes back as it is."""
    if scene.obj_tree is None:
        return scene
    E0 = scene.obj_tree.parent.shape[0]

    def take(part):
        if part is None:
            return None
        return type(part)(*[x[idx] if x.shape[0] == E0 else x for x in part])
    return scene._replace(obj_tree=take(scene.obj_tree), obj_boxes=take(scene.obj_boxes),
                          obj_grids=take(scene.obj_grids))


# the kernel function of each physics variant, as the profiler names it
KERNEL_FUNCTIONS = {"b1a": "fused_inner_step_kernel", "b1b": "fused_inner_step_obj_kernel",
                    "b1c": "fused_inner_step_obj_kernel", "b1d": "fused_inner_step_kernel",
                    "b1e": "fused_inner_step_obj_kernel"}


@torch.no_grad()
def warp_kernel_timing(scene, buf, anc_b, n, repeats=10):
    """The physics kernels that split an env over lanes (B1a a half-warp,
    B1b / B1c a warp): the launch configuration (the launch's inputs), the
    blocks the runtime keeps resident per SM (its occupancy query), the
    kernel's device time at the main path's shapes (``torch.profiler``),
    and its time per launch at each env count of SWEEP_ENVS (per call, as
    ``ms``, and queued back to back), the state made by repeating the
    2048-env state's columns (and the envs' cabinets alike)."""
    from partmanip_tpu_torch.sim import fused
    E0 = buf.shape[1]
    blocks_per_sm = fused.occupancy(scene)
    cfg = fused.launch_config(E0, fused._dims(scene), scene.free_body is not None,
                              fused.needs_bias(scene))
    device_ms, _ = _device_ms(lambda: fused.launch_packed(scene, buf, anc_b, n),
                              [KERNEL_FUNCTIONS[fused.variant(scene)]])
    by_envs, queued_by_envs, keep = {}, {}, []
    for E in SWEEP_ENVS:
        idx = torch.arange(E, device=buf.device) % E0
        scene_e = repeat_envs(scene, idx)
        buf_e, anc_e = buf[:, idx].contiguous(), anc_b[:, idx].contiguous()
        keep.append(scene_e)             # no id() of a packed scene is reused
        for _ in range(2):
            fused.launch_packed(scene_e, buf_e, anc_e, n)
        by_envs[str(E)] = _timed(lambda: fused.launch_packed(scene_e, buf_e, anc_e, n), repeats)
        queued_by_envs[str(E)] = _timed_queued(
            lambda: fused.launch_packed(scene_e, buf_e, anc_e, n), repeats)
    return {"ms_by_envs": by_envs, "queued_ms_by_envs": queued_by_envs,
            "kernel_device_ms": device_ms, "launch_config": cfg,
            "occupancy": {"blocks_per_sm": blocks_per_sm}}


def _timed_queued(fn, reps):
    """Milliseconds per call of ``fn`` over ``reps`` calls queued back to
    back between two CUDA events: the device's time per launch wherever the
    host enqueues faster than the kernel runs (the per-call events of
    :func:`_timed` also hold the host's time to reach the launch)."""
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    fn()
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def _timed(fn, reps):
    """Median of ``reps`` CUDA-event timings of ``fn`` (ms)."""
    times = []
    for _ in range(reps):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


# ----------------------------------------------------------------------
# the vision path: the point-cloud DAgger student on open_drawer
# ----------------------------------------------------------------------

VISION_FLAGS = ["--taskcfg", "open_drawer", "--algocfg", "dagger", "--algo.obs_mode",
                "depth_pc", "--algo.model.network.name", "PointNet",
                "--algo.teacher", DRAWER_CKPT]
VISION_ENVS = 16              # cfg/algos/dagger.yaml num_envs
K_POINTS = 1024
FAR, EPS = 100.0, 1e-3        # the renderer's defaults (ops/raymarch.render_depth)
SURFACE_TOL = 1e-2            # 10 eps: the renderer's hit test
VISION_KERNELS = {
    "b2": dict(name="raymarch_b2", source="partmanip_tpu_torch/csrc/raymarch.cu",
               replaces="partmanip_tpu/ops/raymarch_tpu.py:241",
               replaces_function="partmanip_tpu/ops/raymarch_tpu.py:_march_kernel "
                                 "(:143), launched by _render_tpu (:233)"),
    "b3": dict(name="fps_b3", source="partmanip_tpu_torch/csrc/fps.cu",
               replaces="partmanip_tpu/ops/fps.py:80",
               replaces_function="partmanip_tpu/ops/fps.py:farthest_point_sampling_pallas "
                                 "(:47), body kernel (:63)"),
}


def make_vision_env(num_envs, device="cuda", im_scale=1):
    """(env, merged config) of the vision path, built by the entry point's
    factory after the same ``random.seed`` as :func:`make_env`."""
    import train_torch
    from partmanip_tpu_torch.config import process_cfgs
    cfg, sim_params = process_cfgs(VISION_FLAGS + ["--algo.num_envs", str(num_envs)])
    cfg["task"]["im_scale"] = im_scale
    random.seed(0)
    return train_torch.make_env(cfg, sim_params, device), cfg


@torch.no_grad()
def vision_cases():
    """Scene primitives at 16 envs: the committed expert's rollout 40 steps
    in (gripper at the handle) and a reset state."""
    from partmanip_tpu_torch.envs import vision
    env, cfg = make_env(PATHS[1], VISION_ENVS)
    sim40, _ = expert_rollout(env, cfg, 40, seed=5)
    state, _ = env.reset(env.init_state(env.make_generator(9)))
    return {"rollout40": vision.scene_prims(env, sim40),
            "reset": vision.scene_prims(env, state.sim)}


def _depth_errors(got, want):
    err = (got - want).abs()
    both = (got < FAR) & (want < FAR)
    return {"bit_equal": float((got == want).float().mean()),
            "max_abs_err": float(err.max()),
            "worst_both_hit": float(err[both].max()) if bool(both.any()) else 0.0,
            "hit_share": float((want < FAR).float().mean()),
            "hit_flips": int(((got < FAR) != (want < FAR)).sum()),
            "finite": bool(torch.isfinite(got).all())}


def render_passes(rig, c2f):
    """(name, ray table) of each pass of one render: the coarse pass and the
    refine, or the exact march."""
    from partmanip_tpu_torch.ops import raymarch_cuda
    full = ("full", raymarch_cuda.ray_table(rig.poses, rig.intrinsic, rig.im_h, rig.im_w,
                                            "cuda"))
    if not c2f:
        return [full]
    coarse = raymarch_cuda.ray_table(rig.poses, raymarch_cuda.coarse_intrinsic(rig.intrinsic),
                                     rig.im_h // 4, rig.im_w // 4, "cuda")
    return [("coarse", coarse), full]


def kept_shares(rig, prims, c2f):
    """Per pass, the share of (tile, primitive) pairs that culling keeps,
    of all pairs and of the live ones."""
    from partmanip_tpu_torch.ops import raymarch
    out = {}
    for name, rays in render_passes(rig, c2f):
        kept = raymarch.tile_masks(prims, rays, FAR)
        live = raymarch.tile_masks(prims, rays, FAR, cull=False)
        out[name] = {"tiles": rays.cos_t.shape[1], "of_all": float(kept.float().mean()),
                     "of_live": float(kept.sum() / live.sum())}
    return out


def fps_cases(render_clouds):
    """(points, k) of every case B3 is held on: the render clouds, a random
    cloud and one with a 60 % zero cluster at the main path's shape, and
    small and odd ones (N = 1, 7, 1000 and 442,369, which is not a multiple
    of the cluster; an all-zero row; -0.0 zeros; index 0 not zero; a 0.1 m
    grid with exact ties; k above the number of distinct points)."""
    rs = np.random.RandomState(4)
    B, N, _ = render_clouds["reset_c2f"].shape

    def cuda(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float32), device="cuda")

    def zeroed(a, share, signed=False):
        zero = rs.rand(*a.shape[:2]) < share
        z = np.where(rs.rand(*a.shape) < 0.5, -0.0, 0.0) if signed else np.zeros_like(a)
        return np.where(zero[..., None], z, a), zero

    cases = {tag: (pts, K_POINTS) for tag, pts in render_clouds.items()}
    rand = rs.randn(B, N, 3)
    cases["random"] = (cuda(rand), K_POINTS)
    cases["random_zero_cluster"] = (cuda(zeroed(rand, 0.6)[0]), K_POINTS)
    cases["n1"] = (cuda(rs.randn(2, 1, 3)), 16)
    cases["n7"] = (cuda(rs.randn(2, 7, 3)), 16)
    cases["n1000_k_above_distinct"] = (cuda(zeroed(rs.randn(3, 1000, 3), 0.3)[0]), K_POINTS)
    cases["n442369_zero87"] = (cuda(zeroed(rs.randn(2, 442_369, 3), 0.87)[0]), K_POINTS)
    cases["all_zero"] = (cuda(np.zeros((2, 5000, 3))), 64)
    neg, _ = zeroed(rs.randn(2, 50_000, 3), 0.85, signed=True)
    neg[:, 0] = -0.0
    cases["negative_zeros"] = (cuda(neg), K_POINTS)
    first, _ = zeroed(rs.randn(2, 50_000, 3), 0.87)
    first[:, 0] = rs.randn(2, 3)
    first[:, 1] = 0.0
    cases["index0_not_zero"] = (cuda(first), K_POINTS)
    g = np.stack(np.meshgrid(*[np.arange(20.0)] * 3, indexing="ij"), -1).reshape(-1, 3) * 0.1
    cases["grid_ties"] = (cuda(np.stack([g, g[rs.permutation(len(g))]])), K_POINTS)
    few = zeroed(rs.randn(300, 3)[rs.randint(0, 300, (2, 20_000))], 0.5)[0]
    cases["few_distinct"] = (cuda(few), K_POINTS)
    return cases


@torch.no_grad()
def vision_kernel_check(rig, cases):
    """B2 against its plain version (exact and coarse-to-fine, culled) on
    each case at full width, bit for bit, with the share of (tile,
    primitive) pairs each pass keeps; B3 against its plain version on the
    clouds of those renders and on the cases of :func:`fps_cases`, index for
    index, its compacted lengths against ``fps.compaction_plain``.  Returns
    (B2's and B3's worst error)."""
    from partmanip_tpu_torch.ops import fps, raymarch, raymarch_cuda, tsdf
    renders, clouds, failures = {}, {}, []
    for name, prims in cases.items():
        for c2f in (False, True):
            tag = f"{name}_{'c2f' if c2f else 'exact'}"
            args = (prims, rig.poses, rig.intrinsic, rig.im_h, rig.im_w)
            got = raymarch_cuda.render_with(raymarch_cuda.march, *args, coarse_to_fine=c2f)
            want = raymarch_cuda.render_with(raymarch.march_plain, *args, coarse_to_fine=c2f)
            torch.cuda.synchronize()
            e = renders[tag] = {**_depth_errors(got, want),
                                "kept": kept_shares(rig, prims, c2f)}
            if not (e["bit_equal"] == 1.0 and e["finite"]):
                failures.append(f"B2 {tag}: {e}")
            clouds[tag] = tsdf.workspace_points(rig.tsdf_spec, got)
    sampled, b3_worst = {}, 0.0
    for tag, (pts, k) in fps_cases(clouds).items():
        _, want = fps.farthest_point_sampling_plain(pts, k)
        kept = fps.compaction_plain(pts).sum(1)
        # the cluster size the wrapper picks; some cases also on 1 and 8 CTAs
        sizes = [None] + ([1, 8] if tag in ("reset_c2f", "grid_ties", "n442369_zero87")
                          else [])
        for cluster in sizes:
            got, counts = fps.launch(pts, k, cluster)
            got = got.long()
            torch.cuda.synchronize()
            rows = pts.gather(1, got[..., None].expand(-1, -1, 3))
            ref = pts.gather(1, want[..., None].expand(-1, -1, 3))
            err = float((rows - ref).abs().max())
            b3_worst = max(b3_worst, err)
            name = tag if cluster is None else f"{tag}_cluster{cluster}"
            sampled[name] = {
                "rows": pts.shape[0], "points": pts.shape[1], "k": k,
                "cluster": cluster or fps.cluster_for(*pts.shape[:2], pts.device),
                "index_match": float((got == want).float().mean()),
                "rows_equal": int((got == want).all(dim=1).sum()),
                "zero_points": float((pts == 0).all(-1).float().mean()),
                "compacted": counts.tolist(), "compacted_equal": torch.equal(counts.long(), kept),
                "max_abs_err": err}
            if not (torch.equal(got, want) and sampled[name]["compacted_equal"]):
                failures.append(f"B3 {name}: {sampled[name]}")
    B, N, _ = clouds["reset_c2f"].shape
    emit("kernel_check", variant="b2+b3", num_envs=B, image=[rig.num_view, rig.im_h, rig.im_w],
         points=N, k=K_POINTS, tolerances={"render": "bit-equal", "fps": "index-exact"},
         renders=renders, fps=sampled, failures=failures)
    if failures:
        raise RuntimeError("kernel_check (b2, b3) failed: " + "; ".join(failures))
    return max(r["max_abs_err"] for r in renders.values()), b3_worst


@torch.no_grad()
def vision_small_reference(num_envs=4, steps=3, im_scale=8):
    """The vision env on the card (kernels) against the plain pipeline on
    the CPU on the same scene states: reset and a few steps of the expert's
    f32 policy at ``im_scale`` 8.  For each state the card's ``depth_pc``
    observation must equal its own pipeline rerun (render, crop, B3) bit for
    bit, pick the same FPS indices as the CPU pipeline (flips counted), and
    lie within OBS_TOL of the CPU observation at every point: the scene
    primitives (forward kinematics) round differently on the two devices,
    so the points may differ in the last bits (worst seen 1.5e-6)."""
    from partmanip_tpu_torch.config import process_cfgs
    from partmanip_tpu_torch.envs import vision
    from partmanip_tpu_torch.ops import fps, tsdf
    from partmanip_tpu_torch.utils import convert
    OBS_TOL = 1e-5

    def cloud(e, sim):
        rig = e.vision_rig
        depth = vision.render_depth(rig, vision.scene_prims(e, sim))
        return tsdf.workspace_points(rig.tsdf_spec, depth)

    def gather(pts, idx):
        return pts.gather(1, idx[..., None].expand(-1, -1, 3))

    env, _ = make_vision_env(num_envs, "cuda", im_scale)
    cpu_env, _ = make_vision_env(num_envs, "cpu", im_scale)
    ppo_cfg, _ = process_cfgs(PATHS[1].flags)
    ac = expert_policy(env, ppo_cfg, dtype="f32")
    draws = PATHS[1].draws(np.random.RandomState(3), num_envs)
    state = env.init_state(env.make_generator(0), draws)
    state, obs = env.reset(state, draws)
    flips, worst, nonzero, rerun_equal, finite = [], 0.0, [], True, True
    for t in range(steps + 1):
        got = obs["depth_pc"].reshape(num_envs, K_POINTS, 3)
        pts = cloud(env, state.sim)
        idx = fps.farthest_point_sampling_cuda(pts, K_POINTS).long()
        rerun_equal = rerun_equal and torch.equal(gather(pts, idx), got)
        sim = convert.scene_state_from_numpy(convert.scene_state_to_numpy(state.sim))
        cpu_pts = cloud(cpu_env, sim)
        _, cpu_idx = fps.farthest_point_sampling_plain(cpu_pts, K_POINTS)
        flips.append((idx.cpu() != cpu_idx).sum(1).tolist())
        err = (got.cpu() - gather(cpu_pts, cpu_idx)).abs()
        worst = max(worst, float(err.max()))
        nonzero.append((got.abs().sum(-1) > 0).float().mean(1).tolist())
        finite = finite and bool(torch.isfinite(got).all()) and bool(torch.isfinite(cpu_pts).all())
        if t < steps:
            state, obs, *_ = env.step(state, ac.act(obs["normal_state"]), train=False)
    n_flips = sum(map(sum, flips))
    ok = (n_flips == 0 and worst <= OBS_TOL and rerun_equal and finite
          and tuple(obs["depth_pc"].shape) == (num_envs, 3 * K_POINTS))
    emit("small_reference", variant="b2+b3", num_envs=num_envs, steps=steps,
         image=[cpu_env.vision_rig.num_view, cpu_env.vision_rig.im_h,
                cpu_env.vision_rig.im_w],
         index_flips_per_env=flips, max_abs_obs_err=worst, obs_equal_to_rerun=rerun_equal,
         nonzero_share=nonzero, tolerance={"point": OBS_TOL, "index_flips": 0}, ok=ok)
    if not ok:
        raise RuntimeError(f"GPU vision obs disagree with the CPU pipeline: {n_flips} "
                           f"index flips, worst point error {worst}, rerun equal "
                           f"{rerun_equal}")


def vision_main_path():
    """The DAgger evaluation through the CLI entry point at the YAML's full
    width: 16 envs, 3 views of 288×512, coarse to fine, 1024 points, the
    seeded PointNet student, 200 steps, one eval round.  Every render through
    B2, every FPS through B3, every physics step through B1b."""
    import train_torch
    from partmanip_tpu_torch.envs import vision
    from partmanip_tpu_torch.ops import raymarch
    from partmanip_tpu_torch.utils import cuda_lib
    cuda_lib.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    runner = train_torch.main(VISION_FLAGS + [
        "--test_only", "--algo.eval_round", "1", "--exp_name", "chip_smoke_dagger_seed3",
        "--log.mode", "screen"])
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = cuda_lib.launch_counts()
    env, cfg, rig = runner.env, runner.cfg, runner.env.vision_rig
    T, rounds = env.max_episode_length, cfg["eval_round"]
    n_obs = 1 + rounds * (1 + T)                    # init_state's reset, then each round
    c2f = rig.coarse_to_fine and rig.im_h % 4 == 0 and rig.im_w % 4 == 0
    expected = {"b2": n_obs * (2 if c2f else 1), "b3": n_obs,
                "b1b": 1 + rounds * (1 + T * env.control_freq_inv), "b1a": 0, "b1c": 0, "b1d": 0,
                "b1e": 0}
    log = runner.last_log
    obs = runner.last_obs
    pts = obs.reshape(env.num_envs, K_POINTS, 3)
    live = pts.abs().sum(-1) > 0
    with torch.no_grad():
        sdf = raymarch.scene_sdf(vision.scene_prims(env, runner.last_env_state.sim), pts)
    surf = float(sdf.abs()[live].max()) if bool(live.any()) else float("nan")
    width = (env.num_envs, rig.num_view, rig.im_h, rig.im_w, tuple(obs.shape))
    succ = log.get("Test/succ_rate_max", float("nan"))
    emit("main_path", variant="b2+b3+b1b", num_envs=env.num_envs,
         image=[rig.num_view, rig.im_h, rig.im_w], coarse_to_fine=c2f, k=K_POINTS,
         steps=T, eval_round=rounds, observations=n_obs, kernel_launches=launches,
         expected_launches=expected, wall_seconds=wall,
         env_steps_per_second=rounds * T * env.num_envs / wall,
         nonzero_share_per_env=live.float().mean(1).tolist(),
         max_abs_surface_sdf=surf, surface_tol=SURFACE_TOL, succ_rate_max=succ,
         metrics=log)
    print(f"Test/succ_rate_max {succ} (vision student, seeded init)", flush=True)
    if width != (VISION_ENVS, 3, 288, 512, (VISION_ENVS, 3 * K_POINTS)):
        raise RuntimeError(f"vision main path did not run at full width: {width}")
    if launches != expected:
        raise RuntimeError(f"launches {launches}, expected {expected}: not every render, "
                           f"FPS and physics step went through its kernel")
    bad = [k for k, v in log.items() if not np.isfinite(v)]
    if bad or not bool(torch.isfinite(obs).all()) or not log:
        raise RuntimeError(f"vision main path output not finite: {bad}")
    if not (bool(live.any()) and surf <= SURFACE_TOL):
        raise RuntimeError(f"sampled points off the scene surface: |sdf| up to {surf}")
    return launches


def _device_ms(fn, names, reps=5):
    """Device time per call of ``fn`` of the kernels whose name holds one of
    ``names``, and of all device work, from ``torch.profiler`` (ms; None
    where the profiler records no device time)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = prof.key_averages()

    def total(evs):
        us = sum(getattr(e, "device_time_total", 0) or 0 for e in evs)
        return us / 1e3 / reps if us > 0 else None
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    return total([e for e in kernels if any(n in e.key for n in names)]), total(kernels)


def _host_ms(fn, reps=10):
    """Median host-clock time of ``fn`` ending in a synchronise (ms)."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


@torch.no_grad()
def b2_operations(rig, prims, c2f, cull=True):
    """f32 operations of one render, counted from csrc/raymarch.cu with the
    scene evaluations and the primitives they keep that this input needs
    (the plain march counts them; a multiply-add counts 2): per evaluation
    the point (6), every kept sphere (11), every kept box (53), the ground
    (1) and the march update (6); per ray its inverse length (6) and the hit
    select (3).  ``cull=False`` counts the unculled march."""
    from partmanip_tpu_torch.ops import raymarch, raymarch_cuda

    def ops(rays, t0, steps):
        _, ev = raymarch.march_plain(prims, rays, t0, steps, FAR, EPS, cull=cull,
                                     count_evals=True)
        ev = ev.double()
        return (float((13 * ev[..., 0] + 11 * ev[..., 1] + 53 * ev[..., 2]).sum())
                + 9.0 * ev[..., 0].numel())

    passes = dict(render_passes(rig, c2f))
    if not c2f:
        return ops(passes["full"], 0.05, 40)
    E, V = prims.sphere_radius.shape[0], rig.num_view
    hc, wc = rig.im_h // 4, rig.im_w // 4
    coarse = raymarch.march_plain(prims, passes["coarse"], 0.05, 40, FAR, EPS, cull=cull)
    t0 = raymarch_cuda.coarse_start(coarse.reshape(E, V, hc, wc), FAR).reshape(E, V, -1)
    return (ops(passes["coarse"], 0.05, 40)
            + ops(passes["full"], t0.contiguous(), raymarch_cuda.REFINE_STEPS))


def _bound(ops, nbytes):
    o, b = ops / H100_F32_FLOPS * 1e3, nbytes / H100_BYTES_PER_S * 1e3
    return {"bound_ms": max(o, b), "bound_by": "operations" if o >= b else "bytes",
            "bound_operations_ms": o, "bound_bytes_ms": b, "operations": ops,
            "bytes": nbytes}


def b3_placement_of(pts, cluster):
    """Where one launch of kernel B3 on clusters of ``cluster`` CTAs ran, as
    its CTAs wrote it (their SM and their start and end on the card's global
    timer): the distinct SMs used, the waves (a CTA that starts after
    another has ended is a wave later than it) and the most CTAs running at
    once."""
    from partmanip_tpu_torch.ops import fps
    trace = torch.zeros((pts.shape[0] * cluster, 3), dtype=torch.int64, device=pts.device)
    fps.launch(pts, K_POINTS, cluster, trace=trace)
    sm, start, end = trace.cpu().T.tolist()
    wave = {}
    for i in sorted(range(len(start)), key=start.__getitem__):
        wave[i] = 1 + max((wave[j] for j in wave if end[j] <= start[i]), default=0)
    return {"sms_used": len(set(sm)), "waves": max(wave.values()),
            "ctas_at_once": max(sum(s <= t < e for s, e in zip(start, end)) for t in start),
            "start_spread_us": (max(start) - min(start)) / 1e3}


@torch.no_grad()
def vision_timing(rig, prims, repeats=20):
    """B2 per render (coarse to fine, as the main path runs it, and exact)
    and B3 per call at the main path's shapes, by CUDA events; the plain
    versions; the device time of the kernels alone (``torch.profiler``;
    B2's render also spends host time on its masks and the coarse-to-fine
    filter); the bounds (B2's over the culled march, beside the unculled
    count; B3's over the compacted rows, beside the full ones); B3's
    cluster shape, occupancy (the runtime's query) and placement (read from
    the CTAs, :func:`b3_placement_of`), and its time and placement on each
    cluster size from 8 down to 4 CTAs."""
    from partmanip_tpu_torch.ops import fps, raymarch, raymarch_cuda, tsdf
    from partmanip_tpu_torch.utils import cuda_lib
    kernel = (raymarch_cuda.march, prims, rig.poses, rig.intrinsic, rig.im_h, rig.im_w)
    plain = (raymarch.march_plain,) + kernel[1:]
    render = raymarch_cuda.render_with
    for _ in range(3):
        depth = render(*kernel, coarse_to_fine=True)
    cuda_lib.reset_launch_counts()
    b2_ms = _timed(lambda: render(*kernel, coarse_to_fine=True), repeats)
    b2_launches = cuda_lib.launch_counts()["b2"] / repeats
    b2_exact_ms = _timed(lambda: render(*kernel), repeats)
    b2_plain_ms = _timed(lambda: render(*plain, coarse_to_fine=True), 3)
    b2_plain_exact_ms = _timed(lambda: render(*plain), 3)
    masks_ms = _timed(lambda: [raymarch.tile_masks(prims, rays, FAR).to(torch.uint8)
                               for _, rays in render_passes(rig, True)], repeats)
    b2_device_ms, b2_all_device_ms = _device_ms(lambda: render(*kernel, coarse_to_fine=True),
                                                ["march_kernel"])
    E, V, H, W = depth.shape
    S, G = prims.sphere_radius.shape[1], prims.box_pos.shape[1]
    n_c, n = E * V * (H // 4) * (W // 4), E * V * H * W
    prim_bytes = E * (4 * S + 11 * G) * 4
    mask_bytes = {name: E * rays.cos_t.numel() * (S + G)
                  for name, rays in render_passes(rig, True)}
    # coarse launch: prims, masks, rays, image out; refine: prims, masks, rays, t0 in, image out
    bytes_c2f = (2 * prim_bytes + mask_bytes["coarse"] + mask_bytes["full"]
                 + (3 * V * H * W // 16 + n_c) * 4 + (3 * V * H * W + 2 * n) * 4)
    bytes_exact = prim_bytes + mask_bytes["full"] + (3 * V * H * W + n) * 4

    pts = tsdf.workspace_points(rig.tsdf_spec, depth)
    for _ in range(2):
        fps.farthest_point_sampling_cuda(pts, K_POINTS)
    cuda_lib.reset_launch_counts()
    b3_ms = _timed(lambda: fps.farthest_point_sampling_cuda(pts, K_POINTS), repeats)
    b3_launches = cuda_lib.launch_counts()["b3"] / repeats
    b3_plain_ms = _timed(lambda: fps.farthest_point_sampling_plain(pts, K_POINTS), 3)
    _, counts = fps.launch(pts, K_POINTS)
    B, N, _ = pts.shape
    resident = {c: fps.max_active_clusters(N, c) for c in range(1, fps.MAX_CLUSTER + 1)}
    cluster = fps.cluster_for(B, N, pts.device)
    cfg = fps.launch_config(B, N, cluster)
    b3_ms_by_cluster = {c: _timed(lambda: fps.launch(pts, K_POINTS, c), 10)
                        for c in range(fps.MAX_CLUSTER, 3, -1)}
    b3_placement = {c: b3_placement_of(pts, c) for c in b3_ms_by_cluster}
    b3_device_ms, _ = _device_ms(lambda: fps.farthest_point_sampling_cuda(pts, K_POINTS),
                                 ["fps_kernel"])
    compacted = counts.tolist()
    bytes_b3 = B * N * 12 + B * K_POINTS * 4

    b2 = {"ms": b2_ms, "exact_ms": b2_exact_ms, "plain_ms": b2_plain_ms,
          "plain_exact_ms": b2_plain_exact_ms, "library_ms": None,
          "masks_ms": masks_ms, "kernel_device_ms": b2_device_ms,
          "all_device_ms": b2_all_device_ms, "launches_per_render": b2_launches,
          **_bound(b2_operations(rig, prims, True), bytes_c2f),
          "exact": _bound(b2_operations(rig, prims, False), bytes_exact),
          "unculled": {"c2f": _bound(b2_operations(rig, prims, True, cull=False), bytes_c2f),
                       "exact": _bound(b2_operations(rig, prims, False, cull=False),
                                       bytes_exact)},
          "kept": kept_shares(rig, prims, True), "rays": n, "spheres": S, "boxes": G,
          "live_boxes_mean": float((prims.box_mask > 0).sum(1).float().mean()),
          "threads_per_block": raymarch_cuda.BLK ** 2}
    b3 = {"ms": b3_ms, "plain_ms": b3_plain_ms, "library_ms": None, "batch": B,
          "points": N, "k": K_POINTS,
          "zero_points": float((pts == 0).all(-1).float().mean()),
          "compacted_points": compacted, "launches_per_call": b3_launches,
          "cluster": cluster, "ctas": cfg["ctas"], "threads_per_cta": cfg["threads"],
          "smem_bytes_per_cta": cfg["smem_bytes"], "points_on_chip_per_cta": cfg["points_on_chip"],
          "max_active_clusters": resident, **b3_placement[cluster],
          "ms_by_cluster": b3_ms_by_cluster, "placement_by_cluster": b3_placement, "kernel_device_ms": b3_device_ms,
          **_bound(8.0 * K_POINTS * sum(compacted), bytes_b3),
          "full_rows": _bound(8.0 * K_POINTS * N * B, bytes_b3)}
    emit("timing", variant="b2", **b2)
    emit("timing", variant="b3", **b3)
    return b2, b3


@torch.no_grad()
def vision_step_breakdown(num_envs=VISION_ENVS, reps=10):
    """One DAgger evaluation step at full width taken apart (host clock,
    each part ending in a synchronise): physics and state observation
    (``env.step`` without the camera), scene primitives (FK), the
    coarse-to-fine render (B2), unprojection and crop, FPS (B3) and the
    PointNet student."""
    from partmanip_tpu_torch.envs import vision
    from partmanip_tpu_torch.models.actor_critic import ActorCritic
    from partmanip_tpu_torch.ops import fps, tsdf
    env, cfg = make_vision_env(num_envs)
    rig = env.vision_rig
    student = ActorCritic(env.num_obs["depth_pc"], env.num_actions, cfg["algo"]["model"]).to("cuda")
    student.init(3)
    state, obs = env.reset(env.init_state(env.make_generator(4)))
    o = obs["depth_pc"]
    act = student.act(o)
    step_ms = _host_ms(lambda: env.step(state, act, train=False), reps)
    env.vision_rig = None
    physics_ms = _host_ms(lambda: env.step(state, act, train=False), reps)
    env.vision_rig = rig
    prims = vision.scene_prims(env, state.sim)
    prims_ms = _host_ms(lambda: vision.scene_prims(env, state.sim), reps)
    depth = vision.render_depth(rig, prims)
    render_ms = _host_ms(lambda: vision.render_depth(rig, prims), reps)
    pts = tsdf.workspace_points(rig.tsdf_spec, depth)
    unproject_ms = _host_ms(lambda: tsdf.workspace_points(rig.tsdf_spec, depth), reps)
    fps_ms = _host_ms(lambda: fps.farthest_point_sampling(pts, K_POINTS), reps)
    policy_ms = _host_ms(lambda: student.act(o), reps)
    parts = {"physics_and_state_obs_ms": physics_ms, "scene_prims_ms": prims_ms,
             "render_b2_ms": render_ms, "unproject_crop_ms": unproject_ms,
             "fps_b3_ms": fps_ms, "pointnet_ms": policy_ms}
    emit("step_breakdown", num_envs=num_envs, env_step_ms=step_ms,
         policy_plus_step_ms=step_ms + policy_ms, parts=parts,
         parts_sum_ms=sum(parts.values()))
    return parts


# progress passes 10 (the reward resets' delay) at iterations 11 and 12
DAGGER_ITERATIONS = 12
DAGGER_EVAL_AT = 12           # eval_frequence: one evaluation, after the last iteration
TEACHER_REWARD = os.path.join(ROOT, "artifacts", "open_drawer_ppo", "expert_r3c_seed389",
                              "teacher_reward.npy")


def _median_after_first(logs):
    return statistics.median(log["Progress/iteration_time"] for log in logs[1:])


def _iteration_split(runner, reps=3, iteration_s=None, profile_epochs=None):
    """``_collect`` alone and the whole DAgger iteration (host clock around
    synchronised work, median of ``reps``; or ``iteration_s`` given, the
    run's own), the update their difference, then one more iteration
    under ``torch.profiler`` (device activity only): its device time, idle
    share and top device kernels; continuing from the runner's last state.
    ``profile_epochs`` cuts the profiled iteration to that many of its
    ``n_updates`` epochs (a ResNet iteration's ≈ 150,000 kernels take the
    profiler minutes to collect; its steps are alike)."""
    from partmanip_tpu_torch.utils.fetch import fetch_scalars
    ts, es = runner.last_ts, runner.last_env_state
    collect_s, iterations = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ts, es, _ = runner._collect(ts, es)
        torch.cuda.synchronize()
        collect_s.append(time.perf_counter() - t0)
        if iteration_s is None:
            t0 = time.perf_counter()
            ts, es, m = runner._dagger_iteration(ts, es, float(runner._lr_now()))
            fetch_scalars(m)
            iterations.append(time.perf_counter() - t0)
    out = {"collect_s": statistics.median(collect_s),
           "iteration_s": statistics.median(iterations) if iteration_s is None else iteration_s}
    out["update_s"] = out["iteration_s"] - out["collect_s"]
    epochs = runner.n_updates
    runner.n_updates = profile_epochs or epochs
    torch.cuda.synchronize()
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fetch_scalars(runner._dagger_iteration(ts, es, float(runner._lr_now()))[2])
            torch.cuda.synchronize()
            profiled_s = time.perf_counter() - t0
    finally:
        runner.n_updates = epochs
    ks = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(getattr(e, "device_time_total", 0) or 0 for e in ks)
    out["profiled_epochs"] = profile_epochs or epochs
    out["iteration_device_s"] = device_us / 1e6 if device_us > 0 else None
    out["profiled_iteration_s"] = profiled_s
    if out["iteration_device_s"] is not None:
        # the share of the profiled iteration's own wall time
        out["device_idle_share"] = 1.0 - out["iteration_device_s"] / (
            out["iteration_s"] if profile_epochs is None else profiled_s)
    ks.sort(key=lambda e: -(getattr(e, "device_time_total", 0) or 0))
    out["top_kernels_ms"] = [(e.key[:120], (e.device_time_total or 0) / 1e3, e.count)
                             for e in ks[:6]]
    return out


def vision_dagger_train(reps=3):
    """DAgger training of the point-cloud student through the CLI entry point
    at the YAML's full width (16 envs, 3 views of 288×512, 1024 points,
    PointNet; buf_size 1200 = 19,200 rows, minibatch_size 2048 in chunks of
    minibatch_cap 256, 2 epochs × 16 minibatches) with the reward-driven
    reset on: DAGGER_ITERATIONS iterations, one evaluation, a checkpoint at
    the last; then one more iteration resumed from that checkpoint.  Every
    render through B2, every FPS through B3, every physics step through B1b
    (collection, evaluation and resets), none through B1a or B1c; finite
    ``Train/*`` metrics, a moved student, the buffer's size and the Adam
    count; the resumed run loads the saved student and Adam state (reloaded
    after its run and compared with the first run's).  Reports seconds per
    iteration (median after the first), and, launches no longer counted,
    one iteration taken apart: ``_collect`` alone and the whole iteration,
    host clock around synchronised work (median of ``reps``), the update
    their difference; and the iteration's device time (``torch.profiler``,
    all kernels).  Returns the first run's launches."""
    import train_torch
    from partmanip_tpu_torch.models.actor_critic import ActorCritic
    from partmanip_tpu_torch.utils import cuda_lib
    K = DAGGER_ITERATIONS
    flags = VISION_FLAGS + [
        "--algo.reward_reset", "--algo.teacher_reward", TEACHER_REWARD,
        "--algo.eval_round", "1", "--algo.eval_frequence", str(DAGGER_EVAL_AT),
        "--algo.save_frequence", str(K), "--exp_name", "chip_smoke_dagger_train_seed3",
        "--log.mode", "screen"]
    cuda_lib.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    runner = train_torch.main(flags + ["--algo.max_iterations", str(K)])
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = cuda_lib.launch_counts()
    env, cfg, rig = runner.env, runner.cfg, runner.env.vision_rig
    T, cfi, E = env.max_episode_length, env.control_freq_inv, env.num_envs
    n_eval = K // DAGGER_EVAL_AT
    # init_state's reset; each collection step; each evaluation's reset, its
    # T steps and the reset after it
    n_obs = 1 + K * runner.n_steps + n_eval * (1 + T + 1)
    c2f = rig.coarse_to_fine and rig.im_h % 4 == 0 and rig.im_w % 4 == 0
    expected = {"b2": n_obs * (2 if c2f else 1), "b3": n_obs,
                "b1b": 1 + K * runner.n_steps * cfi + n_eval * (2 + T * cfi),
                "b1a": 0, "b1c": 0, "b1d": 0, "b1e": 0}
    logs = runner.train_logs
    bad = sorted({k for log in logs for k, v in log.items()
                  if k.startswith("Train/") and not np.isfinite(v)})
    fresh = ActorCritic(runner.stu_num_obs, runner.num_actions,
                        runner.model_cfg).to(runner.device)
    fresh.init(3)                                    # the seed of the exp_name
    moved = max(float((p - q).detach().abs().max()) for (n, p), q in zip(
        runner.student.named_parameters(), fresh.parameters()) if n.startswith("actor."))
    ts = runner.last_ts
    cap = ts.buffer.stu_obs.shape[0]
    mb, chunk, n_chunks = runner.minibatch_sizes(cap)
    steps_per_iteration = runner.n_updates * runner.num_mini_batches
    resets = sum(log["Train/dagger_reward_reset_mean"] for log in logs) * runner.n_steps * E
    width = (E, rig.num_view, rig.im_h, rig.im_w, tuple(ts.stu_obs.shape), cap,
             cfg["minibatch_size"], cfg["minibatch_cap"], runner.n_updates,
             runner.num_mini_batches, cfg["model"]["network"]["name"])

    cuda_lib.reset_launch_counts()
    path = os.path.join(runner.save_ckpt_dir, f"model_{K}.ckpt")
    resumed = train_torch.main(flags + ["--algo.max_iterations", str(K + 1), "--resume", path])
    torch.cuda.synchronize()
    resume_launches = cuda_lib.launch_counts()
    resume_expected = {"b2": 2 * (2 if c2f else 1), "b3": 2, "b1b": 1 + runner.n_steps * cfi,
                       "b1a": 0, "b1c": 0, "b1d": 0, "b1e": 0}
    resumed_iter, resumed_count = resumed.curr_iter, resumed.last_ts.opt.count
    rts = resumed.resume(resumed.last_ts, path)
    saved, again = runner.last_ts.opt.state_dict(), rts.opt.state_dict()
    equal = (saved["count"] == again["count"]
             and all(torch.equal(a, runner.student.state_dict()[k])
                     for k, a in resumed.student.state_dict().items())
             and all(torch.equal(again[m][k], v) for m in ("mu", "nu")
                     for k, v in saved[m].items()))

    breakdown = _iteration_split(resumed, reps)
    median = _median_after_first(logs)
    emit("dagger_train", num_envs=E, width=width, iterations=runner.curr_iter,
         kernel_launches=launches, expected_launches=expected,
         resume_kernel_launches=resume_launches, resume_expected_launches=resume_expected,
         wall_seconds=wall, iteration_seconds=[log["Progress/iteration_time"] for log in logs],
         seconds_per_iteration_median_after_first=median, breakdown=breakdown,
         minibatch={"mb": mb, "chunk": chunk, "n_chunks": n_chunks,
                    "chunk_passes_per_iteration": steps_per_iteration * n_chunks},
         reward_resets=resets, student_moved=moved, cur_buf_size=ts.buffer.size.item(),
         adam_count=ts.opt.count, resumed_adam_count=resumed_count, resume_equal=equal,
         metrics=runner.last_log)
    print(f"dagger_train: {median:.4f} s per iteration (median of 2-{K}); collect "
          f"{breakdown['collect_s']:.4f} s, update {breakdown['update_s']:.4f} s; minibatch "
          f"{mb} = {n_chunks} chunks of {chunk}; {resets:.0f} reward resets", flush=True)
    if width != (VISION_ENVS, 3, 288, 512, (VISION_ENVS, 3 * K_POINTS), 19200, 2048, 256, 2, 16,
                 "PointNet") or runner.curr_iter != K:
        raise RuntimeError(f"dagger_train did not run at full width: {width}")
    if launches != expected or resume_launches != resume_expected:
        raise RuntimeError(f"dagger_train launches {launches} (resumed {resume_launches}), "
                           f"expected {expected} ({resume_expected})")
    if bad or not logs or not moved > 0:
        raise RuntimeError(f"dagger_train: non-finite {bad}, student moved {moved}")
    if (ts.buffer.size.item() != min(K * runner.n_steps * E, cap)
            or ts.opt.count != K * steps_per_iteration):
        raise RuntimeError(f"dagger_train: buffer size {ts.buffer.size.item()}, Adam count "
                           f"{ts.opt.count}")
    if not (equal and resumed_iter == K + 1 and len(resumed.train_logs) == 1
            and resumed_count == (K + 1) * steps_per_iteration):
        raise RuntimeError(f"dagger_train: the resumed run did not continue from the "
                           f"checkpoint (equal {equal}, iteration {resumed_iter}, "
                           f"Adam count {resumed_count})")
    return launches


LOOP_TEACHER = os.path.join(ROOT, "artifacts", "open_drawer_ppo", "expert_r3c_seed389",
                            "model_16000.ckpt")
LOOP_RECORD = os.path.join(ROOT, "tests", "golden_torch", "dagger_loop_record.json")
LOOP_ITERATIONS = 50          # the record ran 1000: a depth cut
LOOP_SHOWN = (1, 2, 5, 10, 20, 50)


def dagger_loop():
    """The DAgger loop proof through the CLI entry point: the normal_state
    MLP student of the JAX package's run ``ceiling_r3_seed17``
    (``scripts/pipeline_r3.sh:72-80``: open_drawer, 1024 envs, buf_size 64,
    minibatch_cap 2048, teacher ``model_16000.ckpt``, seed 17) for
    LOOP_ITERATIONS iterations.  Its ``Train/dagger_loss`` beside the
    record's (``tests/golden_torch/dagger_loop_record.json``); the two RNG
    streams differ, so the gate is on the curve's shape: iteration 1 within
    [0.25, 0.75], the mean over iterations 41-50 at most 0.12 and at most a
    quarter of iteration 1's.  Every physics step through B1b."""
    import train_torch
    from partmanip_tpu_torch.utils import cuda_lib
    with open(LOOP_RECORD) as f:
        record = json.load(f)
    cuda_lib.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    runner = train_torch.main([
        "--taskcfg", "open_drawer", "--algocfg", "dagger", "--algo.obs_mode", "normal_state",
        "--algo.model.network.name", "MLP", "--algo.num_envs", "1024", "--algo.buf_size", "64",
        "--algo.minibatch_cap", "2048", "--algo.max_iterations", str(LOOP_ITERATIONS),
        "--algo.teacher", LOOP_TEACHER, "--exp_name", "chip_smoke_dagger_loop_seed17",
        "--log.mode", "screen"])
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = cuda_lib.launch_counts()
    env = runner.env
    expected = {"b1b": 1 + LOOP_ITERATIONS * runner.n_steps * env.control_freq_inv,
                "b1a": 0, "b1c": 0, "b1d": 0, "b1e": 0, "b2": 0, "b3": 0}
    loss = [log["Train/dagger_loss"] for log in runner.train_logs]
    want = [record["dagger_loss"][str(i)] for i in range(1, LOOP_ITERATIONS + 1)]
    tail, want_tail = float(np.mean(loss[40:50])), float(np.mean(want[40:50]))
    median = _median_after_first(runner.train_logs)
    emit("dagger_loop", num_envs=env.num_envs, iterations=runner.curr_iter,
         record=record["run"], kernel_launches=launches, expected_launches=expected,
         dagger_loss=loss, record_dagger_loss=want,
         mean_41_50=tail, record_mean_41_50=want_tail, wall_seconds=wall,
         seconds_per_iteration_median_after_first=median, metrics=runner.last_log)
    for i in LOOP_SHOWN:
        print(f"dagger_loop: iteration {i:3d}  Train/dagger_loss {loss[i - 1]:.4f}  "
              f"(record {want[i - 1]:.4f})", flush=True)
    print(f"dagger_loop: mean of 41-50 {tail:.4f} (record {want_tail:.4f})", flush=True)
    if runner.curr_iter != LOOP_ITERATIONS or env.num_envs != 1024 or launches != expected:
        raise RuntimeError(f"dagger_loop: {runner.curr_iter} iterations at {env.num_envs} "
                           f"envs, launches {launches}, expected {expected}")
    if not (0.25 <= loss[0] <= 0.75 and tail <= 0.12 and tail <= loss[0] / 4):
        raise RuntimeError(f"dagger_loop: Train/dagger_loss {loss[0]:.4f} at iteration 1, "
                           f"{tail:.4f} over 41-50: the student does not learn as the "
                           f"record's did ({want[0]:.4f}, {want_tail:.4f})")
    return launches


# ----------------------------------------------------------------------
# the TSDF student: demos → BC → DAgger, at the YAMLs' own defaults
# ----------------------------------------------------------------------

TSDF_DEMOS = os.path.join(ROOT, "build", "chip_smoke_tsdf_demos")
DEMO_RES, DEMO_T = 50, 200    # open_drawer.yaml: tsdf resolution, maxEpisodeLength
BC_ITERATIONS = 7             # bc.yaml runs 1000: the fewest that pass the loss gates
TSDF_DAGGER_ITERATIONS = 5    # dagger.yaml runs 10000: cut so that the script stays in its limit
DEPTH_DAGGER_ITERATIONS = 3
CONV_TOL = 1e-4               # card vs CPU, relative to the largest magnitude; TF32 must fail it
TSDF_TOL = 1e-6               # integrate(B2 depth) vs integrate(plain depth)


def conv3d_macs(res=50, layers=((16, 5, 3), (32, 3, 3), (32, 3, 2)), hidden=256, out=10):
    """Multiply-adds of one Conv3DNet forward, per layer, counted from its
    shapes: output voxels × output channels × kernel volume × input
    channels, then the dense layer and the head."""
    macs, c, side = {}, 1, res
    for i, (f, k, s) in enumerate(layers):
        side = (side + 2 * (k // 2) - k) // s + 1
        macs[f"conv{i + 1}"] = side ** 3 * f * k ** 3 * c
        c = f
    macs["dense"] = c * side ** 3 * hidden
    macs["head"] = hidden * out
    return macs


def _dir_bytes(path):
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)


def check_demo_tree(path, res, num_actions, tea_obs, proprio):
    """The written tree's layout, checked file by file: keys, shapes, the
    volume in [-1, 1] with both signs over the tree, bf16-representable
    values.  Returns (rows, scenes, the demo actions [n, A])."""
    scenes = sorted(os.listdir(path)) if os.path.isdir(path) else []
    acts, neg, pos, bad = [], False, False, []
    for scene in scenes:
        for step in sorted(os.listdir(os.path.join(path, scene))):
            d = np.load(os.path.join(path, scene, step), allow_pickle=True).item()
            v = d["tsdf"]
            shapes = {k: np.shape(x) for k, x in d.items()}
            if (set(d) != {"tsdf", "action", "tea_obs", "proprio_state"}
                    or shapes != {"tsdf": (res,) * 3, "action": (num_actions,),
                                  "tea_obs": (tea_obs,), "proprio_state": (proprio,)}
                    or v.dtype != np.float32 or not (np.abs(v) <= 1.0).all()
                    or not np.array_equal(torch.from_numpy(v).bfloat16().float().numpy(), v)):
                bad.append(f"{scene}/{step}: {shapes}")
            neg, pos = neg or bool((v < 0).any()), pos or bool((v > 0).any())
            acts.append(d["action"])
    if bad or not (neg and pos) or not acts:
        raise RuntimeError(f"tsdf_student demos: {len(bad)} bad files {bad[:3]}, both "
                           f"signs {neg and pos}, rows {len(acts)}")
    return len(acts), len(scenes), np.stack(acts)


@torch.no_grad()
def tsdf_integrate_check(cases):
    """TSDF fusion of B2's depth against fusion of the plain march's depth on
    the vision cases (exact and coarse-to-fine, culled): the max abs TSDF
    difference and the voxels whose validity (seen by a view) differs."""
    from partmanip_tpu_torch.config import process_cfgs
    from partmanip_tpu_torch.envs import vision
    from partmanip_tpu_torch.ops import raymarch, raymarch_cuda, tsdf
    cfg, _ = process_cfgs(VISION_FLAGS)
    rig = vision.VisionRig(cfg["task"]["cam"], cfg["task"]["obs_mode"]["tsdf"], "depth_tsdf")
    spec = rig.tsdf_spec

    def seen(depth):
        E, V = depth.shape[:2]
        lin = torch.as_tensor(spec.pix_y.astype(np.int64) * spec.im_w + spec.pix_x,
                              device=depth.device)[None].expand(E, -1, -1)
        dv = torch.gather(depth.reshape(E, V, -1), 2, lin)
        diff = dv - torch.as_tensor(spec.pix_z, device=depth.device)[None]
        valid = (torch.as_tensor(spec.valid, device=depth.device)[None] & (dv > 0)
                 & (diff >= -spec.sdf_trunc))
        return valid.any(dim=1)

    out = {}
    for name, prims in cases.items():
        for c2f in (False, True):
            args = (prims, rig.poses, rig.intrinsic, rig.im_h, rig.im_w)
            got = raymarch_cuda.render_with(raymarch_cuda.march, *args, coarse_to_fine=c2f)
            want = raymarch_cuda.render_with(raymarch.march_plain, *args, coarse_to_fine=c2f)
            a, b = tsdf.integrate(spec, got), tsdf.integrate(spec, want)
            out[f"{name}_{'c2f' if c2f else 'exact'}"] = {
                "max_abs_err": float((a - b).abs().max()),
                "validity_flips": int((seen(got) != seen(want)).sum()),
                "seen_share": float(seen(want).float().mean()),
                "finite": bool(torch.isfinite(a).all())}
    return out


@contextlib.contextmanager
def _kinks(record, replay=None):
    """Within the block, every ``F.relu`` and ``F.max_pool2d`` call (the
    ResNets' kinks: 33 ReLUs and the stem's pool) appends to ``record`` its
    input, the branch it takes (a ReLU's mask x > 0, a pool's picks) and
    the pool's window (None for a ReLU), on the CPU; with ``replay``,
    another run's record, it takes that run's branch at the same call
    instead of its own."""
    relu, pool = F.relu, F.max_pool2d
    taken = iter(replay or [])

    def relu_(x, inplace=False):
        if replay is None:
            y, mask = relu(x), x > 0
        else:
            mask = next(taken)[1].to(x.device)
            y = x * mask.to(x.dtype)
        record.append((x.detach().cpu(), mask.cpu(), None))
        return y

    def pool_(h, kernel, stride=None, padding=0, *args, **kwargs):
        y, idx = pool(h, kernel, stride, padding, return_indices=True)
        if replay is not None:
            idx = next(taken)[1].to(h.device)
            y = h.flatten(2).gather(2, idx.flatten(2)).view_as(y)
        record.append((h.detach().cpu(), idx.cpu(), (kernel, stride, padding)))
        return y
    F.relu, F.max_pool2d = relu_, pool_
    try:
        yield
    finally:
        F.relu, F.max_pool2d = relu, pool


def _actor_run(net, rows, record=None, replay=None):
    """The actor's forward on ``rows`` in the net's device and dtype, and
    the weight gradients of a fixed weighting of its outputs; with
    ``record``, inside :func:`_kinks`.  Returns [output, *gradients] on the
    CPU."""
    p = next(net.parameters())
    net.zero_grad(set_to_none=True)
    with _kinks(record, replay) if record is not None else contextlib.nullcontext():
        y = net.actor(rows.to(p.device, p.dtype))
    w = torch.linspace(-1, 1, y.numel(), device=p.device, dtype=p.dtype).reshape(y.shape)
    (y * w).sum().backward()
    return [y.detach().cpu()] + [q.grad.cpu() for _, q in net.actor.named_parameters()]


def _flip_census(run, ref, other=None):
    """Where a run's branches (``run``, a :func:`_kinks` record) differ from
    float64's on the same upstream branches (``ref``, float64's record
    while it replays ``run``), kink by kink: the flips, the largest float64
    margin among them (a ReLU's |x|, a pool's gap between its window's
    maximum and the run's pick), and the layer's f32 rounding, the largest
    |x − x64| at the kink's inputs outside the flips (and anywhere for
    ``other``, an independent f32 run on the same branches).  A flip whose
    margin lies within that rounding (twice it for a pool, whose gap is
    between two rounded values) is a near-tie that f32 does not decide.
    Returns the kinks with flips and the totals."""
    kinks = []
    for i, ((x, branch, window), (x64, _, _)) in enumerate(zip(run, ref)):
        err = (x.double() - x64).abs()
        if window is None:
            flip = (x64 > 0) != branch
            margin, factor, err = x64.abs()[flip], 1, err[~flip]
        else:
            gap = (F.max_pool2d(x64, *window).flatten(2)
                   - x64.flatten(2).gather(2, branch.flatten(2)))
            flip = gap > 0
            picked = torch.zeros(x64.flatten(2).shape, dtype=torch.uint8)
            picked.scatter_reduce_(2, branch.flatten(2), flip.to(torch.uint8), "amax")
            margin, factor, err = gap[flip], 2, err.flatten(2)[picked == 0]
        rounding = float(err.max()) if err.numel() else 0.0
        if other is not None:
            rounding = max(rounding, float((other[i][0].double() - x64).abs().max()))
        if flip.any():
            worst = float(margin.max())
            kinks.append({"kink": i, "kind": "relu" if window is None else "max_pool",
                          "flips": int(flip.sum()), "of": flip.numel(), "worst_margin": worst,
                          "rounding": rounding,
                          "margin_over_rounding": worst / rounding if rounding else math.inf,
                          "within": worst <= factor * rounding})
    return {"kinks": len(run), "flips": sum(k["flips"] for k in kinks),
            "all_within": all(k["within"] for k in kinks), "with_flips": kinks}


def net_card_vs_cpu(rows, model_cfg, proprio=0, kinks=False):
    """A seeded actor (``model_cfg``'s network, ``proprio`` columns at the
    end of each row)'s forward and weight gradients on the card against the
    CPU's on the same real rows, each tensor's largest difference relative
    to its largest magnitude, with cuDNN's TF32 off as the port's entry
    points set it (``f32``); then the same card network with TF32 on, the
    control (``tf32_control``): the comparison must fail it, or it could
    not tell TF32 from f32.  cuDNN's flags are restored afterwards.

    With ``kinks`` (the ResNets, whose 33 ReLUs see pre-activations within
    rounding of 0 on image rows), every run records its kinks
    (:func:`_kinks`), and also: ``f32_on_card_branches``, the CPU's f32 run
    taking the card run's branch at every kink, and the TF32 control so
    matched; against float64 on the CPU, each on its own branches, the
    card (``f64_card``), the card with cuDNN off (``f64_card_no_cudnn``)
    and the CPU's f32 (``f64_cpu``), and each f32 run on the card's
    branches (``f64_card_on_card_branches``, ``f64_cpu_on_card_branches``);
    and the census of the card's and the CPU's flips against float64
    (:func:`_flip_census`)."""
    from partmanip_tpu_torch.models.actor_critic import ActorCritic
    net = ActorCritic(rows.shape[1], 10, model_cfg, proprio_shape=proprio)
    net.init(5)
    card = ActorCritic(rows.shape[1], 10, model_cfg, proprio_shape=proprio).to("cuda")
    card.load_state_dict(net.state_dict())
    f64 = copy.deepcopy(net).double()
    names = ["forward"] + [n for n, _ in net.actor.named_parameters()]

    def rel(got, ref):
        return {n: float((g.double() - r.double()).abs().max()
                         / r.double().abs().max().clamp(min=1e-30))
                for n, g, r in zip(names, got, ref)}

    def worst(d):
        k = max(d, key=d.get)
        return {"worst": d[k], "at": k}
    cudnn = torch.backends.cudnn
    was = (cudnn.allow_tf32, cudnn.enabled)
    rec = {k: [] if kinks else None for k in ("card", "tf32", "cpu")}
    try:
        cudnn.allow_tf32 = False
        got = _actor_run(card, rows, rec["card"])
        cudnn.allow_tf32 = True
        tf32 = _actor_run(card, rows, rec["tf32"])
        if kinks:
            cudnn.allow_tf32, cudnn.enabled = False, False
            no_cudnn = _actor_run(card, rows)
    finally:
        cudnn.allow_tf32, cudnn.enabled = was
    cpu = _actor_run(net, rows, rec["cpu"])
    out = {"rows": rows.shape[0], "network": model_cfg["network"]["name"],
           "f32": worst(rel(got, cpu)), "tf32_control": worst(rel(tf32, cpu)),
           "rel_err_f32": rel(got, cpu),
           "cudnn": {"version": cudnn.version(), "allow_tf32_restored": was[0],
                     "benchmark": cudnn.benchmark}}
    if kinks:
        on_card, on_card64, on_cpu64 = [], [], []
        cpu_on_card = _actor_run(net, rows, on_card, replay=rec["card"])
        ref = _actor_run(f64, rows)
        ref_on_card = _actor_run(f64, rows, on_card64, replay=rec["card"])
        _actor_run(f64, rows, on_cpu64, replay=rec["cpu"])
        out.update({
            "f32_on_card_branches": worst(rel(got, cpu_on_card)),
            "tf32_control_on_its_branches": worst(rel(tf32, _actor_run(net, rows, [],
                                                                       replay=rec["tf32"]))),
            "f64_card": worst(rel(got, ref)), "f64_card_no_cudnn": worst(rel(no_cudnn, ref)),
            "f64_cpu": worst(rel(cpu, ref)),
            "f64_card_on_card_branches": worst(rel(got, ref_on_card)),
            "f64_cpu_on_card_branches": worst(rel(cpu_on_card, ref_on_card)),
            "card_flips": _flip_census(rec["card"], on_card64, other=on_card),
            "cpu_flips": _flip_census(rec["cpu"], on_cpu64)})
    return out


def student_step_breakdown(runner, reps=10):
    """One DAgger evaluation step of the runner's student taken apart (host
    clock, each part ending in a synchronise): physics and state
    observation, scene primitives (FK), then the mode's own parts — for
    mesh_tsdf the grid query; else the coarse-to-fine render (B2), and for
    depth_tsdf the fusion, for depth_sparse the fusion, the near-voxel
    points and FPS (B3), for rgb_img the shading — and the student's
    forward."""
    from partmanip_tpu_torch.envs import vision
    from partmanip_tpu_torch.ops import fps, raymarch, tsdf
    env, rig = runner.env, runner.env.vision_rig
    spec, mode = rig.tsdf_spec, rig.mode
    with torch.no_grad():
        state, obs = env.reset(env.init_state(env.make_generator(4)))
        o = obs[mode]
        act = runner.student.act(o)
        step_ms = _host_ms(lambda: env.step(state, act, train=False), reps)
        env.vision_rig = None
        physics_ms = _host_ms(lambda: env.step(state, act, train=False), reps)
        env.vision_rig = rig
        prims = vision.scene_prims(env, state.sim)
        parts = {"physics_and_state_obs_ms": physics_ms,
                 "scene_prims_ms": _host_ms(lambda: vision.scene_prims(env, state.sim), reps)}
        if mode == "mesh_tsdf":
            parts["mesh_tsdf_query_ms"] = _host_ms(lambda: vision.mesh_tsdf(rig, prims), reps)
        else:
            depth = vision.render_depth(rig, prims)
            parts["render_b2_ms"] = _host_ms(lambda: vision.render_depth(rig, prims), reps)
        if mode in ("depth_tsdf", "depth_sparse"):
            parts["integrate_ms"] = _host_ms(lambda: tsdf.integrate(spec, depth), reps)
        if mode == "depth_sparse":
            vol = tsdf.integrate(spec, depth)
            parts["sparse_points_ms"] = _host_ms(lambda: tsdf.sparse_points(spec, vol), reps)
            pts = tsdf.sparse_points(spec, vol)[0]
            parts["fps_b3_ms"] = _host_ms(lambda: fps.farthest_point_sampling(pts, K_POINTS), reps)
        if mode == "rgb_img":
            parts["shading_ms"] = _host_ms(lambda: raymarch.render_rgb(
                prims, rig.poses[:1], rig.intrinsic, rig.im_h, rig.im_w,
                depth=depth[:, :1]), reps)
        net = runner.model_cfg["network"]["name"].lower()
        parts[f"{net}_ms"] = _host_ms(lambda: runner.student.act(o), reps)
    return {"env_step_ms": step_ms, "parts": parts, "parts_sum_ms": sum(parts.values())}


def _dagger_run(task, mode, iterations, extra, launches_total, teacher=DRAWER_CKPT,
                network=None, seed=23):
    """One DAgger run of a vision student through the CLI entry point at
    dagger.yaml's defaults (with ``--algo.obs_mode mode`` on ``task``, the
    YAML's network unless ``network`` names another), one evaluation after
    the last iteration; its launches, checked exactly against the printed
    formulas: the task's physics kernel (B1a on grasp_cube, B1b on
    open_drawer) for every physics step, B2 once a pass for every rendered
    observation, B3 for every observation that samples points."""
    import train_torch
    from partmanip_tpu_torch.utils import cuda_lib
    K = iterations
    cuda_lib.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    runner = train_torch.main([
        "--taskcfg", task, "--algocfg", "dagger", "--algo.obs_mode", mode,
        "--algo.teacher", teacher, "--algo.max_iterations", str(K),
        "--algo.eval_round", "1", "--algo.eval_frequence", str(K),
        "--exp_name", f"chip_smoke_{mode}_student_seed{seed}", "--log.mode", "screen",
        *(["--algo.model.network.name", network] if network else []), *extra])
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = cuda_lib.launch_counts()
    for k, v in launches.items():
        launches_total[k] = launches_total.get(k, 0) + v
    env, rig = runner.env, runner.env.vision_rig
    T, cfi = env.max_episode_length, env.control_freq_inv
    physics = "b1a" if task == "grasp_cube" else "b1b"
    n_obs = 1 + K * runner.n_steps + (1 + T + 1)
    renders = mode != "mesh_tsdf"
    passes = 2 if rig.coarse_to_fine and rig.im_h % 4 == 0 and rig.im_w % 4 == 0 else 1
    samples = mode in ("depth_pc", "depth_sparse")
    expected = {"b1a": 0, "b1b": 0, "b1c": 0, "b1d": 0, "b1e": 0,
                "b2": n_obs * passes if renders else 0, "b3": n_obs if samples else 0}
    expected[physics] = 1 + K * runner.n_steps * cfi + 2 + T * cfi
    obs_formula = f"1 + K·n_steps + (1 + T + 1) = 1 + {K}·{runner.n_steps} + (1 + {T} + 1)"
    formula = {physics: f"1 + K·n_steps·cfi + (2 + T·cfi) = 1 + {K}·{runner.n_steps}·{cfi} "
                        f"+ (2 + {T}·{cfi})",
               "b2": f"{passes} · ({obs_formula})" if renders else "0 (no render)",
               "b3": obs_formula if samples else "0 (no point sampling)"}
    logs = runner.train_logs
    # the last log holds the evaluation's Val/* metrics too
    bad = sorted({k for log in logs for k, v in log.items()
                  if k.startswith(("Train/", "Val/")) and not np.isfinite(v)})
    ts = runner.last_ts
    cap = ts.buffer.stu_obs.shape[0]
    mb, chunk, n_chunks = runner.minibatch_sizes(cap)
    width = (env.num_envs, tuple(ts.stu_obs.shape), str(ts.buffer.stu_obs.dtype), cap,
             mb, chunk, runner.n_updates, runner.num_mini_batches,
             runner.model_cfg["network"]["name"], rig.mode, rig.tsdf_spec.resolution,
             rig.im_h, rig.im_w, rig.coarse_to_fine)
    return runner, {
        "task": task, "obs_mode": mode, "iterations": runner.curr_iter, "width": width,
        "kernel_launches": launches, "expected_launches": expected,
        "launch_formula": formula, "wall_seconds": wall,
        "iteration_seconds": [log["Progress/iteration_time"] for log in logs],
        "seconds_per_iteration_median_after_first": _median_after_first(logs),
        "dagger_loss": [log["Train/dagger_loss"] for log in logs],
        "cur_buf_size": ts.buffer.size.item(),
        "buffer_gb": ts.buffer.stu_obs.numel() * ts.buffer.stu_obs.element_size() / 1e9,
        "non_finite": bad, "eval": {k: v for k, v in runner.last_log.items()
                                    if k.startswith("Val/") and ("succ" in k or "reward" in k)}}


def tsdf_student():
    """The TSDF student at the YAMLs' own defaults through the entry points:
    mesh_tsdf demos of the committed expert (collect_demos_torch.py, one
    episode at 16 envs, only the successful envs), BC of a Conv3DNet on them
    (train_torch.py --algocfg bc, bc.yaml's 50 minibatches, lr 5e-4,
    step_decay; BC_ITERATIONS iterations), DAgger from that checkpoint with
    the demos ingested offline (dagger.yaml as it is: 16 envs, buf_size 1200,
    minibatch 2048 in chunks of 256, 2 × 16 Adam steps; 5 iterations and
    one evaluation), then the depth_tsdf student (3 iterations, one
    evaluation) through B2; TSDF fusion of B2's depth held against fusion
    of the plain march's, Conv3DNet on the card against the CPU.  Returns
    the phase's launches per kernel."""
    import collect_demos_torch
    import train_torch
    from partmanip_tpu_torch.envs import vision
    from partmanip_tpu_torch.utils import checkpoint as ckpt_lib
    from partmanip_tpu_torch.utils import cuda_lib
    launches_total = {}
    shutil.rmtree(TSDF_DEMOS, ignore_errors=True)
    try:
        # 1. demos
        cuda_lib.reset_launch_counts()
        summary = collect_demos_torch.main([
            "--teacher", DRAWER_CKPT, "--out", TSDF_DEMOS, "--episodes", "1", "--only_success",
            "--taskcfg", "open_drawer", "--algo.num_envs", str(VISION_ENVS)])
        torch.cuda.synchronize()
        collect_launches = cuda_lib.launch_counts()
        for k, v in collect_launches.items():
            launches_total[k] = launches_total.get(k, 0) + v
        gb = _dir_bytes(TSDF_DEMOS) / 1e9
        rows, scenes, acts = check_demo_tree(TSDF_DEMOS, DEMO_RES, 10, 53, 0)
        const_loss = float(acts.var(axis=0).mean())
        T = DEMO_T
        demos = {"rows": rows, "scenes": scenes, "seconds": summary["seconds"], "gb_written": gb,
                 "kernel_launches": collect_launches,
                 "expected_launches": {"b1b": 1 + 2 * T, "b1a": 0, "b1c": 0, "b1d": 0, "b1e": 0,
                                       "b2": 0, "b3": 0},
                 "layout": {"tsdf": [DEMO_RES] * 3, "action": 10, "tea_obs": 53,
                            "proprio_state": 0, "tsdf_bf16_rounded": True},
                 "constant_predictor_loss": const_loss}
        print(f"tsdf_student demos: {rows} rows ({scenes} of 16 envs succeeded) in "
              f"{summary['seconds']:.2f} s, {gb:.3f} GB", flush=True)
        if rows != scenes * T or collect_launches != demos["expected_launches"]:
            raise RuntimeError(f"tsdf_student demos: {demos}")

        # 2. BC, with cuDNN's deterministic algorithms: the gate's margin is
        # a few per cent, and the weight gradients' default algorithms sum in
        # an order that changes from run to run
        cuda_lib.reset_launch_counts()
        t0 = time.time()
        torch.backends.cudnn.deterministic = True
        try:
            bc = train_torch.main([
                "--taskcfg", "open_drawer", "--algocfg", "bc", "--algo.data_path", TSDF_DEMOS,
                "--algo.max_iterations", str(BC_ITERATIONS), "--algo.save_frequence",
                str(BC_ITERATIONS), "--exp_name", "chip_smoke_bc_seed11", "--log.mode", "screen"])
            torch.cuda.synchronize()
        finally:
            torch.backends.cudnn.deterministic = False
        bc_wall = time.time() - t0
        loss = [log["Train/bc_loss"] for log in bc.train_logs]
        tail = float(np.mean(loss[-3:]))
        bc_path = os.path.join(bc.save_ckpt_dir, f"model_{BC_ITERATIONS}.ckpt")
        bc_out = {"iterations": bc.curr_iter, "bc_loss": loss, "mean_last_3": tail,
                  "constant_predictor_loss": const_loss, "wall_seconds": bc_wall,
                  "seconds_per_iteration_median_after_first": _median_after_first(bc.train_logs),
                  "width": (bc.n_minibatches, bc.lr, bc.lr_schedule,
                            bc.model_cfg["network"]["name"], bc.num_obs),
                  "kernel_launches": cuda_lib.launch_counts()}
        for k, v in bc_out["kernel_launches"].items():
            launches_total[k] = launches_total.get(k, 0) + v
        print(f"tsdf_student bc: loss {loss[0]:.4f} at 1, {tail:.4f} over the last 3 "
              f"(constant predictor {const_loss:.4f}), "
              f"{bc_out['seconds_per_iteration_median_after_first']:.3f} s an iteration",
              flush=True)
        if not (all(np.isfinite(loss)) and tail <= 0.5 * loss[0] and tail < const_loss
                and os.path.exists(bc_path) and bc.curr_iter == BC_ITERATIONS
                and not any(bc_out["kernel_launches"].values())):
            raise RuntimeError(f"tsdf_student bc does not fit its demos: {bc_out}")

        # 3. DAgger on mesh_tsdf, BC-pretrained, the demos ingested offline
        runner, mesh = _dagger_run("open_drawer", "mesh_tsdf", TSDF_DAGGER_ITERATIONS, [
            "--pretrain", bc_path, "--algo.offline_data_pth", TSDF_DEMOS], launches_total)
        pre = ckpt_lib.load(bc_path)["ac"]
        mesh["student_moved_from_bc"] = max(
            float((p.detach().cpu() - pre[n]).abs().max())
            for n, p in runner.student.named_parameters() if n.startswith("actor."))
        mesh["breakdown"] = _iteration_split(runner)
        macs = conv3d_macs()
        per_sample = sum(macs.values())
        # forward + backward (weight gradients of every layer, input gradients
        # of all but conv1, whose input is data), 2 operations a multiply-add
        samples = runner.n_updates * runner.num_mini_batches * runner.minibatch_sizes(
            runner.last_ts.buffer.stu_obs.shape[0])[0]
        flop = samples * (3 * per_sample - macs["conv1"]) * 2
        mesh["update_work"] = {"macs_per_sample_forward": macs, "macs_total": per_sample,
                               "samples_per_iteration": samples, "tflop_per_iteration": flop / 1e12,
                               "tflop_per_s": flop / mesh["breakdown"]["update_s"] / 1e12}
        mesh["step_breakdown"] = student_step_breakdown(runner)
        rows_real = runner.last_ts.buffer.stu_obs[:64].float()
        expected_rows = rows + VISION_ENVS * runner.n_steps * TSDF_DAGGER_ITERATIONS
        mesh_launch_ok = mesh["kernel_launches"] == mesh["expected_launches"]
        emit("tsdf_student_mesh", **mesh)
        print(f"tsdf_student mesh_tsdf: {mesh['seconds_per_iteration_median_after_first']:.3f} s "
              f"an iteration (collect {mesh['breakdown']['collect_s']:.3f}, update "
              f"{mesh['breakdown']['update_s']:.3f}, {mesh['update_work']['tflop_per_s']:.1f} "
              f"TFLOP/s); grid query {mesh['step_breakdown']['parts']['mesh_tsdf_query_ms']:.2f} "
              f"ms; launches {mesh['kernel_launches']}", flush=True)
        if (not mesh_launch_ok or mesh["non_finite"] or mesh["cur_buf_size"] != expected_rows
                or not mesh["student_moved_from_bc"] > 0
                or mesh["width"][:2] != (VISION_ENVS, (VISION_ENVS, DEMO_RES ** 3))
                or mesh["width"][3:9] != (19_200, 1280, 256, 2, 16, "Conv3DNet")):
            raise RuntimeError(f"tsdf_student mesh_tsdf failed: launches {mesh['kernel_launches']} "
                               f"(expected {mesh['expected_launches']}), non-finite "
                               f"{mesh['non_finite']}, buffer {mesh['cur_buf_size']} (expected "
                               f"{expected_rows}), moved {mesh['student_moved_from_bc']}, width "
                               f"{mesh['width']}")
        del runner

        # 4. DAgger on depth_tsdf, through B2
        runner, depth = _dagger_run("open_drawer", "depth_tsdf", DEPTH_DAGGER_ITERATIONS, [],
                                    launches_total)
        depth["step_breakdown"] = student_step_breakdown(runner)
        emit("tsdf_student_depth", **depth)
        print(f"tsdf_student depth_tsdf: {depth['seconds_per_iteration_median_after_first']:.3f} "
              f"s an iteration; step {depth['step_breakdown']['parts']}; launches "
              f"{depth['kernel_launches']}", flush=True)
        if (depth["kernel_launches"] != depth["expected_launches"] or depth["non_finite"]
                or depth["cur_buf_size"] != VISION_ENVS * DEPTH_DAGGER_ITERATIONS
                or depth["width"][-3:] != (288, 512, True)):
            raise RuntimeError(f"tsdf_student depth_tsdf failed: {depth}")
        del runner

        # 5. held against the plain versions on the card
        fusion = tsdf_integrate_check(vision_cases())
        conv = net_card_vs_cpu(rows_real, dict(bc.model_cfg, action_std=0.1))
        worst_tsdf = max(v["max_abs_err"] for v in fusion.values())
        emit("tsdf_student", demos=demos, bc=bc_out, fusion_check=fusion,
             fusion_tolerance={"max_abs_err": TSDF_TOL, "validity_flips_exact": 0},
             conv3d_check=conv, launches=launches_total)
        print(f"tsdf_student checks: fusion worst {worst_tsdf:.3g}, validity flips "
              f"{[v['validity_flips'] for v in fusion.values()]}; Conv3DNet card vs CPU "
              f"{conv['f32']['worst']:.3g} (TF32 control {conv['tf32_control']['worst']:.3g}, "
              f"must exceed {CONV_TOL:g})",
              flush=True)
        if (worst_tsdf > TSDF_TOL or not all(v["finite"] for v in fusion.values())
                or any(v["validity_flips"] for k, v in fusion.items() if k.endswith("exact"))
                or conv["f32"]["worst"] > CONV_TOL or not conv["tf32_control"]["worst"] > CONV_TOL):
            raise RuntimeError(f"tsdf_student checks failed: {fusion}, {conv}")
    finally:
        shutil.rmtree(TSDF_DEMOS, ignore_errors=True)
    return launches_total


# ----------------------------------------------------------------------
# the remaining vision modes: image students on grasp_cube (B1a, B2 at
# 1 × 72×128), the sparse-voxel student on open_drawer (B1b, B2, B3 at
# N = 50³)
# ----------------------------------------------------------------------

CUBE_FLAGS = ["--taskcfg", "grasp_cube", "--algocfg", "ppo"]
IMAGE_STUDENTS = (("depth_img", "depthResNet"), ("rgb_img", "ResNet"))
TEACHER_ITERATIONS = 3        # ppo.yaml runs 200000: enough to save a checkpoint
MODE_ITERATIONS = 4           # dagger.yaml runs 10000
RESNET_TOL = 1e-4             # card vs CPU on the card's branches, relative to the largest magnitude
FIT_RATIO = 0.9               # the trained student's buffer loss over its seeded start's, at most


def mode_rigs(task):
    """(image rig: 1 view of 72×128, volume rig: 3 views of 288×512 with the
    task's TSDF block) of ``task``'s camera."""
    from partmanip_tpu_torch.config import process_cfgs
    from partmanip_tpu_torch.envs import vision
    cfg, _ = process_cfgs(["--taskcfg", task])
    cam, block = cfg["task"]["cam"], cfg["task"]["obs_mode"]["tsdf"]
    return (vision.VisionRig(cam, block, "depth_img", device="cuda"),
            vision.VisionRig(cam, block, "depth_sparse", device="cuda"))


@torch.no_grad()
def mode_cases(drawer_cases):
    """Scene primitives at 16 envs on both tasks: open_drawer's
    ``drawer_cases`` (:func:`vision_cases`) and grasp_cube's reset and 40
    steps of a seeded random policy (no grasp_cube expert exists), with
    each task's rigs."""
    from partmanip_tpu_torch.envs import vision
    env, cfg = make_env(PATHS[0], VISION_ENVS)
    sim40, _ = random_rollout(env, cfg, 40, seed=5)
    state, _ = env.reset(env.init_state(env.make_generator(9)))
    cases = {f"drawer_{k}": ("open_drawer", v) for k, v in drawer_cases.items()}
    cases["cube_rollout40"] = ("grasp_cube", vision.scene_prims(env, sim40))
    cases["cube_reset"] = ("grasp_cube", vision.scene_prims(env, state.sim))
    return cases, {task: mode_rigs(task) for task in ("open_drawer", "grasp_cube")}


@torch.no_grad()
def mode_fps_rows(prims, vol_rig):
    """The rows B3 samples for depth_sparse, and those extract_surface_points
    samples, from the volume fused from B2's coarse-to-fine depth of the
    three views, as the env renders it."""
    from partmanip_tpu_torch.ops import raymarch_cuda, tsdf
    depth = raymarch_cuda.render_with(raymarch_cuda.march, prims, vol_rig.poses,
                                      vol_rig.intrinsic, vol_rig.im_h, vol_rig.im_w,
                                      coarse_to_fine=True)
    vol = tsdf.integrate(vol_rig.tsdf_spec, depth)
    return {"sparse_voxel": tsdf.sparse_points(vol_rig.tsdf_spec, vol)[0],
            "surface_points": tsdf.surface_points(vol_rig.tsdf_spec, vol)}


@torch.no_grad()
def mode_kernel_check(cases, rigs):
    """B2 against its plain version on the image rig (1 view, 72×128: a
    ragged tile row, the coarse pass one ragged tile row of 18×32), exact
    and coarse to fine, bit for bit; B3 against its plain version index for
    index on the sparse_voxel rows ([16, 50³, 3], integer coordinates, the
    far voxels at the origin) and the extract_surface_points rows ([16,
    3·50²·49, 3]) of each case, its compacted lengths against
    ``fps.compaction_plain``, with the cluster size it picked."""
    from partmanip_tpu_torch.ops import fps, raymarch, raymarch_cuda
    renders, sampled, failures = {}, {}, []
    for name, (task, prims) in cases.items():
        img_rig, vol_rig = rigs[task]
        for c2f in (False, True):
            tag = f"{name}_{'c2f' if c2f else 'exact'}"
            args = (prims, img_rig.poses, img_rig.intrinsic, img_rig.im_h, img_rig.im_w)
            got = raymarch_cuda.render_with(raymarch_cuda.march, *args, coarse_to_fine=c2f)
            want = raymarch_cuda.render_with(raymarch.march_plain, *args, coarse_to_fine=c2f)
            torch.cuda.synchronize()
            e = renders[tag] = {**_depth_errors(got, want), "kept": kept_shares(img_rig, prims, c2f)}
            if not (e["bit_equal"] == 1.0 and e["finite"]):
                failures.append(f"B2 {tag}: {e}")
        for kind, pts in mode_fps_rows(prims, vol_rig).items():
            tag = f"{name}_{kind}"
            _, want = fps.farthest_point_sampling_plain(pts, K_POINTS)
            got, counts = fps.launch(pts, K_POINTS)
            got = got.long()
            kept = fps.compaction_plain(pts).sum(1)
            torch.cuda.synchronize()
            sampled[tag] = {
                "rows": pts.shape[0], "points": pts.shape[1], "k": K_POINTS,
                "cluster": fps.cluster_for(*pts.shape[:2], pts.device),
                "index_match": float((got == want).float().mean()),
                "rows_equal": int((got == want).all(dim=1).sum()),
                "zero_points": float((pts == 0).all(-1).float().mean()),
                "compacted": counts.tolist(), "compacted_equal": torch.equal(counts.long(), kept)}
            if not (torch.equal(got, want) and sampled[tag]["compacted_equal"]):
                failures.append(f"B3 {tag}: {sampled[tag]}")
    img = rigs["grasp_cube"][0]
    emit("kernel_check", variant="b2+b3 vision modes", num_envs=VISION_ENVS,
         image=[img.num_view, img.im_h, img.im_w], k=K_POINTS,
         tolerances={"render": "bit-equal", "fps": "index-exact"},
         renders=renders, fps=sampled, failures=failures)
    for tag, v in sampled.items():
        print(f"kernel_check B3 {tag}: N {v['points']}, cluster {v['cluster']}, compacted "
              f"{min(v['compacted'])}-{max(v['compacted'])}, index match {v['index_match']}",
              flush=True)
    if failures:
        raise RuntimeError("kernel_check (b2, b3 at the vision modes' shapes) failed: "
                           + "; ".join(failures))


@torch.no_grad()
def mode_timing(cases, rigs, repeats=20):
    """B2 per coarse-to-fine render on grasp_cube's image rig (16 envs, 1 ×
    72×128) and B3 per call on the sparse_voxel rows of open_drawer's
    rollout scene ([16, 50³, 3]), by CUDA events, beside their plain
    versions and their bounds (B2's over the culled march as this input
    needs it, B3's over the compacted rows)."""
    from partmanip_tpu_torch.ops import fps, raymarch, raymarch_cuda
    img_rig = rigs["grasp_cube"][0]
    prims = cases["cube_rollout40"][1]
    args = (prims, img_rig.poses, img_rig.intrinsic, img_rig.im_h, img_rig.im_w)
    render = raymarch_cuda.render_with
    for _ in range(3):
        render(raymarch_cuda.march, *args, coarse_to_fine=True)
    E, S, G = VISION_ENVS, prims.sphere_radius.shape[1], prims.box_pos.shape[1]
    V, H, W = img_rig.num_view, img_rig.im_h, img_rig.im_w
    mask_bytes = sum(E * rays.cos_t.numel() * (S + G) for _, rays in render_passes(img_rig, True))
    prim_bytes = E * (4 * S + 11 * G) * 4
    nbytes = (2 * prim_bytes + mask_bytes + (3 * V * H * W // 16 + E * V * H * W // 16) * 4
              + (3 * V * H * W + 2 * E * V * H * W) * 4)
    b2 = {"image": [V, H, W], "num_envs": E,
          "ms": _timed(lambda: render(raymarch_cuda.march, *args, coarse_to_fine=True), repeats),
          "plain_ms": _timed(lambda: render(raymarch.march_plain, *args, coarse_to_fine=True), 3),
          "library_ms": None, **_bound(b2_operations(img_rig, prims, True), nbytes)}
    pts = mode_fps_rows(cases["drawer_rollout40"][1], rigs["open_drawer"][1])["sparse_voxel"]
    for _ in range(2):
        fps.farthest_point_sampling_cuda(pts, K_POINTS)
    _, counts = fps.launch(pts, K_POINTS)
    B, N, _ = pts.shape
    b3 = {"rows": B, "points": N, "k": K_POINTS, "cluster": fps.cluster_for(B, N, pts.device),
          "compacted_points": counts.tolist(),
          "ms": _timed(lambda: fps.farthest_point_sampling_cuda(pts, K_POINTS), repeats),
          "plain_ms": _timed(lambda: fps.farthest_point_sampling_plain(pts, K_POINTS), 3),
          "library_ms": None,
          **_bound(8.0 * K_POINTS * sum(counts.tolist()), B * N * 12 + B * K_POINTS * 4)}
    emit("timing", variant="b2 at 1 x 72x128", **b2)
    emit("timing", variant="b3 at N = 125,000 (sparse voxels)", **b3)
    return b2, b3


def resnet34_macs(in_channels, h=72, w=128, proprio=25, out=10):
    """Multiply-adds of one ResNet / depthResNet forward, counted from its
    shapes: every convolution (output pixels × output channels × kernel
    area × input channels), then the three dense layers."""
    from partmanip_tpu_torch.models.networks import ResNet34Backbone
    side = lambda n, k, s, p: (n + 2 * p - k) // s + 1
    h, w = side(h, 7, 2, 3), side(w, 7, 2, 3)
    macs = {"stem": h * w * 64 * 49 * in_channels}
    h, w = side(h, 3, 2, 1), side(w, 3, 2, 1)
    c, convs = 64, 0
    for features, n, stride in ResNet34Backbone.STAGES:
        for i in range(n):
            s_ = stride if i == 0 else 1
            ho, wo = side(h, 3, s_, 1), side(w, 3, s_, 1)
            convs += ho * wo * features * 9 * (c + features)
            if c != features or s_ != 1:
                convs += ho * wo * features * c
            h, w, c = ho, wo, features
    macs["blocks"] = convs
    macs["dense"] = (512 + proprio) * 128 + 128 * 32 + 32 * out
    return macs


@torch.no_grad()
def buffer_fit(runner, proprio, seed):
    """The DAgger loss over the rows of the runner's buffer, of its trained
    student and of the same student at its seeded start (``init(seed)``,
    the seed of the run's exp_name): over every row, and over each
    iteration's collection (``n_steps × num_envs`` rows, in the order
    written)."""
    from partmanip_tpu_torch.models.actor_critic import ActorCritic
    buf = runner.last_ts.buffer
    n = int(buf.size.item())
    block = runner.n_steps * runner.num_envs
    start = ActorCritic(runner.stu_num_obs, runner.num_actions, runner.model_cfg,
                        proprio_shape=proprio).to(runner.device)
    start.init(seed)

    def sums(net):
        out = []
        for a in range(0, n, block):
            rows = buf.stu_obs[a:a + block].float()
            label = runner._label(buf.tea_obs[a:a + block])
            out.append(float(((label - net.update_act(rows)) ** 2).sum()))
        return out
    trained, seeded = sums(runner.student), sums(start)
    per_row = lambda s: s / (block * runner.num_actions)
    total = lambda s: sum(s) / (n * runner.num_actions)
    return {"rows": n, "trained": total(trained), "seeded_start": total(seeded),
            "ratio": total(trained) / total(seeded),
            "by_iteration_trained": [per_row(s) for s in trained],
            "by_iteration_seeded_start": [per_row(s) for s in seeded]}


# the depthResNet runs of phase no_cudnn: the fewest iterations with an
# iteration-to-iteration spread (112-118 s an iteration without cuDNN on
# the H100)
NO_CUDNN_ITERATIONS = 2


def no_cudnn():
    """Phase ``no_cudnn``, run only when asked for (``--only no_cudnn``,
    about 6 minutes): ROADMAP Queue C's question whether depthResNet's
    cuDNN weight gradients, which part from float64 more than the CPU's
    (``net_card_vs_cpu``), change what DAgger learns.  The depth_img +
    depthResNet DAgger of ``vision_modes`` (grasp_cube, the teacher of
    :func:`cube_teacher`, seed 29) twice for NO_CUDNN_ITERATIONS: as
    shipped, and with ``torch.backends.cudnn.enabled = False`` (the
    student is the run's only network with convolutions, so only its
    convolutions leave cuDNN, for PyTorch's own kernels).  Prints both
    runs' Train/dagger_loss per iteration, their buffer fits and seconds
    an iteration.  Gates: exact launches, finite metrics, and every
    iteration's loss of the two runs within the shipped run's
    iteration-to-iteration spread."""
    teacher = cube_teacher({})
    runs, failures = {}, []
    for label, enabled in (("cudnn", True), ("without_cudnn", False)):
        with torch.backends.cudnn.flags(enabled=enabled, allow_tf32=False):
            runner, out = _dagger_run("grasp_cube", "depth_img", NO_CUDNN_ITERATIONS, [], {},
                                      teacher=teacher, network="depthResNet", seed=29)
            proprio = runner.env.num_obs["proprio_state"] if runner.add_proprio_obs else 0
            fit = buffer_fit(runner, proprio, seed=29)
        runs[label] = {"dagger_loss": out["dagger_loss"], "buffer_fit": fit,
                       "seconds_per_iteration": out["iteration_seconds"]}
        if out["kernel_launches"] != out["expected_launches"] or out["non_finite"]:
            failures.append(f"{label}: launches {out['kernel_launches']} (expected "
                            f"{out['expected_launches']}), non-finite {out['non_finite']}")
        del runner
    base, loss = runs["cudnn"]["dagger_loss"], runs["without_cudnn"]["dagger_loss"]
    spread = max(abs(b - a) for a, b in zip(base[:-1], base[1:]))
    diff = max(abs(a - b) for a, b in zip(loss, base))
    agree = diff <= spread
    emit("no_cudnn", iterations=NO_CUDNN_ITERATIONS, runs=runs, max_abs_diff=diff,
         iteration_spread=spread, agree_within_spread=agree, failures=failures)
    print(f"no_cudnn depth_img (depthResNet): Train/dagger_loss {base} with cuDNN, {loss} "
          f"without; largest gap {diff:.4g} against the iteration-to-iteration spread "
          f"{spread:.4g}; buffer fit {runs['cudnn']['buffer_fit']['ratio']:.4g} / "
          f"{runs['without_cudnn']['buffer_fit']['ratio']:.4g} of the seeded start; s an "
          f"iteration {runs['cudnn']['seconds_per_iteration']} / "
          f"{runs['without_cudnn']['seconds_per_iteration']}", flush=True)
    if not agree:
        failures.append(f"without cuDNN the loss parts from the shipped run's by {diff:.4g}, "
                        f"more than its iteration-to-iteration spread {spread:.4g}")
    if failures:
        raise RuntimeError("no_cudnn failed: " + "; ".join(failures))


def cube_teacher(launches_total):
    """The grasp_cube teacher: TEACHER_ITERATIONS PPO iterations of the
    port's own trainer at ppo.yaml's 2048 envs, its checkpoint saved at the
    last (B1a for every physics step: the first reset, then n_steps a
    iteration).  Returns the checkpoint's path."""
    import train_torch
    from partmanip_tpu_torch.utils import cuda_lib
    K = TEACHER_ITERATIONS
    cuda_lib.reset_launch_counts()
    t0 = time.time()
    runner = train_torch.main(CUBE_FLAGS + [
        "--algo.max_iterations", str(K), "--algo.save_frequence", str(K),
        "--exp_name", "chip_smoke_cube_teacher_seed13", "--log.mode", "screen"])
    torch.cuda.synchronize()
    launches = cuda_lib.launch_counts()
    for k, v in launches.items():
        launches_total[k] = launches_total.get(k, 0) + v
    path = os.path.join(runner.save_ckpt_dir, f"model_{K}.ckpt")
    expected = {"b1a": 1 + K * runner.n_steps * runner.env.control_freq_inv,
                "b1b": 0, "b1c": 0, "b1d": 0, "b1e": 0, "b2": 0, "b3": 0}
    bad = [k for k, v in runner.last_log.items() if k.startswith("Train/") and not np.isfinite(v)]
    emit("vision_modes_teacher", iterations=runner.curr_iter, num_envs=runner.env.num_envs,
         kernel_launches=launches, expected_launches=expected, wall_seconds=time.time() - t0,
         checkpoint=os.path.relpath(path, ROOT), non_finite=bad)
    if (launches != expected or bad or not os.path.exists(path)
            or runner.env.num_envs != NUM_ENVS or runner.curr_iter != K):
        raise RuntimeError(f"vision_modes teacher: launches {launches} (expected {expected}), "
                           f"non-finite {bad}, checkpoint {os.path.exists(path)}")
    return path


def vision_modes():
    """The remaining vision students through the CLI entry point at
    dagger.yaml's defaults (16 envs, buf_size 1200, minibatch 2048 capped
    to 5 chunks of minibatch_cap 256, 2 × 16 Adam steps): depth_img +
    depthResNet and rgb_img + ResNet on grasp_cube, taught by a PPO
    checkpoint the port writes here (:func:`cube_teacher`), and
    depth_sparse + PointNet on open_drawer with the committed expert;
    MODE_ITERATIONS iterations and one evaluation each.  Gates: launches
    equal to the printed formulas, finite Train/* and Val/*, the buffer's
    rows, the trained student's loss over every buffer row at most
    FIT_RATIO of its seeded start's (:func:`buffer_fit`; at dagger.yaml's
    lr 5e-5 a few iterations do not halve Train/dagger_loss, whose later
    iterations also average over rows the early student never saw, so its
    fall is printed, not gated), and for each ResNet on 8 buffer rows
    (:func:`net_card_vs_cpu`): its forward and weight gradients on the card
    within RESNET_TOL of the CPU's f32 run on the card run's ReLU and
    max-pool branches, where the TF32 control must not be, and every
    branch where the card parts from float64 a near-tie, within the
    layer's f32 rounding (:func:`_flip_census`).  Reports s per iteration,
    the split into collection and update, the ResNet update's TFLOP/s, one
    evaluation step taken apart and the card's idle share.  Returns the
    phase's launches per kernel."""
    launches_total = {}
    teacher = cube_teacher(launches_total)
    runs = [("grasp_cube", mode, net, teacher) for mode, net in IMAGE_STUDENTS]
    runs.append(("open_drawer", "depth_sparse", "PointNet", DRAWER_CKPT))
    failures = []
    for task, mode, network, tea in runs:
        runner, out = _dagger_run(task, mode, MODE_ITERATIONS, [], launches_total,
                                  teacher=tea, network=network, seed=29)
        out["breakdown"] = _iteration_split(
            runner, reps=1, iteration_s=out["seconds_per_iteration_median_after_first"],
            profile_epochs=1 if network in ("ResNet", "depthResNet") else None)
        out["step_breakdown"] = student_step_breakdown(runner)
        loss = out["dagger_loss"]
        out["loss_fall"] = {"iteration_1": loss[0], "mean_last_3": float(np.mean(loss[-3:])),
                            "ratio": float(np.mean(loss[-3:])) / loss[0]}
        proprio = runner.env.num_obs["proprio_state"] if runner.add_proprio_obs else 0
        out["buffer_fit"] = buffer_fit(runner, proprio, seed=29)
        if network in ("ResNet", "depthResNet"):
            macs = resnet34_macs(runner.student.actor.in_channels, proprio=proprio,
                                 out=runner.num_actions)
            samples = runner.n_updates * runner.num_mini_batches * runner.minibatch_sizes(
                runner.last_ts.buffer.stu_obs.shape[0])[0]
            # forward + backward, but no input gradient of the stem (its input is data)
            flop = samples * (3 * sum(macs.values()) - macs["stem"]) * 2
            out["update_work"] = {"macs_per_sample_forward": macs,
                                  "gmacs_per_sample": sum(macs.values()) / 1e9,
                                  "samples_per_iteration": samples,
                                  "tflop_per_iteration": flop / 1e12,
                                  "tflop_per_s": flop / out["breakdown"]["update_s"] / 1e12}
            rows = runner.last_ts.buffer.stu_obs[:8].float()
            out["card_vs_cpu"] = net_card_vs_cpu(rows, dict(runner.model_cfg), proprio,
                                                 kinks=True)
        emit(f"vision_modes_{mode}", **out)
        b, st = out["breakdown"], out["step_breakdown"]
        work = out.get("update_work")
        print(f"vision_modes {mode} ({network}, {task}): "
              f"{out['seconds_per_iteration_median_after_first']:.3f} s an iteration (collect "
              f"{b['collect_s']:.3f}, update {b['update_s']:.3f}"
              + (f", {work['tflop_per_s']:.1f} TFLOP/s" if work else "")
              + f"); card idle {b.get('device_idle_share')}; buffer {out['buffer_gb']:.3f} GB; "
              f"loss {loss[0]:.4g} at 1, {out['loss_fall']['mean_last_3']:.4g} over the last 3; "
              f"buffer fit {out['buffer_fit']['trained']:.4g} (seeded start "
              f"{out['buffer_fit']['seeded_start']:.4g}); "
              f"step {st['parts']}; launches {out['kernel_launches']} "
              f"({out['launch_formula']})", flush=True)
        if "card_vs_cpu" in out:
            c = out["card_vs_cpu"]
            m, t, flips = c["f32_on_card_branches"], c["tf32_control_on_its_branches"], c["card_flips"]
            print(f"vision_modes {mode}: {network} card vs CPU in f32 on the card's branches "
                  f"{m['worst']:.3g} at {m['at']} (TF32 control {t['worst']:.3g}, must exceed "
                  f"{RESNET_TOL:g}); the card's flips against float64: {flips['flips']} at "
                  f"{[(k['kink'], k['flips'], round(k['margin_over_rounding'], 4)) for k in flips['with_flips']]} "
                  f"(kink, flips, margin over rounding), all within rounding {flips['all_within']}; "
                  f"the CPU's f32 flips {c['cpu_flips']['flips']}; against float64 on own "
                  f"branches: card {c['f64_card']['worst']:.3g} at {c['f64_card']['at']}, card "
                  f"without cuDNN {c['f64_card_no_cudnn']['worst']:.3g}, CPU f32 "
                  f"{c['f64_cpu']['worst']:.3g}; on the card's branches: card "
                  f"{c['f64_card_on_card_branches']['worst']:.3g}, CPU f32 "
                  f"{c['f64_cpu_on_card_branches']['worst']:.3g}", flush=True)
            if (m["worst"] > RESNET_TOL or not t["worst"] > RESNET_TOL
                    or not flips["all_within"]):
                failures.append(f"{mode}: card vs CPU {c}")
        w = out["width"]
        img = (72, 128, True) if "img" in mode else (288, 512, True)
        if (out["kernel_launches"] != out["expected_launches"] or out["non_finite"]
                or out["cur_buf_size"] != VISION_ENVS * MODE_ITERATIONS
                or w[:2] != (VISION_ENVS, (VISION_ENVS, runner.stu_num_obs))
                or w[2:9] != ("torch.bfloat16", 19_200, 1280, 256, 2, 16, network)
                or w[-3:] != img or runner.curr_iter != MODE_ITERATIONS):
            failures.append(f"{mode}: launches {out['kernel_launches']} (expected "
                            f"{out['expected_launches']}), non-finite {out['non_finite']}, "
                            f"buffer {out['cur_buf_size']}, width {w}")
        fit = out["buffer_fit"]
        if not fit["ratio"] <= FIT_RATIO:
            failures.append(f"{mode}: the trained student's loss over its buffer is above "
                            f"{FIT_RATIO:g} of its seeded start's: {fit}")
        del runner
    emit("vision_modes", launches=launches_total, failures=failures)
    if failures:
        raise RuntimeError("vision_modes failed: " + "; ".join(failures))
    return launches_total


# ----------------------------------------------------------------------
# the tooling path: B1d under tune_pid_torch.py, the bias builds of every
# B1 variant, the open_drawer evaluation with --sim.coriolis and with
# capture, the diag twins
# ----------------------------------------------------------------------

# tools/tune_pid.py --envs 4 --const, the JAX package on the CPU (its
# printed ratios)
TUNE_PID_JAX = {"base_x": 0.383, "tip_x": 1.266, "grip": 0.951}
# docs/CALIBRATION.md's table (an older run of the same tool), printed
CALIBRATION_RECORD = {"base_x": -0.10, "tip_x": 1.07, "grip": 0.95}
TUNE_PID_TOL = 0.03            # the card against the JAX package's ratios
TUNE_PID_CPU_TOL = 1e-3        # the card against the port's plain version on the CPU
# scripts/diag_cube.py at its defaults (4 envs, 200 steps), the JAX
# package on the CPU: "ever success"
DIAG_CUBE_JAX_EVER_SUCCESS = [True, True, True, True]
CAPTURE_STEPS = 200            # open_drawer.yaml maxEpisodeLength

B1D_PATH = Path(kernel="b1d",
                source="partmanip_tpu_torch/csrc/fused_inner_step.cu",
                replaces="partmanip_tpu/sim/fused.py:1398",
                replaces_function="partmanip_tpu/sim/fused.py:_inner_step_tiled "
                                  "(neither has_body nor has_obj, flags :1234-1235)",
                flags=[], main_flags=[], part="robot", rollout=None, rollout_steps=20,
                policy=None, draws=None, chain_physics_steps=1, chain_tol=0.0,
                min_success=None)


def robot_only_env(num_envs, device="cuda"):
    """The calibration scene of ``tune_pid_torch.py`` (the mobile Franka and
    the ground, no object) at ``num_envs`` envs, as the object the kernel
    checks take for an env: (env, start state, control config)."""
    import types
    import tune_pid_torch
    device = torch.device(device)
    scene, state, ctrl = tune_pid_torch.build(num_envs, device)
    env = types.SimpleNamespace(scene=scene, spheres=scene.spheres, num_envs=num_envs,
                                device=device)
    return env, state, ctrl


@torch.no_grad()
def robot_only_cases(env, state, ctrl, seed=5):
    """B1d's states: ``rollout20``, 20 control steps of the calibration
    harness's random ik commands from the start pose (through the kernel);
    ``contact``, the start pose jittered, with random joint velocities and
    the root lowered so that the lowest finger-pad (sticky) sphere of each
    env sits 0-4 mm in the ground, two plain inner steps in (anchors
    exist)."""
    import tune_pid_torch
    from partmanip_tpu_torch.envs import control
    from partmanip_tpu_torch.sim import contact, engine, kinematics
    scene, E = env.scene, env.num_envs
    rs = np.random.RandomState(seed)
    cuda = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=env.device)
    st = state
    for _ in range(20):
        a = cuda(rs.uniform(-1, 1, (E, 10)))
        st, _, _ = tune_pid_torch.step(scene, ctrl, st, a, 2)
    fk = kinematics.forward_kinematics(scene.robot, st.robot)
    view = control.robot_view(ctrl, scene.robot, fk, st.robot)
    rollout = (st, control.compute_targets(ctrl, scene.robot, view,
                                           cuda(rs.uniform(-1, 1, (E, 10)))))
    D = scene.robot.num_dofs
    robot = state.robot._replace(
        qpos=state.robot.qpos + cuda(rs.uniform(-0.05, 0.05, (E, D))),
        qvel=cuda(rs.uniform(-0.3, 0.3, (E, D))))
    fk = kinematics.forward_kinematics(scene.robot, robot)
    centres = contact.sphere_positions(scene.robot, fk, scene.spheres, E)
    gap = centres[..., 2] - scene.spheres.radius[None]
    low = torch.where(scene.spheres.sticky[None] > 0, gap, 1e9).min(dim=1).values
    root = robot.root_pos.clone()
    root[:, 2] -= low + cuda(rs.uniform(0.0, 0.004, E))
    sim = engine.SceneState(robot=robot._replace(root_pos=root))
    targets = robot.qpos + cuda(rs.uniform(-0.02, 0.02, (E, D)))
    sim = engine.plain_physics_step(scene, sim, targets, n_steps=2)
    return {"rollout20": rollout, "contact": (sim, targets)}


def bias_scenes(scene):
    """The scenes of the bias builds' checks: ``coriolis`` (the
    velocity-product term, gravity_scale as shipped: 0), and with
    gravity_scale 1 on the robot and, where there is one, on the object
    tree."""
    out = {"coriolis": scene._replace(params=scene.params._replace(coriolis=True)),
           "robot_gravity": scene._replace(robot=scene.robot._replace(
               gravity_scale=torch.ones_like(scene.robot.gravity_scale)))}
    if scene.obj_tree is not None:
        out["object_gravity"] = scene._replace(obj_tree=scene.obj_tree._replace(
            gravity_scale=torch.ones_like(scene.obj_tree.gravity_scale)))
    return out


# which bias cases each variant's kernel check runs
BIAS_CASES = {"b1a": ("coriolis", "robot_gravity"),
              "b1b": ("coriolis", "robot_gravity", "object_gravity"),
              "b1c": ("coriolis", "robot_gravity", "object_gravity"),
              "b1d": ("coriolis", "robot_gravity")}
FAST_QVEL = 2.0                # rad/s (m/s on the base): the coriolis cases' joint speeds
TILT = 0.2                     # rad about the world y axis: the object_gravity cases' cabinets


@torch.no_grad()
def bias_cases(name, cases, seed=7):
    """The states of a bias case, made from a path's ``cases`` so that the
    default build misses the plain version with the bias by more than TOL
    (measured on the CPU: 0.015-0.05 rad/s in qvel, 0.008 m/s in the
    drawers' qvel, in one inner step).  ``coriolis``: the robot's joint
    velocities drawn in ±FAST_QVEL (the velocity product grows with their
    square; the rollouts move at a few tenths).  ``object_gravity``: each
    cabinet's root tilted by TILT about the world y axis, so that gravity
    has a component along the drawers' prismatic joints (upright, the
    object's bias is 0 whatever its gravity_scale).  ``robot_gravity``:
    the cases as they are."""
    from partmanip_tpu_torch.ops import rotations as rot
    if name == "robot_gravity":
        return cases
    rs = np.random.RandomState(seed)
    out = {}
    for case, (sim, targets) in cases.items():
        if name == "coriolis":
            q = sim.robot.qvel
            fast = torch.as_tensor(rs.uniform(-FAST_QVEL, FAST_QVEL, q.shape).astype(np.float32),
                                   device=q.device)
            sim = sim._replace(robot=sim.robot._replace(qvel=fast))
        else:
            q = sim.obj.root_quat
            t = torch.tensor([0.0, math.sin(TILT / 2), 0.0, math.cos(TILT / 2)],
                             dtype=q.dtype, device=q.device)
            sim = sim._replace(obj=sim.obj._replace(root_quat=rot.quat_mul(t.expand_as(q), q)))
        out[case] = (sim, targets)
    return out


def tooling_build(scenes):
    """Compile the bias builds of every B1 variant and B1d (one nvcc per
    library, all started together).  Returns the ptxas lines per library."""
    from partmanip_tpu_torch.sim import fused
    from partmanip_tpu_torch.utils import cuda_lib
    libs = list({fused.scene_library(s).path: fused.scene_library(s) for s in scenes}.values())
    t0 = time.time()
    procs = [lib.start() for lib in libs]
    reports = [lib.finish(p) for lib, p in zip(libs, procs)]
    for lib in libs:
        lib.load()
    ptxas = {lib.name: cuda_lib.ptxas_lines(r) for lib, r in zip(libs, reports)}
    emit("tooling_build", seconds=time.time() - t0,
         defines={lib.name: dict(lib.defines) for lib in libs}, ptxas=ptxas)
    return ptxas


@torch.no_grad()
def build_timing(scene, variants, buf, anc_b, n, repeats=20):
    """ms of one launch of n inner steps (CUDA events around the wrapper's
    launch) and device ms (``torch.profiler``) of each scene in
    ``variants`` on the same state, side by side."""
    from partmanip_tpu_torch.sim import fused
    out = {}
    for name, sc in variants.items():
        for _ in range(3):
            fused.launch_packed(sc, buf, anc_b, n)
        ms = _timed(lambda: fused.launch_packed(sc, buf, anc_b, n), repeats)
        dev_ms, _ = _device_ms(lambda: fused.launch_packed(sc, buf, anc_b, n),
                               [KERNEL_FUNCTIONS[fused.variant(sc)]])
        out[name] = {"ms": ms, "kernel_device_ms": dev_ms,
                     "library": fused.scene_library(sc).name}
    return out


@torch.no_grad()
def b1d_timing(env, sim, targets, repeats=20):
    """B1d at the calibration harness's 4 envs and at 2048: the wrapper's
    launch (ms), its device time, the plain version, and the bound from
    this run's contacts (``inner_step_flops``)."""
    from partmanip_tpu_torch.sim import engine, fused
    from partmanip_tpu_torch.utils import contact_states
    p = env.scene.params
    n = p.substeps * p.inner_substeps
    by_envs = {}
    for E in (4, env.num_envs):
        s = type(sim)(robot=type(sim.robot)(*[x[:E].contiguous() for x in sim.robot]),
                      anchors=type(sim.anchors)(*[x[:E].contiguous() for x in sim.anchors]))
        buf, anc_b = fused.pack_state(s, targets[:E].contiguous())
        for _ in range(3):
            fused.launch_packed(env.scene, buf, anc_b, n)
        ms = _timed(lambda: fused.launch_packed(env.scene, buf, anc_b, n), repeats)
        dev_ms, _ = _device_ms(lambda: fused.launch_packed(env.scene, buf, anc_b, n),
                               [KERNEL_FUNCTIONS["b1d"]])
        by_envs[str(E)] = {"ms": ms, "kernel_device_ms": dev_ms}
    buf, anc_b = fused.pack_state(sim, targets)
    engine.plain_physics_step(env.scene, sim, targets)
    plain_ms = _timed(lambda: engine.plain_physics_step(env.scene, sim, targets), 3)
    touching = contact_states.touching_counts(env, sim)
    E = env.num_envs
    flops = inner_step_flops(env, touching) * n * E
    nbytes = 2 * (buf.numel() * 4 + anc_b.numel() * 4)
    ops_ms, bytes_ms = flops / H100_F32_FLOPS * 1e3, nbytes / H100_BYTES_PER_S * 1e3
    big = by_envs[str(E)]
    out = {"ms": big["ms"], "kernel_device_ms": big["kernel_device_ms"], "ms_by_envs": by_envs,
           "plain_ms": plain_ms, "bound_ms": max(ops_ms, bytes_ms),
           "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
           "bound_operations_ms": ops_ms, "bound_bytes_ms": bytes_ms,
           "flops_per_launch": flops, "bytes_per_launch": nbytes, "touching": touching,
           "num_envs": E, "n_steps": n, "library_ms": None,
           "launch_config": fused.launch_config(E, fused._dims(env.scene), False, False),
           "occupancy": {"blocks_per_sm": fused.occupancy(env.scene)}}
    return out


def _physics_calls():
    """Count every ``engine.physics_step`` call from here on: (counter,
    undo).  The launch counts must equal it, which shows that every physics
    step went through the kernel."""
    from partmanip_tpu_torch.sim import engine
    orig = engine.physics_step
    calls = [0]

    def counted(*a, **k):
        calls[0] += 1
        return orig(*a, **k)
    engine.physics_step = counted
    return calls, lambda: setattr(engine, "physics_step", orig)


def tune_pid_check():
    """``tune_pid_torch.py --envs 4 --const`` on the card (every physics
    step through B1d, launches exact) and with ``--device cpu`` (the plain
    version): per channel the ratio on the card within TUNE_PID_CPU_TOL of
    the CPU's and within TUNE_PID_TOL of the JAX package's
    (TUNE_PID_JAX); docs/CALIBRATION.md's record is printed beside them."""
    import tune_pid_torch
    from partmanip_tpu_torch.utils import cuda_lib
    cuda_lib.reset_launch_counts()
    calls, undo = _physics_calls()
    t0 = time.time()
    try:
        card = tune_pid_torch.main(["--envs", "4", "--const"])
    finally:
        undo()
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = cuda_lib.launch_counts()
    cpu = tune_pid_torch.main(["--envs", "4", "--const", "--device", "cpu"])
    ratios = {k: v["ratio"] for k, v in card.items()}
    vs_cpu = max(abs(ratios[k] - cpu[k]["ratio"]) for k in ratios)
    vs_jax = max(abs(ratios[k] - TUNE_PID_JAX[k]) for k in ratios)
    vs_record = {k: ratios[k] - CALIBRATION_RECORD[k] for k in ratios}
    expected = 3 * 10 * 2                    # channels x control steps x cfi
    out = {"ratios": ratios, "cpu_ratios": {k: v["ratio"] for k, v in cpu.items()},
           "jax_ratios": TUNE_PID_JAX, "calibration_record": CALIBRATION_RECORD,
           "max_abs_vs_cpu": vs_cpu, "max_abs_vs_jax": vs_jax,
           "minus_calibration_record": vs_record, "launches": launches,
           "physics_steps": calls[0], "expected_launches": expected, "wall_seconds": wall,
           "table": card}
    failures = []
    if launches["b1d"] != expected or calls[0] != expected or sum(launches.values()) != expected:
        failures.append(f"tune_pid launches {launches}, physics steps {calls[0]}, "
                        f"expected {expected} through b1d")
    if not vs_cpu <= TUNE_PID_CPU_TOL:
        failures.append(f"tune_pid card vs CPU {vs_cpu:.3g} > {TUNE_PID_CPU_TOL}")
    if not vs_jax <= TUNE_PID_TOL:
        failures.append(f"tune_pid card vs the JAX package {vs_jax:.3g} > {TUNE_PID_TOL}")
    return out, failures


def _drawer_eval(extra, exp):
    """The open_drawer evaluation of the committed expert at the YAML
    defaults through the CLI entry point, with ``extra`` flags; (runner,
    launches, physics_step calls, wall s)."""
    import train_torch
    from partmanip_tpu_torch.utils import cuda_lib
    path = PATHS[1]
    cuda_lib.reset_launch_counts()
    calls, undo = _physics_calls()
    torch.cuda.synchronize()
    t0 = time.time()
    try:
        runner = train_torch.main(path.flags + ["--resume", DRAWER_CKPT, "--exp_name", exp,
                                                "--test_only", "--log.mode", "screen", *extra])
    finally:
        undo()
    torch.cuda.synchronize()
    return runner, cuda_lib.launch_counts(), calls[0], time.time() - t0


def coriolis_eval():
    """open_drawer's evaluation at the YAML defaults with ``--sim.coriolis``
    (B1b's bias build): launches exact, metrics and state finite;
    Test/succ_rate_max printed, not gated (no JAX record with coriolis)."""
    runner, launches, calls, wall = _drawer_eval(["--sim.coriolis"],
                                                 "chip_smoke_coriolis_seed389")
    env, T = runner.env, runner.env.max_episode_length
    expected = runner.eval_round * (1 + T * env.control_freq_inv) + 1
    log = runner.last_log
    sim = runner.last_env_state.sim
    finite = all(bool(torch.isfinite(x).all()) for part in (sim.robot, sim.obj) for x in part)
    bad = [k for k, v in log.items() if not np.isfinite(v)]
    out = {"num_envs": env.num_envs, "steps": T, "coriolis": env.scene.params.coriolis,
           "launches": launches, "physics_steps": calls, "expected_launches": expected,
           "wall_seconds": wall, "succ_rate_max": log.get("Test/succ_rate_max"),
           "metrics": log}
    failures = []
    if (launches["b1b"] != expected or calls != expected
            or sum(launches.values()) != expected or not env.scene.params.coriolis):
        failures.append(f"coriolis evaluation launches {launches}, physics steps {calls}, "
                        f"expected {expected} through b1b")
    if bad or not finite or env.num_envs != NUM_ENVS:
        failures.append(f"coriolis evaluation not finite: {bad}, state ok={finite}")
    print(f"tooling coriolis: Test/succ_rate_max {out['succ_rate_max']} (ungated)", flush=True)
    return out, failures


def _video_frames(video_dir):
    """('mp4', frames in video.mp4) when cv2 made the video, ('npy', the
    .npy frames) without cv2."""
    names = sorted(os.listdir(video_dir))
    if "video.mp4" in names:
        import cv2
        cap = cv2.VideoCapture(os.path.join(video_dir, "video.mp4"))
        n = 0
        while cap.read()[0]:
            n += 1
        cap.release()
        return "mp4", n
    return "npy", sum(1 for f in names if f.endswith(".npy"))


@torch.no_grad()
def capture_eval():
    """open_drawer's evaluation at the YAML defaults with ``--save_pose
    --save_video``: one captured episode (a pose dict a step; a 512x1024
    frame of env 3 a step through ``render_rgb``, its depth through B2)
    before the evaluation round.  Gates: Test/succ_rate_max >= 0.8, B1b
    launches exact (both episodes), B2 one launch a frame, every pose file
    with the JAX package's keys and shapes, every frame in the video (or
    as .npy without cv2); B2's depth of the last frame's scene at 512x1024
    bit-equal to ``march_plain``'s."""
    from partmanip_tpu_torch.algos import ppo
    from partmanip_tpu_torch.ops import raymarch, raymarch_cuda
    runner, launches, calls, wall = _drawer_eval(["--save_pose", "--save_video"],
                                                 "chip_smoke_capture_seed389")
    env, T = runner.env, runner.env.max_episode_length
    E = env.num_envs
    episode = 1 + T * env.control_freq_inv
    expected = {"b1b": (1 + runner.eval_round) * episode + 1, "b2": T}
    pose_dir = os.path.join(runner.logger.save_pose_dir, f"Iter{runner.curr_iter}")
    video_dir = os.path.join(runner.logger.save_video_dir, f"Iter{runner.curr_iter}")
    pose_files = sorted(os.listdir(pose_dir))
    d = np.load(os.path.join(pose_dir, "0.npy"), allow_pickle=True).item()
    shapes = {k: (tuple(v.shape), str(v.dtype)) for k, v in d.items()}
    want = {"rot": ((E, 12, 3, 3), "float32"), "pos": ((E, 12, 3), "float32"),
            "state": ((E, runner.num_obs), "float32"),
            "action": ((E, runner.num_actions), "float32"), "success": ((E,), "bool")}
    kind, frames = _video_frames(video_dir)
    # one frame's depth: B2 against the plain march, on the final state
    args = (ppo.video_prims(env, runner.last_env_state.sim, min(3, E - 1)),
            *ppo.video_camera(env, ppo.VIDEO_RES))
    got = raymarch_cuda.render_with(raymarch_cuda.march, *args)
    ref = raymarch_cuda.render_with(raymarch.march_plain, *args)
    depth = _depth_errors(got, ref)
    log = runner.last_log
    succ = log.get("Test/succ_rate_max", float("nan"))
    out = {"num_envs": E, "steps": T, "launches": launches, "physics_steps": calls,
           "expected_launches": expected, "wall_seconds": wall, "succ_rate_max": succ,
           "pose_files": len(pose_files), "pose_shapes": shapes, "frames": frames,
           "frames_kind": kind, "video_res": list(ppo.VIDEO_RES), "frame_depth_vs_plain": depth,
           "metrics": log}
    print(f"tooling capture: {len(pose_files)} pose files, {frames} frames as {kind}, "
          f"Test/succ_rate_max {succ}", flush=True)
    failures = []
    if (launches["b1b"] != expected["b1b"] or calls != expected["b1b"]
            or launches["b2"] != expected["b2"]
            or sum(launches.values()) != expected["b1b"] + expected["b2"]):
        failures.append(f"capture launches {launches}, physics steps {calls}, expected {expected}")
    if not succ >= PATHS[1].min_success:
        failures.append(f"capture Test/succ_rate_max {succ} < {PATHS[1].min_success}")
    if pose_files != sorted(f"{i}.npy" for i in range(T)) or shapes != {
            k: (s, t) for k, (s, t) in want.items()} or not np.isfinite(d["rot"]).all():
        failures.append(f"pose files {len(pose_files)}, shapes {shapes}, want {want}")
    if frames != T:
        failures.append(f"{frames} frames ({kind}), expected {T}")
    if not (depth["bit_equal"] == 1.0 and depth["finite"]):
        failures.append(f"video frame depth B2 vs plain: {depth}")
    return out, failures


def diag_twins():
    """The three diag twins at their defaults on the card: every physics
    step through B1a (the cube scripts) or B1b (the drawer), launches
    exact, state finite; diag_torch_cube's ever-success flags equal the JAX
    package's (DIAG_CUBE_JAX_EVER_SUCCESS)."""
    import importlib.util
    from partmanip_tpu_torch.utils import cuda_lib

    def script(name):
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(ROOT, "scripts", f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    runs = {"diag_torch_cube": ("b1a", []), "poke_torch_cube": ("b1a", []),
            "diag_torch_drawer": ("b1b", ["--asset_root", os.path.join(ROOT, "assets")])}
    out, failures = {}, []
    for name, (kernel, argv) in runs.items():
        cuda_lib.reset_launch_counts()
        calls, undo = _physics_calls()
        t0 = time.time()
        try:
            res = script(name).main(argv)
        finally:
            undo()
        torch.cuda.synchronize()
        launches = cuda_lib.launch_counts()
        flat = np.concatenate([np.asarray(x, np.float64).ravel() for x in res])
        out[name] = {"launches": launches, "physics_steps": calls[0],
                     "wall_seconds": time.time() - t0, "result": flat.tolist()[:16]}
        if (launches[kernel] != calls[0] or sum(launches.values()) != calls[0]
                or calls[0] == 0 or not np.isfinite(flat).all()):
            failures.append(f"{name}: launches {launches}, physics steps {calls[0]}, "
                            f"result finite {bool(np.isfinite(flat).all())}")
    ever = [bool(x) for x in out["diag_torch_cube"]["result"][:4]]
    out["diag_torch_cube"]["ever_success"] = ever
    out["diag_torch_cube"]["jax_ever_success"] = DIAG_CUBE_JAX_EVER_SUCCESS
    if ever != DIAG_CUBE_JAX_EVER_SUCCESS:
        failures.append(f"diag_torch_cube ever success {ever}, the JAX package's "
                        f"{DIAG_CUBE_JAX_EVER_SUCCESS}")
    return out, failures


def tooling(envs):
    """Phase ``tooling``: the bias builds of B1a / B1b / B1c and kernel B1d
    held against the plain version (one inner step under TOL and n in one
    launch equal to n launches, on each path's rollout and contact states
    made fast or tilted by :func:`bias_cases`, with the default build as
    the control and the bias effect within BIAS_EFFECT_REL; B1d on the
    calibration scene), B1d timed at 4 and 2048 envs and each
    bias build beside its default build, then the tools through their
    entry points: ``tune_pid_torch.py --envs 4 --const``, the open_drawer
    evaluation with ``--sim.coriolis`` and with ``--save_pose
    --save_video``, and the three diag twins.  Returns B1d's entry of the
    ``kernels`` line and each B1 variant's bias-build readings."""
    from partmanip_tpu_torch.sim import fused
    t_phase = time.time()
    renv, rstate, ctrl = robot_only_env(NUM_ENVS)
    scenes = [renv.scene] + [sc for env, _ in envs for sc in bias_scenes(env.scene).values()]
    scenes += list(bias_scenes(renv.scene).values())
    ptxas = tooling_build(scenes)
    rcases = robot_only_cases(renv, rstate, ctrl)
    checks, timing, failures = {}, {}, []
    worst_b1d = phase_kernel_check(B1D_PATH, renv, rcases, build="default", rounding=False)
    for path, (env, cfg) in list(zip(PATHS, envs)) + [(B1D_PATH, (renv, None))]:
        cases = rcases if path is B1D_PATH else check_cases(path, env, cfg)
        scs = bias_scenes(env.scene)
        checks[path.kernel] = {name: phase_kernel_check(path, env, bias_cases(name, cases),
                                                        scene=scs[name], build=name,
                                                        rounding=False, control=env.scene)
                               for name in BIAS_CASES[path.kernel]}
        sim, targets = next(iter(cases.values()))
        p = env.scene.params
        buf, anc_b = fused.pack_state(sim, targets)
        timing[path.kernel] = build_timing(
            env.scene, {"default": env.scene, "coriolis": scs["coriolis"]}, buf, anc_b,
            p.substeps * p.inner_substeps)
    b1d_time = b1d_timing(renv, *rcases["rollout20"])
    emit("tooling_kernels", max_abs_err_bias=checks, build_timing=timing, b1d=b1d_time,
         seconds=time.time() - t_phase)
    tune, f1 = tune_pid_check()
    emit("tooling_tune_pid", **tune)
    cor, f2 = coriolis_eval()
    emit("tooling_coriolis", **cor)
    cap, f3 = capture_eval()
    emit("tooling_capture", **cap)
    diag, f4 = diag_twins()
    emit("tooling_diag", **diag)
    failures += f1 + f2 + f3 + f4
    emit("tooling", seconds=time.time() - t_phase, failures=failures)
    if failures:
        raise RuntimeError("tooling failed: " + "; ".join(failures))
    b1d = {"name": "fused_inner_step_b1d", "route": "cuda", "source": B1D_PATH.source,
           "replaces": B1D_PATH.replaces, "replaces_function": B1D_PATH.replaces_function,
           "launches": tune["launches"]["b1d"], "max_abs_err": worst_b1d,
           "ptxas": ptxas["b1d"], **b1d_time,
           "bias_build": {"max_abs_err": checks["b1d"], **timing["b1d"],
                          "ptxas": ptxas["b1d_bias"]}}
    bias = {k: {"max_abs_err": checks[k], **timing[k], "ptxas": ptxas[f"{k}_bias"]}
            for k in ("b1a", "b1b", "b1c")}
    return b1d, bias


# ----------------------------------------------------------------------
# kernel B1e: open_drawer's cabinet with grasp_cube's free cube beside it
# ----------------------------------------------------------------------

B1E_PATH = Path(kernel="b1e",
                source="partmanip_tpu_torch/csrc/fused_inner_step_obj.cu",
                replaces="partmanip_tpu/sim/fused.py:793",
                replaces_function="partmanip_tpu/sim/fused.py:_inner_step_tiled "
                                  "(has_body and has_obj, flags :1234-1235; the cube's "
                                  "branches :793, :934-952, :998-1016, :1066)",
                flags=[], main_flags=[], part="obj", rollout=None, rollout_steps=0,
                policy=None, draws=None, chain_physics_steps=1, chain_tol=0.0,
                min_success=None)
B1E_STEPS = 20                # control steps of B1e's main path
B1E_BIAS_CASES = ("coriolis", "robot_gravity", "object_gravity")


def body_drawer_env(drawer_env, cube_env):
    """open_drawer's env at full width with grasp_cube's cube added to its
    scene (no entry point of either package builds this scene), as the
    object the kernel checks and timings take for an env."""
    import types
    return types.SimpleNamespace(
        scene=drawer_env.scene._replace(free_body=cube_env.scene.free_body),
        spheres=drawer_env.spheres, built=drawer_env.built, num_envs=drawer_env.num_envs,
        device=drawer_env.device, control_freq_inv=drawer_env.control_freq_inv)


@torch.no_grad()
def b1e_contact_case(benv, drawer_env, seed=6):
    """``contact_states.body_drawer_contact_states`` (the cube on the hand or
    against a finger pad on the ground, the pads on the handle), two plain
    inner steps in: anchors exist on the cube and on the handle."""
    from partmanip_tpu_torch.sim import engine
    from partmanip_tpu_torch.utils import contact_states, convert
    st, tg = contact_states.body_drawer_contact_states(
        drawer_env, benv.scene.free_body, benv.num_envs, seed)
    sim = convert.scene_state_from_numpy(st, benv.device)
    targets = torch.as_tensor(tg, device=benv.device)
    return engine.plain_physics_step(benv.scene, sim, targets, n_steps=2), targets


@torch.no_grad()
def b1e_main_path(benv, sim, targets):
    """B1e's main path: ``engine.physics_step``, the entry point every env
    steps through, B1E_STEPS times on the composed scene at full width from
    the contact case with held targets; every step one B1e launch and none
    of another kernel; finite state.  Returns (launches, final state,
    seconds)."""
    from partmanip_tpu_torch.sim import engine
    from partmanip_tpu_torch.utils import cuda_lib
    cuda_lib.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    for _ in range(B1E_STEPS):
        sim = engine.physics_step(benv.scene, sim, targets)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = cuda_lib.launch_counts()
    others = sum(n for k, n in launches.items() if k != "b1e")
    finite = all(bool(torch.isfinite(x).all()) for x in _fields(sim).values())
    if launches["b1e"] != B1E_STEPS or others != 0 or not finite:
        raise RuntimeError(f"b1e main path: {launches['b1e']} launches (others {others}), "
                           f"expected {B1E_STEPS}; finite state: {finite}")
    return launches["b1e"], sim, wall


@torch.no_grad()
def b1e_census_and_control(benv, drawer_scene, sim, targets):
    """The partners the spheres choose in one plain inner step of the
    contact case (anchor ids: the cube 1, the boxes 2 + g, the grids
    2 + G + k, the ground 0), and the control: B1b's (or B1c's) default
    build on the same state with the cube left out, against the plain
    version with the cube, must miss by more than TOL on some field."""
    from partmanip_tpu_torch.sim import engine, fused
    ref = engine.plain_physics_step(benv.scene, sim, targets, n_steps=1)
    ids = ref.anchors.body
    koff = 2 + benv.scene.obj_boxes.link_idx.shape[-1]
    census = {"ground": int((ids == 0).sum()), "cube": int((ids == 1).sum()),
              "boxes": int(((ids >= 2) & (ids < koff)).sum()), "grids": int((ids >= koff).sum())}
    out = fused.fused_inner_steps(drawer_scene, sim._replace(body=None), targets, 1)
    errs, _, _ = _field_errors(out, ref._replace(body=None))
    control = {"library": fused.scene_library(drawer_scene).name, "max_abs_err": errs,
               "misses_tol": sorted(f for f, e in errs.items() if e > TOL[f])}
    return census, control


def b1e(envs):
    """Phase ``b1e``: kernel B1e's four builds (box handles and mesh
    handles, each default and bias) compiled side by side; per handle kind
    the contact case, the main path (B1E_STEPS physics steps through
    ``engine.physics_step``, its launches counted), ``kernel_check`` on the
    contact case and on the main path's end state (one inner step within
    TOL, n in one launch equal to n launches), the partner census (the
    cube and the handle both chosen), the B1b / B1c control that must miss,
    the bias builds against the plain version with the default build as
    their control, and the timing.  Returns B1e's entry of the ``kernels``
    line (box handles; mesh handles under ``mesh_handles``)."""
    from partmanip_tpu_torch.sim import fused
    t_phase = time.time()
    cube_env = envs[0][0]
    benvs = {"boxes": body_drawer_env(envs[1][0], cube_env),
             "grids": body_drawer_env(envs[2][0], cube_env)}
    scenes = [sc for b in benvs.values()
              for sc in [b.scene] + [bias_scenes(b.scene)[n] for n in B1E_BIAS_CASES]]
    libs = list({fused.scene_library(s).path: fused.scene_library(s) for s in scenes}.values())
    t0 = time.time()
    reports = [lib.finish(p) for lib, p in zip(libs, [lib.start() for lib in libs])]
    for lib in libs:
        lib.load()
    from partmanip_tpu_torch.utils import cuda_lib
    ptxas = {os.path.basename(lib.path): cuda_lib.ptxas_lines(r) for lib, r in zip(libs, reports)}
    emit("b1e_build", seconds=time.time() - t0, libraries=sorted(ptxas), ptxas=ptxas)
    entries, failures = {}, []
    for kind, (drawer_env, _) in zip(("boxes", "grids"), envs[1:3]):
        benv = benvs[kind]
        contact = b1e_contact_case(benv, drawer_env)
        launches, driven, wall = b1e_main_path(benv, *contact)
        cases = {"contact": contact, f"driven{B1E_STEPS}": (driven, contact[1])}
        worst = phase_kernel_check(B1E_PATH, benv, cases, build=kind, rounding=False)
        census, control = b1e_census_and_control(benv, drawer_env.scene, *contact)
        scs = bias_scenes(benv.scene)
        bias = {name: phase_kernel_check(B1E_PATH, benv, bias_cases(name, cases),
                                         scene=scs[name], build=f"{kind}_{name}",
                                         rounding=False, control=benv.scene)
                for name in B1E_BIAS_CASES}
        timing = phase_timing(B1E_PATH, benv, driven, contact[1], contact)
        emit("b1e_" + kind, main_path_launches=launches, main_path_wall_seconds=wall,
             census=census, control=control, max_abs_err=worst, max_abs_err_bias=bias,
             timing=timing)
        if census["cube"] == 0 or census[kind] == 0:
            failures.append(f"{kind}: a partner kind is never chosen: {census}")
        if not control["misses_tol"]:
            failures.append(f"{kind}: the {control['library']} control is within TOL: "
                            f"{control['max_abs_err']}")
        lib = fused.scene_library(benv.scene)
        bias_lib = fused.scene_library(scs["coriolis"])
        entries[kind] = {"launches": launches, "max_abs_err": worst,
                         "ptxas": ptxas[os.path.basename(lib.path)],
                         "main_path_wall_seconds": wall, "census": census, "control": control,
                         **timing,
                         "bias_build": {"max_abs_err": bias,
                                        "ptxas": ptxas[os.path.basename(bias_lib.path)]}}
    emit("b1e", seconds=time.time() - t_phase, failures=failures)
    if failures:
        raise RuntimeError("b1e failed: " + "; ".join(failures))
    return {"name": "fused_inner_step_b1e", "route": "cuda", "source": B1E_PATH.source,
            "replaces": B1E_PATH.replaces, "replaces_function": B1E_PATH.replaces_function,
            **entries["boxes"], "mesh_handles": entries["grids"]}


# ----------------------------------------------------------------------
# env-axis data parallelism over ranks (parallel/mesh.py)
# ----------------------------------------------------------------------

MULTI_ENVS = 4096             # the two gloo ranks' envs, 2048 a rank
MULTI_FLAGS = ["--taskcfg", "open_drawer", "--algocfg", "ppo", "--task.asset.mesh_handle",
               "--task.asset.assetRoot", MESH_ASSETS, "--algo.num_envs", str(MULTI_ENVS),
               "--log.mode", "screen"]
# the PPO iteration compared across rank counts: n_steps cut to 2, the
# network in f32 (_rank_job; bf16 rounding would drown the comparison)
MULTI_PPO = MULTI_FLAGS + ["--algo.n_steps", "2", "--algo.max_iterations", "1",
                           "--exp_name", "chip_smoke_multi_seed7"]
MULTI_EVAL = MULTI_FLAGS + ["--algo.tricks.use_state_norm", "--test_only",
                            "--resume", DRAWER_CKPT, "--exp_name", "chip_smoke_multi_seed389"]
PARAM_TOL = 2e-6              # the fixed-rollout update, 2 ranks vs 1 (tests/test_torch_ppo_train.py)
METRIC_RTOL, METRIC_ATOL = 1e-3, 1e-4   # Train/*, 2 ranks vs 1 (the JAX tests/test_parallel.py)


def _fixed_rollout(T, E, O, A, seed=5):
    """A fixed rollout (numpy, time-major [T, E, ...]) near the initial
    policy's outputs, and the observations after it ([E, O], what the last
    values are computed from)."""
    rs = np.random.RandomState(seed)
    f = lambda *s: rs.normal(size=s).astype(np.float32)
    r = {"observations": f(T, E, O), "actions": np.tanh(f(T, E, A)) * 0.9,
         "rewards": f(T, E) * 0.5, "dones": rs.rand(T, E) < 0.2,
         "succs": rs.rand(T, E) < 0.1, "values": f(T, E) * 0.3,
         "log_probs": f(T, E) * 0.1 - 2.0, "mu": f(T, E, A) * 0.05,
         "sigma": np.full((T, E, A), np.log(0.5), np.float32)}
    r["succs"] &= r["dones"]
    return r, f(E, O)


@torch.no_grad()
def _rank_state(sim):
    return {k: v.cpu().numpy().copy() for k, v in _fields(sim).items()} | {
        "anchor_body": sim.anchors.body.cpu().numpy().copy()}


def _rank_job(evaluate):
    """What each rank of ``multi_rank`` runs, in its mesh: (1) one update of
    the PPO trainer (2 epochs of 4 minibatches drawn at random, so that
    each holds rows of both ranks) on a fixed rollout and fixed
    observations after it, this rank's env columns of them; (2) the first control step from the reset
    with the policy's noise, free-running; (3) one PPO iteration
    (``runner.run``) of MULTI_PPO; (4) with ``evaluate``, the committed
    expert's evaluation through ``train_torch.main``.  Returns the
    parameters after (1), the state after (2), (3)'s and (4)'s logs,
    seconds and launch counts."""
    import train_torch
    from partmanip_tpu_torch.algos import ppo as ppo_mod
    from partmanip_tpu_torch.models.actor_critic import ActorCritic
    from partmanip_tpu_torch.parallel import mesh as mesh_lib
    from partmanip_tpu_torch.utils import cuda_lib
    mesh = mesh_lib.active_mesh()
    ranks = ["--parallel.num_devices", str(mesh.size)]
    runner, cfg = train_torch.build(MULTI_PPO + ranks)
    runner.model_cfg["network"]["dtype"] = "f32"
    runner.ac = ActorCritic(runner.num_obs, runner.num_actions, runner.model_cfg).to(runner.device)
    env, E, El = runner.env, runner.num_envs, runner.env.num_envs
    cols = slice(mesh.rank * El, (mesh.rank + 1) * El)
    # (1) the fixed-rollout update
    ro, last_obs = _fixed_rollout(runner.n_steps, E, runner.num_obs, runner.num_actions)
    ts, env_state = runner.init_state(cfg["seed"])
    dev = env.device
    ts = ts._replace(curr_obs=torch.as_tensor(last_obs[cols], device=dev))
    fixed = ppo_mod.storage.Rollout(**{k: torch.as_tensor(v[:, cols], device=dev)
                                       for k, v in ro.items()})
    infos = {"reward": fixed.rewards}
    run_rollout = runner._rollout
    runner._rollout = lambda ts_, es: (ts_, es, fixed, infos)
    depth = runner.n_updates, runner.num_mini_batches, runner.sampler
    runner.n_updates, runner.num_mini_batches, runner.sampler = 2, 4, "random"
    ts, _, _ = runner._train_iteration(ts, env_state, float(runner.lr))
    runner._rollout = run_rollout
    runner.n_updates, runner.num_mini_batches, runner.sampler = depth
    params = {k: v.detach().cpu().numpy().copy() for k, v in runner.ac.state_dict().items()}
    # (2) the first control step
    ts, env_state = runner.init_state(cfg["seed"])
    with torch.no_grad():
        actions, *_ = runner.ac.random_act_cri(ts.curr_obs, generator=ts.rng, mesh=mesh)
        env_state, *_ = env.step(env_state, actions, train=True)
    state = _rank_state(env_state.sim)
    # (3) one PPO iteration
    cuda_lib.reset_launch_counts()
    runner.run(seed=cfg["seed"])
    torch.cuda.synchronize()
    out = {"params": params, "state": state, "ppo_log": runner.last_log,
           "iteration_seconds": runner.iteration_seconds,
           "ppo_launches": cuda_lib.launch_counts(),
           "ppo_expected": 1 + runner.curr_iter * runner.n_steps * env.control_freq_inv}
    # (4) the expert's evaluation
    if evaluate:
        cuda_lib.reset_launch_counts()
        t0 = time.time()
        ev = train_torch.main(MULTI_EVAL + ranks)
        torch.cuda.synchronize()
        out.update(eval_log=ev.last_log, eval_seconds=time.time() - t0,
                   eval_launches=cuda_lib.launch_counts(),
                   eval_expected=ev.eval_round * (1 + ev.env.max_episode_length
                                                  * ev.env.control_freq_inv) + 1)
    return out


def multi_rank():
    """Phase ``multi_rank``: env-axis data parallelism on the card.  One
    NCCL rank (world size 1: the same code, every collective through NCCL)
    on all MULTI_ENVS envs, then two gloo ranks sharing cuda:0 (NCCL
    refuses two ranks on one device; gloo stages each collective through
    the host), 2048 envs each, both on open_drawer with mesh handles
    (kernel B1c).  Gates: the fixed-rollout update's parameters of the two
    ranks equal each other's and within PARAM_TOL of the one rank's; the
    first free-running control step's state within TOL of the one rank's
    rows, anchor ids ≥ ANCHOR_ID_MATCH equal; the PPO iteration's Train/*
    within METRIC_RTOL; each rank's B1c launches exactly its physics
    steps, no other kernel launched; the expert's evaluation on the two
    ranks ``Test/succ_rate_max`` ≥ 0.8."""
    from partmanip_tpu_torch.parallel import mesh as mesh_lib
    t_phase = time.time()
    t0 = time.time()
    (one,) = mesh_lib.launch(_rank_job, 1, "nccl", "cuda", args=(False,))
    one_s = time.time() - t0
    t0 = time.time()
    two = mesh_lib.launch(_rank_job, 2, "gloo", "cuda:0", args=(True,))
    two_s = time.time() - t0
    failures = []
    param_err = max(float(np.abs(two[0]["params"][k] - one["params"][k]).max())
                    for k in one["params"])
    ranks_equal = all(np.array_equal(two[0]["params"][k], two[1]["params"][k])
                      for k in one["params"])
    if not (param_err <= PARAM_TOL and ranks_equal):
        failures.append(f"fixed-rollout update: 2 ranks vs 1 {param_err:.3g} > {PARAM_TOL} "
                        f"or the ranks differ ({ranks_equal})")
    state = {k: np.concatenate([r["state"][k] for r in two]) for k in one["state"]}
    state_err = {k: float(np.abs(state[k] - one["state"][k]).max())
                 for k in one["state"] if k != "anchor_body"}
    same_ids = float((state["anchor_body"] == one["state"]["anchor_body"]).mean())
    failures += [f"first control step: {k} {e:.3g} > {TOL[k]}" for k, e in state_err.items()
                 if not e <= TOL[k]]
    if same_ids < ANCHOR_ID_MATCH:
        failures.append(f"first control step: anchor ids equal in {same_ids}")
    metrics = {}
    for k, v in one["ppo_log"].items():
        if k.startswith("Train/"):
            w = two[0]["ppo_log"][k]
            metrics[k] = (w, v)
            if not (np.isfinite(w) and abs(w - v) <= METRIC_ATOL + METRIC_RTOL * abs(v)):
                failures.append(f"{k}: 2 ranks {w} vs 1 rank {v}")
    for r, out in enumerate([one] + two):
        for phase in ("ppo", "eval"):
            if f"{phase}_launches" not in out:
                continue
            got, want = out[f"{phase}_launches"], out[f"{phase}_expected"]
            others = sum(n for k, n in got.items() if k != "b1c")
            if got["b1c"] != want or others:
                failures.append(f"{phase} on {'1 rank' if r == 0 else f'rank {r - 1}'}: "
                                f"{got['b1c']} B1c launches (others {others}), expected {want}")
    succ = two[0]["eval_log"].get("Test/succ_rate_max", float("nan"))
    if not succ >= 0.8:
        failures.append(f"two-rank evaluation Test/succ_rate_max {succ} < 0.8")
    emit("multi_rank", num_envs=MULTI_ENVS, envs_per_rank=MULTI_ENVS // 2,
         seconds_one_rank_nccl=one_s, seconds_two_ranks_gloo=two_s,
         fixed_update_param_err=param_err, param_tol=PARAM_TOL, ranks_equal=ranks_equal,
         first_step_err=state_err, first_step_anchor_ids_equal=same_ids,
         train_metrics_two_vs_one=metrics,
         iteration_seconds={"one_rank_nccl": one["iteration_seconds"],
                            "two_ranks_gloo": [r["iteration_seconds"] for r in two]},
         launches={"one_rank_nccl": one["ppo_launches"]["b1c"],
                   "two_ranks_gloo_ppo": [r["ppo_launches"]["b1c"] for r in two],
                   "two_ranks_gloo_eval": [r["eval_launches"]["b1c"] for r in two]},
         eval_seconds=[r["eval_seconds"] for r in two], succ_rate_max=succ,
         eval_log=two[0]["eval_log"], seconds=time.time() - t_phase, failures=failures)
    if failures:
        raise RuntimeError("multi_rank failed: " + "; ".join(failures))


def run_vision_path(phases, ptxas):
    """Every phase of the vision path; returns its two entries of the
    ``kernels`` line and the launches of DAgger training (or None)."""
    from partmanip_tpu_torch.config import process_cfgs
    from partmanip_tpu_torch.envs import vision
    cfg, _ = process_cfgs(VISION_FLAGS)
    rig = vision.VisionRig(cfg["task"]["cam"], cfg["task"]["obs_mode"]["tsdf"], "depth_pc")
    worst, launches, timing = {}, {}, {"b2": {}, "b3": {}}
    checked = "kernel_check" in phases or "timing" in phases
    cases = vision_cases() if checked else None
    mode_case = mode_cases(cases) if checked else None
    if "kernel_check" in phases:
        worst["b2"], worst["b3"] = vision_kernel_check(rig, cases)
        mode_kernel_check(*mode_case)
    if "small_reference" in phases:
        vision_small_reference()
    if "main_path" in phases:
        launches = vision_main_path()
    if "timing" in phases:
        timing["b2"], timing["b3"] = vision_timing(rig, cases["rollout40"])
        timing["b2"]["at_vision_modes"], timing["b3"]["at_vision_modes"] = mode_timing(*mode_case)
        vision_step_breakdown()
    train = vision_dagger_train() if "dagger_train" in phases else {}
    return [{**VISION_KERNELS[k], "route": "cuda", "launches": launches.get(k),
             "launches_dagger_train": train.get(k), "max_abs_err": worst.get(k),
             "ptxas": ptxas[k], **timing[k]}
            for k in ("b2", "b3")], train


PHASES = ("kernel_check", "small_reference", "main_path", "timing", "train",
          "dagger_train", "dagger_loop", "tsdf_student", "vision_modes", "tooling", "b1e",
          "multi_rank")
ON_DEMAND = ("no_cudnn",)      # run only when --only names them


def make_envs():
    """The full-width env of each physics path.  The mesh-handle path's
    cabinets are generated and baked here, into a fresh asset root, on the
    card (phase ``bake``)."""
    envs = []
    for path in PATHS:
        t0 = time.time()
        if path.kernel == "b1c":
            shutil.rmtree(MESH_ASSETS, ignore_errors=True)
        env, cfg = make_env(path, NUM_ENVS)
        if path.kernel == "b1c":
            stack = env.scene.grid_stack
            vs = stack.voxel_size.cpu()
            emit("bake", seconds=time.time() - t0, grids=stack.sdf.shape[0],
                 grid_shape=list(stack.sdf.shape[1:]), stack_mb=stack.sdf.numel() * 4 / 1e6,
                 voxel_m=[float(vs.min()), float(vs.max())],
                 geoms_per_env=env.scene.obj_grids.link_idx.shape[-1],
                 note="env construction incl. cabinet generation and the bakes")
        envs.append((env, cfg))
    return envs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--only", nargs="+", choices=PHASES + ON_DEMAND, default=list(PHASES))
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in full f32

    phase_device()
    envs = make_envs()
    ptxas = phase_build([env.scene for env, _ in envs])
    kernels = []
    for path, (env, cfg) in zip(PATHS, envs):
        worst, launches, timing, cases = None, None, {}, None
        if "kernel_check" in args.only or "timing" in args.only:
            cases = check_cases(path, env, cfg)
        if "kernel_check" in args.only:
            worst = phase_kernel_check(path, env, cases)
        if "small_reference" in args.only:
            phase_small_reference(path)
        if "main_path" in args.only:
            launches = phase_main_path(path)
        if "timing" in args.only:
            timing = phase_timing(path, env, *cases[f"rollout{path.rollout_steps}"],
                                  cases["contact"])
            emit("timing", variant=path.kernel, **timing)
        if "train" in args.only and path.kernel == "b1c":
            phase_train(path)
        kernels.append({"name": f"fused_inner_step_{path.kernel}", "route": "cuda",
                        "source": path.source, "replaces": path.replaces,
                        "replaces_function": path.replaces_function,
                        "launches": launches, "max_abs_err": worst,
                        "ptxas": ptxas[path.kernel], **timing})
    vision_kernels, train = run_vision_path(args.only, ptxas)
    loop = dagger_loop() if "dagger_loop" in args.only else {}
    tsdf = tsdf_student() if "tsdf_student" in args.only else {}
    modes = vision_modes() if "vision_modes" in args.only else {}
    b1d, bias = tooling([(env, cfg) for env, cfg in envs]) if "tooling" in args.only else (None, {})
    b1e_kernel = b1e(envs) if "b1e" in args.only else None
    if "multi_rank" in args.only:
        multi_rank()
    if "no_cudnn" in args.only:
        no_cudnn()
    next(k for k in kernels if k["name"] == "fused_inner_step_b1b").update(
        launches_dagger_train=train.get("b1b"), launches_dagger_loop=loop.get("b1b"),
        launches_tsdf_student=tsdf.get("b1b"))
    for k, name in zip(vision_kernels, ("b2", "b3")):
        k["launches_tsdf_student"] = tsdf.get(name)
    kernels += vision_kernels
    for k in kernels:
        name = k["name"].rsplit("_", 1)[1]
        if name != "b1c":
            k["launches_vision_modes"] = modes.get(name)
        if name in bias:
            k["bias_build"] = bias[name]
    if b1d is not None:
        kernels.append(b1d)
    if b1e_kernel is not None:
        kernels.append(b1e_kernel)

    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi_line(), flush=True)
    complete = set(PHASES) <= set(args.only)
    print(json.dumps({"ok": complete, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0 if complete else 4


if __name__ == "__main__":
    sys.exit(main())
