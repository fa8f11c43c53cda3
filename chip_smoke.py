"""GPU smoke run of the PyTorch / CUDA port: build the kernels from the
sources in this checkout, hold each against its plain PyTorch version on the
card, drive the port's main paths through their entry point, and time the
kernels.

    python3 chip_smoke.py            # needs one NVIDIA GPU and nvcc

Two paths, each with its kernel: the grasp_cube evaluation rollout (kernel
B1a, robot + free cube) and the open_drawer evaluation of the committed
expert checkpoint (kernel B1b, robot + articulated cabinet).  Every phase
runs once per path.  Prints one JSON object per phase (``device``,
``build``, then ``kernel_check``, ``small_reference``, ``main_path`` and
``timing`` for each path), then the ``kernels`` line, the card's name and
power limit, and ``{"ok": true, "device": {...}}`` as the last line.  Any
failed phase raises, so the script exits non-zero and prints no result
line.  ``--only`` runs a subset of the phases (for bringing up a kernel);
the default is all.
"""

import argparse
import json
import os
import random
import statistics
import subprocess
import sys
import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

NUM_ENVS = 2048
# one-inner-step tolerances, kernel vs plain version (f32 re-association and
# fma contraction only; the effort-clamped drives amplify them in velocities)
TOL = {"qpos": 1e-5, "qvel": 1e-3, "body_pos": 1e-5, "body_quat": 1e-5,
       "body_linvel": 1e-3, "body_angvel": 1e-2, "obj_qpos": 1e-5, "obj_qvel": 1e-3,
       "anchor_point": 1e-4}
ANCHOR_ID_MATCH = 0.999
DRAWER_CKPT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "artifacts",
                           "open_drawer_ppo", "expert_r3c_seed389", "model_30000.ckpt")
H100_F32_FLOPS = 67e12        # non-tensor f32 peak, NVIDIA data sheet (SXM)
H100_BYTES_PER_S = 3.35e12    # HBM3 peak, NVIDIA data sheet (SXM)


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


# ----------------------------------------------------------------------
# the two paths
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
    """What differs between the two paths; every phase takes one."""
    kernel: str                 # key of fused.launch_counts
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
         chain_physics_steps=1, chain_tol=1e-6, min_success=None),
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
    from partmanip_tpu_torch.sim import fused
    nvcc = subprocess.run([fused._find_nvcc(), "--version"], capture_output=True,
                          text=True).stdout.strip().splitlines()[-1]
    emit("device", kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=nvidia_smi_line(),
         torch=torch.__version__, cuda=torch.version.cuda, nvcc=nvcc,
         python=sys.version.split()[0])


def phase_build(scenes):
    """Compile the kernel of every scene (one nvcc per source, started
    together) and load the libraries.  Returns the ptxas lines per kernel."""
    from partmanip_tpu_torch.sim import fused
    kernels = [(fused.variant(s), fused._dims(s)) for s in scenes]
    t0 = time.time()
    procs = [fused.start_build(*k) for k in kernels]
    reports = [fused.finish_build(p, *k) for p, k in zip(procs, kernels)]
    for k in kernels:
        fused.load_library(*k)
    seconds = time.time() - t0
    ptxas = [[ln.strip() for ln in r.splitlines()
              if "registers" in ln or "spill" in ln or "stack frame" in ln]
             for r in reports]
    emit("build", seconds=seconds,
         sources=[fused.KERNEL_SOURCES[v].split("/partmanip_tpu_torch/")[-1]
                  for v, _ in kernels],
         flags=fused.NVCC_FLAGS,
         dims=[dict(zip(("L", "D", "S", "Lo", "Do", "G"), d)) for _, d in kernels],
         ptxas=ptxas)
    return {v: lines for (v, _), lines in zip(kernels, ptxas)}


def _field_errors(a, b):
    """Max abs difference per state field between two SceneStates (robot,
    free body or object, anchor points), the share of equal anchor partner
    ids, and whether ``a`` is finite."""
    pairs = {"qpos": (a.robot.qpos, b.robot.qpos), "qvel": (a.robot.qvel, b.robot.qvel)}
    if a.body is not None:
        pairs.update(body_pos=(a.body.pos, b.body.pos), body_quat=(a.body.quat, b.body.quat),
                     body_linvel=(a.body.linvel, b.body.linvel),
                     body_angvel=(a.body.angvel, b.body.angvel))
    if a.obj is not None:
        pairs.update(obj_qpos=(a.obj.qpos, b.obj.qpos), obj_qvel=(a.obj.qvel, b.obj.qvel))
    pairs["anchor_point"] = (a.anchors.point, b.anchors.point)
    errs = {k: float((x - y).abs().max()) for k, (x, y) in pairs.items()}
    same = float((a.anchors.body == b.anchors.body).float().mean())
    finite = all(bool(torch.isfinite(x).all()) for x, _ in pairs.values())
    return errs, same, finite


@torch.no_grad()
def phase_kernel_check(path, env, cases):
    """The kernel against ``engine._inner_step`` for one inner step on each
    case, plus k inner steps in one launch against k launches of one step
    (k = the inner steps of ``path.chain_physics_steps`` physics steps)."""
    from partmanip_tpu_torch.sim import engine, fused
    from partmanip_tpu_torch.utils import contact_states
    p = env.scene.params
    k = path.chain_physics_steps * p.substeps * p.inner_substeps
    report, worst, failures = {}, 0.0, []
    for name, (sim, targets) in cases.items():
        touching = contact_states.touching_counts(env, sim)
        ref = engine.plain_physics_step(env.scene, sim, targets, n_steps=1)
        out = fused.fused_inner_steps(env.scene, sim, targets, 1)
        torch.cuda.synchronize()
        errs, same, finite = _field_errors(out, ref)
        one = fused.fused_inner_steps(env.scene, sim, targets, k)
        chain = sim
        for _ in range(k):
            chain = fused.fused_inner_steps(env.scene, chain, targets, 1)
        torch.cuda.synchronize()
        errs_k, same_k, finite_k = _field_errors(one, chain)
        report[name] = {"touching": touching, "max_abs_err": errs,
                        "anchor_ids_equal": same,
                        "anchors": int((ref.anchors.body >= 0).sum()),
                        f"max_abs_err_{k}in1_vs_{k}x1": max(errs_k.values()),
                        "anchor_ids_equal_chain": same_k}
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
    emit("kernel_check", variant=path.kernel, num_envs=env.num_envs,
         tolerances={f: TOL[f] for f in errs}, cases=report, failures=failures)
    if failures:
        raise RuntimeError(f"kernel_check ({path.kernel}) failed: " + "; ".join(failures))
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
    from partmanip_tpu_torch.sim import fused
    fused.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    runner = train_torch.main(path.flags + path.main_flags
                              + ["--test_only", "--log.mode", "screen"])
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(fused.launch_counts)
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

    L, D = scene.robot.num_links, scene.robot.num_dofs
    S = env.spheres.link_idx.shape[0]
    n_anc = scene.robot.ancestor[0].cpu().numpy().sum(1)       # [L]
    sph_anc = n_anc[env.spheres.link_idx.cpu().numpy()]
    robot = (fk_mass(L, D, float(tri(n_anc).sum())) + tree(D)
             + S * (ROT + 3) + float(sph_anc.sum()) * (JCOL + 6))
    spheres = (touching["ground"] + touching.get("cube", 0) + touching.get("boxes", 0)) / E
    if scene.obj_tree is None:
        # the free cube: its narrowphase per sphere, two partners per touching
        # sphere, the body integration
        partners, rest = 2, S * (2 * ROT + 40) + 8 * (ROT + 3) + 200
    else:
        Lo, Do = scene.obj_tree.num_links, scene.obj_tree.num_dofs
        o_anc = scene.obj_tree.ancestor.cpu().numpy().sum(-1)  # [E, Lo]
        g_act = float(scene.obj_boxes.geom_mask.sum(-1).float().mean())
        boxes = scene.obj_boxes.link_idx.shape[-1] * (ROT + QMUL + 3)
        per_pair = ((2 * ROT + SDF + 3) + Do * (JCOL + 12) + Do * 12 + 12 + 70 + 27
                    + Do * 24 + 9 + (Do * (Do + 1) // 2) * 3)
        partners = 1
        rest = (fk_mass(Lo, Do, float(tri(o_anc).sum(-1).mean())) + tree(Do) + boxes
                + g_act * S * (ROT + 3 + SDF) + touching["box_pairs"] / E * per_pair)
    per_touch = (partners * 70 + 120 + 45 + D * (JCOL + 15)
                 + float(tri(sph_anc).mean()) * 6 + float(sph_anc.mean()) * 6)
    return robot + spheres * per_touch + rest


@torch.no_grad()
def phase_timing(path, env, sim, targets, contact_case, repeats=20):
    """Kernel, wrapper and plain-version times at the main path's shapes
    (E = 2048, one physics step = substeps x inner_substeps inner steps per
    launch), by CUDA events, on the path's rollout states; the kernel also
    on the hand-made contact states, where the contact branches run."""
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
    # state in and out; B1b also reads its object table and ids once
    packed = fused._packed(env.scene)
    nbytes = 2 * (buf.numel() * 4 + anc_b.numel() * 4)
    if "table" in packed:
        nbytes += packed["table"].nbytes + packed["obj_id"].nbytes
    ops_ms, bytes_ms = flops / H100_F32_FLOPS * 1e3, nbytes / H100_BYTES_PER_S * 1e3
    return {"ms": kernel_ms, "kernel_ms": kernel_ms, "one_inner_step_ms": kernel1_ms,
            "control_step_ms": env.control_freq_inv * kernel_ms,
            "contact_case_ms": contact_ms, "wrapper_ms": wrapper_ms,
            "plain_ms": plain_ms,
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "bound_operations_ms": ops_ms, "bound_bytes_ms": bytes_ms,
            "flops_per_launch": flops, "bytes_per_launch": nbytes,
            "touching": touching, "num_envs": E, "n_steps": n, "library_ms": None}


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


PHASES = ("kernel_check", "small_reference", "main_path", "timing")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--only", nargs="+", choices=PHASES, default=list(PHASES))
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in full f32

    phase_device()
    envs = [make_env(path, NUM_ENVS) for path in PATHS]
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
        kernels.append({"name": f"fused_inner_step_{path.kernel}", "route": "cuda",
                        "source": path.source, "replaces": path.replaces,
                        "replaces_function": path.replaces_function,
                        "launches": launches, "max_abs_err": worst,
                        "ptxas": ptxas[path.kernel], **timing})

    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi_line(), flush=True)
    complete = set(args.only) == set(PHASES)
    print(json.dumps({"ok": complete, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0 if complete else 4


if __name__ == "__main__":
    sys.exit(main())
