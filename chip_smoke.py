"""GPU smoke run of the PyTorch / CUDA port: build the kernels from the
sources in this checkout, hold each against its plain PyTorch version on the
card, drive the port's main path through its entry point, and time the
kernels.

    python3 chip_smoke.py            # needs one NVIDIA GPU and nvcc

Prints one JSON object per phase (``device``, ``build``, ``kernel_check``,
``small_reference``, ``main_path``, ``kernels``), then the card's name and
power limit, then ``{"ok": true, "device": {...}}`` as the last line.  Any failed phase raises,
so the script exits non-zero and prints no result line.  ``--only`` runs a
subset of the phases (for bringing up a new kernel); the default is all.
"""

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

NUM_ENVS = 2048
# one-inner-step tolerances, kernel vs plain version (f32 re-association and
# fma contraction only; the effort-clamped drives amplify them in velocities)
TOL = {"qpos": 1e-5, "qvel": 1e-3, "body_pos": 1e-5, "body_quat": 1e-5,
       "body_linvel": 1e-3, "body_angvel": 1e-2, "anchor_point": 1e-4}
ANCHOR_ID_MATCH = 0.999
H100_F32_FLOPS = 67e12        # non-tensor f32 peak, NVIDIA data sheet (SXM)
H100_BYTES_PER_S = 3.35e12    # HBM3 peak, NVIDIA data sheet (SXM)


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


def make_env(num_envs, device="cuda"):
    """(env, merged config) of the default grasp_cube / ppo YAMLs."""
    from partmanip_tpu_torch.config import process_cfgs
    from partmanip_tpu_torch.envs.grasp_cube import GraspCubeEnv
    cfg, sim_params = process_cfgs(["--taskcfg", "grasp_cube", "--algocfg", "ppo",
                                    "--algo.num_envs", str(num_envs)])
    return GraspCubeEnv(cfg["task"], sim_params, device=device), cfg


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


def phase_build(env):
    """Compile every kernel source of the port (one nvcc each, started
    together) and load the libraries."""
    from partmanip_tpu_torch.sim import fused
    dims = fused._dims(env.scene)
    t0 = time.time()
    procs = [(fused.start_build(*dims), dims)]
    reports = [fused.finish_build(p, *d) for p, d in procs]
    fused.load_library(*dims)
    seconds = time.time() - t0
    ptxas = [ln.strip() for ln in reports[0].splitlines()
             if "registers" in ln or "spill" in ln or "stack frame" in ln]
    emit("build", seconds=seconds, sources=[fused.KERNEL_SOURCE.split("/partmanip_tpu_torch/")[-1]],
         flags=fused.NVCC_FLAGS, dims=dict(zip("LDS", dims)), ptxas=ptxas)
    return ptxas


def _field_errors(a, b):
    """Max abs difference per state field between two SceneStates, and the
    share of equal anchor partner ids."""
    pairs = {
        "qpos": (a.robot.qpos, b.robot.qpos), "qvel": (a.robot.qvel, b.robot.qvel),
        "body_pos": (a.body.pos, b.body.pos), "body_quat": (a.body.quat, b.body.quat),
        "body_linvel": (a.body.linvel, b.body.linvel),
        "body_angvel": (a.body.angvel, b.body.angvel),
        "anchor_point": (a.anchors.point, b.anchors.point)}
    errs = {k: float((x - y).abs().max()) for k, (x, y) in pairs.items()}
    same = float((a.anchors.body == b.anchors.body).float().mean())
    finite = all(bool(torch.isfinite(x).all()) for x, _ in pairs.values())
    return errs, same, finite


def _rollout_states(env, steps, seed):
    """SceneState and PD targets after ``steps`` control steps of a seeded
    random policy (through the kernel, as the main path runs)."""
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


def _contact_states(env, seed):
    """The hand-made in-contact states, two plain inner steps in (so that
    anchors exist and the stick branch is live)."""
    from partmanip_tpu_torch.sim import engine
    from partmanip_tpu_torch.utils import contact_states, convert
    st, tg = contact_states.grasp_contact_states(env, env.num_envs, seed)
    sim = convert.scene_state_from_numpy(st, env.device)
    targets = torch.as_tensor(tg, device=env.device)
    sim = engine.plain_physics_step(env.scene, sim, targets, n_steps=2)
    return sim, targets


@torch.no_grad()
def phase_kernel_check(env):
    from partmanip_tpu_torch.sim import engine, fused
    from partmanip_tpu_torch.utils import contact_states
    p = env.scene.params
    n = p.substeps * p.inner_substeps
    cases = {"rollout20": _rollout_states(env, 20, seed=5),
             "contact": _contact_states(env, seed=6)}
    report, worst, failures = {}, 0.0, []
    for name, (sim, targets) in cases.items():
        touching = contact_states.touching_counts(env, sim)
        ref = engine.plain_physics_step(env.scene, sim, targets, n_steps=1)
        out = fused.fused_inner_steps(env.scene, sim, targets, 1)
        torch.cuda.synchronize()
        errs, same, finite = _field_errors(out, ref)
        # all inner steps in one launch against n launches of one step
        one = fused.fused_inner_steps(env.scene, sim, targets, n)
        chain = sim
        for _ in range(n):
            chain = fused.fused_inner_steps(env.scene, chain, targets, 1)
        torch.cuda.synchronize()
        errs_n, same_n, finite_n = _field_errors(one, chain)
        report[name] = {"touching": touching, "max_abs_err": errs,
                        "anchor_ids_equal": same,
                        f"max_abs_err_{n}in1_vs_{n}x1": max(errs_n.values()),
                        "anchor_ids_equal_chain": same_n}
        worst = max(worst, *errs.values())
        if not (finite and finite_n):
            failures.append(f"{name}: non-finite output")
        failures += [f"{name}: {k} err {v:.3g} > {TOL[k]}"
                     for k, v in errs.items() if not v <= TOL[k]]
        if same <= ANCHOR_ID_MATCH:
            failures.append(f"{name}: anchor ids equal in only {same:.5f}")
        if not max(errs_n.values()) <= 1e-6 or same_n < 1.0:
            failures.append(f"{name}: {n}-in-one launch differs from {n} launches "
                            f"by {max(errs_n.values()):.3g}")
    c = report["contact"]["touching"]
    if min(c["cube"], c["ground"], c["anchors_on_cube"], c["anchors_on_ground"]) == 0:
        failures.append(f"contact case has a dead branch: {c}")
    emit("kernel_check", num_envs=env.num_envs, tolerances=TOL, cases=report,
         failures=failures)
    if failures:
        raise RuntimeError("kernel_check failed: " + "; ".join(failures))
    return worst, cases


@torch.no_grad()
def phase_small_reference(num_envs=45, steps=3):
    """The env on the card (kernel) against the same env on the CPU (plain
    version) on a small input: same cube poses, same seeded policy, reset
    and a few eval steps; obs within 1e-3 (8 inner steps of effort-clamped
    drives per control step), bookkeeping exact.  45 envs also put the
    ragged edge of the last thread block to work."""
    from partmanip_tpu_torch.models.actor_critic import ActorCritic
    rs = np.random.RandomState(3)
    draws = (rs.uniform(-0.15, 0.15, (num_envs, 2)).astype(np.float32),
             rs.uniform(-np.pi, np.pi, num_envs).astype(np.float32))
    traces = {}
    for device in ("cuda", "cpu"):
        env, cfg = make_env(num_envs, device)
        cfg["algo"]["model"]["network"]["dtype"] = "f32"
        ac = ActorCritic(37, env.num_actions, cfg["algo"]["model"])
        ac.init(11)
        with torch.no_grad():
            ac.actor.head.weight.mul_(60.0)   # actions that move the arm
        ac = ac.to(env.device)
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
    ok = (tuple(got.shape) == (steps + 1, num_envs, 37) and err <= 1e-3
          and bool(torch.isfinite(got).all()) and torch.equal(gp, wp)
          and moved > 1e-3)
    emit("small_reference", num_envs=num_envs, steps=steps, max_abs_obs_err=err,
         tolerance=1e-3, obs_moved=moved, ok=ok)
    if not ok:
        raise RuntimeError(f"GPU env disagrees with the CPU reference: {err}")


def phase_main_path():
    """The evaluation rollout at the YAML defaults through the CLI entry
    point: 2048 envs, MLP 512-512-512, 200 steps, one eval round."""
    import train_torch
    from partmanip_tpu_torch.sim import fused
    fused.reset_launch_count()
    torch.cuda.synchronize()
    t0 = time.time()
    runner = train_torch.main(["--taskcfg", "grasp_cube", "--algocfg", "ppo",
                               "--test_only", "--exp_name", "chip_smoke_seed7",
                               "--log.mode", "screen"])
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = fused.launch_count
    env, cfg = runner.env, runner.cfg
    T, rounds = env.max_episode_length, cfg["eval_round"]
    expected = rounds * (1 + T * env.control_freq_inv) + 1
    log = runner.last_log
    sim = runner.last_env_state.sim
    finite_state = all(bool(torch.isfinite(x).all())
                       for part in (sim.robot, sim.body) for x in part)
    hid = cfg["model"]["network"]["hid_dim"]
    emit("main_path", num_envs=env.num_envs, hid_dim=hid, steps=T, eval_round=rounds,
         kernel_launches=launches, expected_launches=expected, wall_seconds=wall,
         env_steps_per_second=rounds * T * env.num_envs / wall, metrics=log)
    if (env.num_envs, list(hid), T) != (NUM_ENVS, [512, 512, 512], 200):
        raise RuntimeError("main path did not run at the full width of the config")
    if launches != expected:
        raise RuntimeError(f"kernel launched {launches} times, expected {expected}: "
                           f"not every physics step went through the kernel")
    bad = [k for k, v in log.items() if not np.isfinite(v)]
    if bad or not finite_state or not any(k.startswith("Test/") for k in log):
        raise RuntimeError(f"main path output not finite: {bad}, state ok={finite_state}")
    return launches


def inner_step_flops(env, touching_per_env):
    """f32 operations of ONE inner step of one env, counted from
    csrc/fused_inner_step.cu (a multiply-add counts 2).  ``touching_per_env``
    is the mean number of spheres in contact per env in this run's data: the
    force / anchor / J^T N J part runs only for those."""
    L, D = env.scene.robot.num_links, env.scene.robot.num_dofs
    S = env.spheres.link_idx.shape[0]
    anc = env.scene.robot.ancestor[0].cpu().numpy()          # [L, D]
    n_anc = anc.sum(1)
    sph_anc = n_anc[env.spheres.link_idx.cpu().numpy()]
    ROT, QMUL, JCOL = 30, 28, 26      # quat_rotate, quat_mul, one Jacobian column
    fk = L * (2 * ROT + 2 * QMUL + 40) + D * ROT
    mass = (L * (ROT + 3 + 30 + 90) + L * D * (JCOL + 3 + 15)
            + float((n_anc * (n_anc + 1) / 2).sum()) * 22)
    pass_a = S * (ROT + 3 + 2 * ROT + 40) + float(sph_anc.sum()) * (JCOL + 6)
    per_touch = 2 * 70 + 120 + 45 + D * (JCOL + 15)
    pass_b = touching_per_env * (per_touch + float(
        (sph_anc * (sph_anc + 1) / 2).mean()) * 6 + float(sph_anc.mean()) * 6)
    chol = 2 * (D ** 3 / 3 + 2 * D ** 2) * 2
    tree = chol + D * 60 + 2 * D * D
    body = 8 * (ROT + 3) + 200
    return fk + mass + pass_a + pass_b + tree + body


@torch.no_grad()
def phase_timing(env, sim, targets, contact_case, repeats=20):
    """Kernel, wrapper and plain-version times at the main path's shapes
    (E = 2048, all inner steps of a control step), by CUDA events, on the
    states the main path meets (a random policy's rollout); the kernel also
    on the hand-made contact states, where the contact branches run."""
    from partmanip_tpu_torch.sim import engine, fused
    from partmanip_tpu_torch.utils import contact_states
    p = env.scene.params
    n = p.substeps * p.inner_substeps

    def timed(fn, reps):
        times = []
        for _ in range(reps):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)

    buf, anc_b = fused.pack_state(sim, targets)
    for _ in range(3):
        fused.launch_packed(env.scene, buf, anc_b, n)
    kernel_ms = timed(lambda: fused.launch_packed(env.scene, buf, anc_b, n), repeats)
    kernel1_ms = timed(lambda: fused.launch_packed(env.scene, buf, anc_b, 1), repeats)
    wrapper_ms = timed(lambda: fused.fused_physics_step(env.scene, sim, targets), repeats)
    cbuf, canc = fused.pack_state(*contact_case)
    contact_ms = timed(lambda: fused.launch_packed(env.scene, cbuf, canc, n), repeats)
    engine.plain_physics_step(env.scene, sim, targets)
    plain_ms = timed(lambda: engine.plain_physics_step(env.scene, sim, targets), 3)

    E = env.num_envs
    touching = contact_states.touching_counts(env, sim)
    per_env = (touching["ground"] + touching["cube"]) / E
    flops = inner_step_flops(env, per_env) * n * E
    nbytes = 2 * (buf.numel() * 4 + anc_b.numel() * 4)
    ops_ms, bytes_ms = flops / H100_F32_FLOPS * 1e3, nbytes / H100_BYTES_PER_S * 1e3
    return {"ms": kernel_ms, "kernel_ms": kernel_ms, "one_inner_step_ms": kernel1_ms,
            "contact_case_ms": contact_ms, "wrapper_ms": wrapper_ms,
            "plain_ms": plain_ms,
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "bound_operations_ms": ops_ms, "bound_bytes_ms": bytes_ms,
            "flops_per_launch": flops, "bytes_per_launch": nbytes,
            "touching_spheres_per_env": per_env, "num_envs": E, "n_steps": n,
            "library_ms": None}


PHASES = ("kernel_check", "small_reference", "main_path", "timing")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--only", nargs="+", choices=PHASES, default=list(PHASES))
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in full f32

    phase_device()
    env, _ = make_env(NUM_ENVS)
    ptxas = phase_build(env)
    worst, launches, timing = None, None, {}
    cases = None
    if "kernel_check" in args.only:
        worst, cases = phase_kernel_check(env)
    if "small_reference" in args.only:
        phase_small_reference()
    if "main_path" in args.only:
        launches = phase_main_path()
    if "timing" in args.only:
        if cases is None:
            cases = {"rollout20": _rollout_states(env, 20, seed=5),
                     "contact": _contact_states(env, seed=6)}
        timing = phase_timing(env, *cases["rollout20"], cases["contact"])
    kernel = {"name": "fused_inner_step_b1a", "route": "cuda",
              "source": "partmanip_tpu_torch/csrc/fused_inner_step.cu",
              "replaces": "partmanip_tpu/sim/fused.py:744",
              "replaces_function": "partmanip_tpu/sim/fused.py:_inner_step_tiled",
              "launches": launches, "max_abs_err": worst, "ptxas": ptxas, **timing}
    print(json.dumps({"kernels": [kernel]}), flush=True)
    print(nvidia_smi_line(), flush=True)
    complete = set(args.only) == set(PHASES)
    print(json.dumps({"ok": complete, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0 if complete else 4


if __name__ == "__main__":
    sys.exit(main())
