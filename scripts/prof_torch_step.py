"""Where one control step of the PyTorch / CUDA port goes on the GPU.

Times the parts of the evaluation step of a task at the default width
(2048 envs, MLP 512-512-512) with a host clock around synchronised work, and
counts the device kernels one ``env.step`` launches with ``torch.profiler``.
grasp_cube runs a randomly initialised policy; open_drawer runs the committed
expert checkpoint and is timed 40 steps into its episode (gripper at the
handle).  Prints one JSON line; the first line names the card.

    python3 scripts/prof_torch_step.py [--taskcfg open_drawer] [--envs 2048] [--steps 20]
    python3 scripts/prof_torch_step.py --sweep 256 2048 16384 65536

``--sweep`` instead times the fused physics kernel alone (CUDA events, all
inner steps of a control step in one launch) at each env count, from the
state after reset.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from partmanip_tpu_torch.algos import rms as rms_lib  # noqa: E402
from partmanip_tpu_torch.config import process_cfgs  # noqa: E402
from partmanip_tpu_torch.envs import base, control  # noqa: E402
from partmanip_tpu_torch.envs.grasp_cube import GraspCubeEnv  # noqa: E402
from partmanip_tpu_torch.models.actor_critic import ActorCritic  # noqa: E402
from partmanip_tpu_torch.sim import engine  # noqa: E402


def timed(fn, reps):
    """Median host milliseconds of ``fn`` with the device drained around it."""
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


@torch.no_grad()
def kernel_sweep(env_counts, reps):
    """Kernel milliseconds per launch and env-steps/s of the kernel alone."""
    from partmanip_tpu_torch.sim import fused
    out = {}
    for E in env_counts:
        cfg, sp = process_cfgs(["--algo.num_envs", str(E)])
        env = GraspCubeEnv(cfg["task"], sp)
        state, _ = env.reset(env.init_state(env.make_generator(1)))
        targets = env._default_dof_t.repeat(E, 1)
        buf, anc_b = fused.pack_state(state.sim, targets)
        n = sp.substeps * sp.inner_substeps
        for _ in range(3):
            fused.launch_packed(env.scene, buf, anc_b, n)
        times = []
        for _ in range(reps):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            fused.launch_packed(env.scene, buf, anc_b, n)
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
        ms = statistics.median(times)
        out[str(E)] = {"kernel_ms": ms, "kernel_env_steps_per_s": E / ms * 1e3}
    print(json.dumps({"kernel_sweep": out}), flush=True)


@torch.no_grad()
def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--envs", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--sweep", type=int, nargs="+", default=None)
    ap.add_argument("--taskcfg", default="grasp_cube",
                    choices=["grasp_cube", "open_drawer"])
    args = ap.parse_args()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip(), flush=True)

    if args.sweep:
        return kernel_sweep(args.sweep, args.steps)

    drawer = args.taskcfg == "open_drawer"
    if drawer:
        import chip_smoke
        path = next(p for p in chip_smoke.PATHS if p.kernel == "b1b")
        env, cfg = chip_smoke.make_env(path, args.envs)
        ac = chip_smoke.expert_policy(env, cfg)
        warmup = 40
    else:
        cfg, sp = process_cfgs(["--algo.num_envs", str(args.envs)])
        env = GraspCubeEnv(cfg["task"], sp)
        ac = ActorCritic(37, env.num_actions, cfg["algo"]["model"]).to(env.device)
        ac.init(0)
        warmup = 5
    num_obs = env.num_obs["normal_state"]
    rms = rms_lib.init_rms(num_obs, env.device)
    state = env.init_state(env.make_generator(1))
    state, obs = env.reset(state)
    o = obs["normal_state"]
    for _ in range(warmup):                  # warm-up: builds the kernel too
        state, obs, *_ = env.step(state, ac.act_cri(o)[0], train=False)
        o = obs["normal_state"]

    actions = ac.act_cri(o)[0]
    view, _ = env._robot_view(state.sim)
    targets = control.compute_targets(env.ctrl, env.scene.robot, view, actions)
    if drawer:
        part_bbox = env._part_bbox(state.sim)
        reward = lambda: env._reward(state, view, part_bbox, actions)
    else:
        reward = lambda: env._reward(state, view, actions)
    parts = {
        "policy_act_cri_ms": lambda: ac.act_cri(o),
        "rms_normalize_ms": lambda: rms_lib.normalize(rms, o, False),
        "robot_view_ms": lambda: env._robot_view(state.sim),
        "compute_targets_ms": lambda: control.compute_targets(
            env.ctrl, env.scene.robot, view, actions),
        "physics_step_ms": lambda: engine.physics_step(env.scene, state.sim, targets),
        "run_physics_ms": lambda: base.run_physics(env.scene, state.sim, targets,
                                                   env.control_freq_inv),
        "observations_ms": lambda: env._observations(state),
        "reward_ms": reward,
        "env_step_total_ms": lambda: env.step(state, actions, train=False),
    }
    result = {"taskcfg": args.taskcfg, "num_envs": args.envs,
              "physics_steps_per_control_step": env.control_freq_inv,
              **{k: timed(fn, args.steps) for k, fn in parts.items()}}

    from torch.profiler import ProfilerActivity, profile
    n = 5
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            env.step(state, actions, train=False)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if getattr(e, "device_time_total", 0) > 0 and e.device_type.name == "CUDA"]
    result["profiler_device_kernels_per_step"] = sum(e.count for e in events) / n
    result["profiler_device_ms_per_step"] = sum(
        e.device_time_total for e in events) / n / 1e3
    result["profiler_top_kernels_ms_per_step"] = {
        e.key[:60]: e.device_time_total / n / 1e3
        for e in sorted(events, key=lambda e: -e.device_time_total)[:6]}
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
