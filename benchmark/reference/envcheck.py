"""The reference's env and the comparisons of the program's env steps and
vision observations with it.

Two references judge an env step.  The state observation and the reward
are held against ``reference/task.py``, written for the benchmark from the
task's definitions and computed in float64 from the program's post-step
state.  The physics, the resets and the depth images are held against a
witness: the frozen plain copy of the port's env, simulator and renderer
(``reference/plain``), built from the configuration's own flags with its
own generated cabinets, run plain on the card.  The witness follows the
program step by step from its captured state for single steps, and from
its own state over a captured run of steps (``rollout``), so that drift
builds up and is judged.  Farthest-point sampling is judged by its
definition (``reference/fps.py``)."""

from __future__ import annotations

import random
from typing import Dict, List

import torch

from harness.capture import rebuild
from . import fps, task
from .plain.config import process_cfgs
from .plain.envs import base as base_lib
from .plain.envs import vision as vision_lib
from .plain.envs.open_drawer import OpenDrawerEnv
from .plain.ops import tsdf as tsdf_lib
from .plain.sim import contact as contact_lib
from .plain.sim import engine as engine_lib
from .plain.sim import types as types_lib
from .plain.utils import contact_states

TYPES = {"EnvState": base_lib.EnvState, "SceneState": engine_lib.SceneState,
         "TreeState": types_lib.TreeState, "FreeBodyState": types_lib.FreeBodyState,
         "AnchorState": contact_lib.AnchorState}


def build_env(flags: List[str], py_seed: int, device, asset_root: str):
    """(env in a state observation mode, merged config, vision rig of the
    configured mode or ``None``), the cabinets shuffled by python's
    ``random`` seeded as the program's entry point seeds it."""
    flags, im_scale = list(flags), 1
    if "--im_scale" in flags:            # the entry point's option, no config key
        i = flags.index("--im_scale")
        im_scale = int(flags[i + 1])
        del flags[i:i + 2]
    cfg, sim_params = process_cfgs(flags + ["--task.asset.assetRoot", asset_root])
    mode = cfg["task"]["learn_input_mode"]
    cfg["task"]["learn_input_mode"] = "normal_state"
    cfg["task"]["im_scale"] = im_scale
    random.seed(py_seed)
    env = OpenDrawerEnv(cfg["task"], sim_params, device=device)
    rig = None
    if mode not in base_lib.STATE_OBS_MODES:
        rig = vision_lib.VisionRig(cfg["task"]["cam"], cfg["task"]["obs_mode"]["tsdf"], mode,
                                   im_scale=im_scale, device=env.device)
    return env, cfg, rig


def _per_env_max(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    d = (a.float() - b.float()).abs()
    return d.reshape(d.shape[0], -1).amax(dim=1) if d.dim() > 1 else d


def _stats(name: str, per_env: torch.Tensor) -> Dict[str, float]:
    """The widest per-env gap, its 99th percentile and its median over envs
    (quantiles interpolated: with an even count the median is the mean of
    the two middle gaps, so a fault in exactly half the envs shows)."""
    per_env = per_env.double()
    return {f"{name}": float(per_env.max()),
            f"{name}.p99": float(torch.quantile(per_env, 0.99)),
            f"{name}.median": float(torch.quantile(per_env, 0.5))}


@torch.no_grad()
def step(env, cap_in: dict, prec: str = "f32") -> dict:
    """The reference's env step from the program's captured input, as a
    snapshot-shaped output (``state``, ``obs``, ``rew``, ``dones``).
    ``prec`` ``tf32`` runs its matrix products in TF32 (the control)."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = prec == "tf32"
    try:
        state = rebuild(cap_in["state"], TYPES)
        st, obs, rew, dones, _ = env.step(state, cap_in["actions"].clone(),
                                          train=cap_in["train"],
                                          force_reset=cap_in["force_reset"])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    return {"state": st, "obs": obs, "rew": rew, "dones": dones}


def step_gaps(ref: dict, out: dict, data: dict) -> Dict[str, float]:
    """An env step's output (the program's snapshot, or a control's) against
    the witness's :func:`step`: the widest per-env gap (and its 99th
    percentile and median over envs) of the robot's and the cabinet's qpos
    and qvel and the count of resets decided differently; and its state
    observation and reward against ``task.observe`` of its own post-step
    state."""
    return {**_state_gaps("step", ref["state"], out["state"]),
            "step.resets_differ": float((ref["dones"] != out["dones"]).sum()),
            **task.gaps("task", task.observe(data, _sim_fields(out["state"])),
                        out["obs"]["normal_state"], out["rew"])}


def _state_gaps(prefix: str, ref_state, out_state) -> Dict[str, float]:
    rebuilt = lambda s: s if isinstance(s, tuple) else rebuild(s, TYPES)
    sim, psim = rebuilt(ref_state).sim, rebuilt(out_state).sim
    qpos = torch.maximum(_per_env_max(sim.robot.qpos, psim.robot.qpos),
                         _per_env_max(sim.obj.qpos, psim.obj.qpos))
    qvel = torch.maximum(_per_env_max(sim.robot.qvel, psim.robot.qvel),
                         _per_env_max(sim.obj.qvel, psim.obj.qvel))
    return {**_stats(f"{prefix}.qpos", qpos), **_stats(f"{prefix}.qvel", qvel)}


def _sim_fields(state) -> dict:
    """The scene state's fields as plain data for ``task.observe``."""
    from harness.capture import snapshot
    snap = state if isinstance(state, dict) else snapshot(state)
    return snap["fields"]["sim"]["fields"]


@torch.no_grad()
def rollout(env, captured: dict, prec: str = "f32") -> dict:
    """The witness's env over a captured run of steps, from the run's first
    input state and with the program's actions and reset requests, each
    step from the witness's own state: the last step's output as
    :func:`step` gives it."""
    from harness.capture import snapshot
    state = captured["start"]
    for inp in captured["inputs"]:
        out = step(env, {"state": state, **inp}, prec)
        state = snapshot(out["state"])
    return out


def lower_precision(data: dict, out: dict) -> dict:
    """A control's step or rollout output with its state observation and
    reward taken by ``task.observe`` in bfloat16, one precision below the
    configuration's float32."""
    obs, rew = task.observe(data, _sim_fields(out["state"]), torch.bfloat16)
    return {**out, "obs": {**out["obs"], "normal_state": obs}, "rew": rew}


def rollout_gaps(data: dict, ref: dict, end: dict) -> Dict[str, float]:
    """The program's state, observation and reward after a run of steps
    (``end``, or a control's :func:`rollout`) against the witness's
    :func:`rollout` and ``task.observe`` of the witness's last state."""
    return {**_state_gaps("rollout", ref["state"], end["state"]),
            **task.gaps("rollout", task.observe(data, _sim_fields(ref["state"])),
                        end["obs"]["normal_state"], end["rew"])}


@torch.no_grad()
def vision_gaps(env, rig, sim_snapshot, out: dict, mode: str, control: bool = False
                ) -> Dict[str, float]:
    """The witness's depth images and point cloud from the program's
    post-physics state, against the program's (``out``: its captured
    ``depth``, ``fps_idx`` and ``obs``): the widest depth gap, the widest
    shortfall of an FPS pick from a farthest point (``fps.shortfall`` on
    the witness's points), the widest gap of a sampled point from the
    witness's point at the same index.  With ``control`` the witness's
    depth and points rounded to bfloat16 (one precision below their f32)
    and sampled by ``fps.sample`` take the program's place."""
    sim = rebuild(sim_snapshot, TYPES)
    depth = vision_lib.render_depth(rig, vision_lib.scene_prims(env, sim))
    pts = tsdf_lib.workspace_points(rig.tsdf_spec, depth)
    k = out["fps_idx"].shape[-1]
    E = depth.shape[0]
    if control:
        depth_c = depth.to(torch.bfloat16).float()
        pts_c = tsdf_lib.workspace_points(rig.tsdf_spec, depth_c).to(torch.bfloat16).float()
        idx_c = fps.sample(pts_c, k)
        sampled_c = torch.gather(pts_c, 1, idx_c[..., None].expand(E, k, 3))
    else:
        depth_c, idx_c = out["depth"], out["fps_idx"].long()
        sampled_c = out["obs"][mode][:, :k * 3].reshape(E, k, 3)
    want = torch.gather(pts, 1, idx_c[..., None].expand(E, k, 3))
    return {"vision.depth": float(_per_env_max(depth, depth_c).max()),
            "vision.fps_shortfall": fps.shortfall(pts, idx_c),
            "vision.points": float(_per_env_max(want.reshape(E, -1),
                                                sampled_c.reshape(E, -1)).max())}


def env_gaps(env, rig, mode: str, cap, control: bool = False) -> Dict[str, float]:
    """Every env number of a cell's check from its ``rounds.StepCapture``:
    each captured step's :func:`step_gaps` and :func:`vision_gaps` and the
    captured run's :func:`rollout_gaps`, the widest over the steps.  With
    ``control`` the witness one precision lower takes the program's place
    (its products in TF32, the observation and reward by ``task.observe``
    in bfloat16, the depth and points rounded to bfloat16)."""
    data = task.task_data(env)
    numbers = {}

    def keep(gaps):
        for k, v in gaps.items():
            numbers[k] = max(numbers.get(k, 0.0), v)

    for cap_in, cap_out in cap.steps:
        ref = step(env, cap_in)
        keep(step_gaps(ref, lower_precision(data, step(env, cap_in, "tf32")) if control
                       else cap_out, data))
        if rig is not None:
            keep(vision_gaps(env, rig, cap_out["state"]["fields"]["sim"], cap_out, mode,
                             control))
    if cap.rollout.get("end") is not None:
        ref = rollout(env, cap.rollout)
        end = (lower_precision(data, rollout(env, cap.rollout, "tf32")) if control
               else cap.rollout["end"])
        keep(rollout_gaps(data, ref, end))
    return numbers


@torch.no_grad()
def b2_operations(env, rig, sim_snapshot, far: float = 100.0, eps: float = 1e-3) -> float:
    """f32 operations of one coarse-to-fine culled render of the rig from a
    captured state, counted from ``csrc/raymarch.cu`` with the scene
    evaluations and the primitives they keep that this input needs (the
    plain march counts them; a multiply-add counts 2): per evaluation the
    point (6), every kept sphere (11), every kept box (53), the ground (1)
    and the march update (6); per ray its inverse length (6) and the hit
    select (3).  A frozen copy of ``chip_smoke.b2_operations``."""
    from .plain.ops import raymarch, raymarch_cuda
    prims = vision_lib.scene_prims(env, rebuild(sim_snapshot, TYPES))
    dev = prims.sphere_radius.device
    E, V, H, W = prims.sphere_radius.shape[0], rig.num_view, rig.im_h, rig.im_w

    def ops(rays, t0, steps):
        _, ev = raymarch.march_plain(prims, rays, t0, steps, far, eps, cull=True,
                                     count_evals=True)
        ev = ev.double()
        return (float((13 * ev[..., 0] + 11 * ev[..., 1] + 53 * ev[..., 2]).sum())
                + 9.0 * ev[..., 0].numel())

    coarse = raymarch_cuda.ray_table(rig.poses, raymarch_cuda.coarse_intrinsic(rig.intrinsic),
                                     H // 4, W // 4, dev)
    full = raymarch_cuda.ray_table(rig.poses, rig.intrinsic, H, W, dev)
    d_c = raymarch.march_plain(prims, coarse, 0.05, 40, far, eps, cull=True)
    t0 = raymarch_cuda.coarse_start(d_c.reshape(E, V, H // 4, W // 4), far).reshape(E, V, -1)
    return ops(coarse, 0.05, 40) + ops(full, t0.contiguous(), raymarch_cuda.REFINE_STEPS)


def touching(env, sim_snapshot) -> dict:
    """``contact_states.touching_counts`` of a captured scene state."""
    return contact_states.touching_counts(env, rebuild(sim_snapshot, TYPES))
