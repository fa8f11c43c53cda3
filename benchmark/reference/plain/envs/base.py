"""Functional task/env layer (PyTorch).

Counterpart of ``partmanip_tpu/envs/base.py``: the step contract as functions
over an explicit :class:`EnvState`:

pre-physics (at step T, using reward/progress from T-1):
    1. actions → PD targets via the robot controller;
    2. TRAIN reset rule: reward-stagnation — reset when
       ``progress ≥ epis_max_step + explore_step`` or on success;
       TEST rule: fixed horizon;
    3. per-env partial reset by ``torch.where`` masking: reset envs get
       default state + default targets, others get action targets.

physics: ``control_freq_inv`` × the fused scene step.

post-physics: progress += 1, observations, reward.

The returned obs when ``reset_buf`` is set is the *post-reset* obs.

Randomness comes from an explicit ``torch.Generator`` carried in the state
(it is advanced in place by the draws of a reset).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Tuple

import torch

from ..sim import engine
from ..sim.engine import SceneSpec, SceneState


STATE_OBS_MODES = ("normal_state", "proprio_state")


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: the GPU unless the caller names
    another one; raises when the GPU is asked for and there is none."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the GPU unless device='cpu' "
            "(--device cpu) is passed")
    return device


class EnvState(NamedTuple):
    """Carried env-layer state, [E]-leading tensors."""

    sim: SceneState
    progress: torch.Tensor        # i32 [E]
    rew_buf: torch.Tensor         # f32 [E]  reward from T-1
    success: torch.Tensor         # bool [E]
    reset_buf: torch.Tensor       # bool [E] set during the last step
    reset_succ: torch.Tensor      # bool [E] success snapshot at reset decision
    epis_max_rew: torch.Tensor    # f32 [E]
    epis_max_step: torch.Tensor   # i32 [E]
    rng: torch.Generator          # generator on the state's device
    task_state: Any = None        # task-specific carried state


def tree_map(fn, *trees):
    """Apply ``fn`` leaf-wise over ``NamedTuple``s of tensors (``None``
    leaves stay ``None``)."""
    first = trees[0]
    if first is None:
        return None
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*[tree_map(fn, *leaves) for leaves in zip(*trees)])
    return fn(*trees)


def mask_where(mask, new, old):
    """Per-env select over arbitrarily-shaped [E, ...] leaves."""
    def sel(n, o):
        m = mask.reshape(mask.shape + (1,) * (n.ndim - 1))
        return torch.where(m, n, o)
    return tree_map(sel, new, old)


def pre_physics(
    state: EnvState,
    targets: torch.Tensor,
    default_targets: torch.Tensor,
    reset_sim_fn: Callable[[SceneState, torch.Tensor, torch.Generator], SceneState],
    explore_step: int,
    max_episode_length: int,
    train: bool,
    force_reset=None,
) -> Tuple[EnvState, torch.Tensor, Dict[str, torch.Tensor]]:
    """Reset decision + partial reset + target overlay.

    Returns (new state, final PD targets, pre-physics extras).
    """
    extras = {}
    if train:
        # reward-stagnation early reset
        epis_max_step = torch.where(state.rew_buf < state.epis_max_rew,
                                    state.epis_max_step, state.progress)
        epis_max_rew = torch.maximum(state.rew_buf, state.epis_max_rew)
        reset_buf = (state.progress >= epis_max_step + explore_step) | state.success
        if force_reset is not None:
            # external reset requests
            reset_buf = reset_buf | force_reset
        reset_succ = state.success
        extras["succ_rate"] = (
            state.success.float().sum(dim=0, keepdim=True)
            / torch.clamp(reset_buf.float().sum(dim=0, keepdim=True), min=1.0)
        )
    else:
        epis_max_step = state.epis_max_step
        epis_max_rew = state.epis_max_rew
        reset_buf = state.progress >= max_episode_length
        reset_succ = state.reset_succ

    sim = reset_sim_fn(state.sim, reset_buf, state.rng)
    final_targets = mask_where(reset_buf, default_targets, targets)

    new = state._replace(
        sim=sim,
        reset_buf=reset_buf,
        reset_succ=reset_succ,
        progress=torch.where(reset_buf, 0, state.progress),
        success=torch.where(reset_buf, False, state.success),
        epis_max_rew=torch.where(reset_buf, -100.0, epis_max_rew),
        epis_max_step=torch.where(reset_buf, 0, epis_max_step),
    )
    return new, final_targets, extras


def run_physics(scene: SceneSpec, sim: SceneState, targets,
                control_freq_inv: int) -> SceneState:
    """control_freq_inv physics steps with held targets."""
    for _ in range(control_freq_inv):
        sim = engine.physics_step(scene, sim, targets)
    return sim


# the robot's mesh-bearing links of the scene-pose dumps
SCENE_POSE_LINKS = tuple(f"panda_link{i}" for i in range(8)) + (
    "panda_hand", "panda_leftfinger", "panda_rightfinger")


