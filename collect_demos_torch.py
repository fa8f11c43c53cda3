"""Collect vision-labelled expert demonstrations for BC / DAgger (PyTorch).

Counterpart of ``tools/collect_demos.py``: roll a trained state-based PPO
teacher (a checkpoint of the JAX package or of the port) while the env also
computes the student observation (``mesh_tsdf`` by default), and write
``<out>/scene_XXXXX/step_XXXXX.npy`` dicts with keys ``tsdf`` (res³, the
observation rounded through bf16 as the JAX tool stores it), ``action``
(the teacher's activated action), ``proprio_state`` and ``tea_obs``: the
tree ``algos/bc.load_demo_tree`` and ``DAgger.load_offline`` read.

Usage:
    python collect_demos_torch.py --taskcfg open_drawer --algo.num_envs 16 \\
        --teacher artifacts/open_drawer_ppo/expert_r3c_seed389/model_30000.ckpt \\
        --out ./logs/tsdf_demos --episodes 4 --only_success

Every other flag is a config flag (``partmanip_tpu_torch/config.py``).  Runs
on the GPU; ``--device cpu`` runs the plain PyTorch path on the CPU.  Each
episode is rolled eagerly, its rows stacked on the device and copied to the
host once.
"""

import argparse
import os
import random
import time
from os.path import join as pjoin

import numpy as np
import torch

from partmanip_tpu_torch.algos import rms as rms_lib
from partmanip_tpu_torch.config import process_cfgs
from train_torch import make_env


def load_teacher(path, env, device):
    """The teacher's actor-critic and, for a state-norm teacher, its frozen
    obs RMS, from a PPO checkpoint of either package."""
    from partmanip_tpu_torch.algos.dagger import _read_actor_critic
    from partmanip_tpu_torch.models.actor_critic import ActorCritic
    from partmanip_tpu_torch.utils import convert
    tea = _read_actor_critic(path, "MLP")
    mode = tea["obs_mode"]
    teacher = ActorCritic(env.num_obs[mode], env.num_actions, tea["model_cfg"]).to(device)
    teacher.load_state_dict(tea["ac"])
    rms = None
    if tea["tricks"].get("use_state_norm") and tea["rms"] is not None:
        rms = convert.rms_from_jax(tea["rms"], device)
    return teacher, rms, mode


@torch.no_grad()
def rollout(env, state, act, tea_mode, obs_mode):
    """One episode from a reset: per step the student obs (bf16), proprio,
    teacher obs and action seen before the step, and success after it,
    each stacked to [T, E, ...] on the device."""
    state, obs = env.reset(state)
    rows = {"vis": [], "prop": [], "tea": [], "act": [], "succ": []}
    no_prop = torch.zeros((env.num_envs, 0), device=env.device)
    for _ in range(env.max_episode_length):
        a = act(obs[tea_mode])
        rows["vis"].append(obs[obs_mode].to(torch.bfloat16))
        rows["prop"].append(obs.get("proprio_state", no_prop))
        rows["tea"].append(obs[tea_mode])
        rows["act"].append(a)
        state, obs, *_ = env.step(state, a, train=False)
        rows["succ"].append(state.success)
    return state, {k: torch.stack(v) for k, v in rows.items()}


def write_episode(out, rows, res, scene_id, only_success):
    """Write the episode's envs as scenes from ``scene_id`` on; returns the
    next scene id."""
    vis = rows["vis"].float().numpy()                  # [T, E, O_vis]
    prop, tea, act = rows["prop"].numpy(), rows["tea"].numpy(), rows["act"].numpy()
    success = rows["succ"].numpy().any(axis=0)
    T, E = vis.shape[:2]
    n_prop = prop.shape[-1]
    for e in range(E):
        if only_success and not success[e]:
            continue
        d = pjoin(out, f"scene_{scene_id:05d}")
        os.makedirs(d, exist_ok=True)
        for t in range(T):
            tsdf = vis[t, e][:vis.shape[-1] - n_prop] if n_prop else vis[t, e]
            np.save(pjoin(d, f"step_{t:05d}.npy"), {
                "tsdf": tsdf.reshape(res, res, res),
                "proprio_state": prop[t, e],
                "action": act[t, e],
                "tea_obs": tea[t, e],
            })
        scene_id += 1
    return scene_id


def main(argv=None):
    """Collect and write the demos; returns ``{"scenes", "rows", "episodes",
    "seconds", "out"}``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--teacher", required=True)
    ap.add_argument("--out", default="./logs/tsdf_demos")
    ap.add_argument("--episodes", type=int, default=1)
    ap.add_argument("--obs_mode", default="mesh_tsdf")
    ap.add_argument("--only_success", action="store_true",
                    help="keep only the envs that succeeded in their episode")
    ap.add_argument("--device", default="cuda")
    args, others = ap.parse_known_args(argv)
    # f32 convolutions, as the JAX package's (cuDNN's default is TF32)
    torch.backends.cudnn.allow_tf32 = False

    cfg, sp = process_cfgs(others + ["--algo.obs_mode", args.obs_mode,
                                     "--algo.add_proprio_obs"])
    cfg["task"]["learn_input_mode"] = args.obs_mode
    cfg["task"]["add_proprio_obs"] = True
    random.seed(0)                 # open_drawer's cabinet shuffle
    env = make_env(cfg, sp, args.device)
    teacher, rms, tea_mode = load_teacher(args.teacher, env, env.device)

    def act(o):
        if rms is not None:
            o, _ = rms_lib.normalize(rms, o, False)
        return teacher.act(o)

    t0 = time.time()
    state = env.init_state(env.make_generator(0))
    res = int(cfg["task"]["obs_mode"]["tsdf"]["resolution"])
    scene_id = 0
    for _ in range(args.episodes):
        state, rows = rollout(env, state, act, tea_mode, args.obs_mode)
        rows = {k: v.cpu() for k, v in rows.items()}     # once per episode
        scene_id = write_episode(args.out, rows, res, scene_id, args.only_success)
    print(f"wrote {scene_id} episodes to {args.out}")
    return {"scenes": scene_id, "rows": scene_id * env.max_episode_length,
            "episodes": args.episodes, "seconds": time.time() - t0, "out": args.out}


if __name__ == "__main__":
    main()
