"""PPO runner (PyTorch) — evaluation path.

Counterpart of ``partmanip_tpu/algos/ppo.py`` for what ``--test_only`` runs:
state init, checkpoint resume and the evaluation rounds, with the same
metric names (``Test/succ_rate_max``, ``Test/reward_mean``, …).  The train
iteration (rollout storage, GAE, the actor/critic losses with the KL gate,
Adam, ``save``) is not ported yet: ``run`` without ``test_only`` raises.

Observation RMS normalization is applied frozen during evaluation, as in the
JAX package.
"""

from __future__ import annotations

import os
from os.path import join as pjoin
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from ..models.actor_critic import ActorCritic
from . import rms as rms_lib
from ..utils import checkpoint as ckpt_lib
from ..utils import convert
from ..utils.fetch import fetch_scalars


def _from_jax(j: dict) -> dict:
    """A JAX PPO checkpoint (``checkpoint.load_jax``) in the port's format."""
    return {"iteration": int(j["iteration"]),
            "ac": convert.actor_critic_from_jax(j["params"]._asdict()),
            "rms": j["rms"]._asdict(), "update_rms": bool(j["update_rms"]),
            "total_steps": int(j["total_steps"]), "tricks": j["tricks"],
            "obs_mode": j["obs_mode"]}


class PPOTrainState(NamedTuple):
    """What the runner carries beside the network (``PPO.ac`` holds the
    parameters)."""

    rms: rms_lib.RMSState
    update_rms: torch.Tensor      # bool scalar (freeze flag)
    curr_obs: torch.Tensor        # [E, O] normalized obs carried across iters
    rng: torch.Generator          # policy-noise generator


class PPO:
    TRICKS_KEYS = ["mini_adv_norm", "whole_adv_norm", "use_state_norm",
                   "use_clipped_value_loss", "use_grad_clip"]

    def __init__(self, env, cfg: dict, logger, device=None):
        self.env = env
        self.cfg = cfg
        self.logger = logger
        self.device = env.device if device is None else torch.device(device)
        if self.device != env.device:
            raise ValueError(f"PPO on {self.device} but env on {env.device}")
        self.num_envs = cfg["num_envs"]
        self.obs_mode = cfg["obs_mode"]
        self.num_obs = env.num_obs[self.obs_mode]
        if cfg.get("add_proprio_obs"):
            self.num_obs += env.num_obs["proprio_state"]
        self.num_actions = env.num_actions
        self.max_episode_length = env.max_episode_length
        self.model_cfg = cfg["model"]

        self.eval_round = cfg["eval_round"]
        self.test_only = cfg.get("test_only") or False
        self.save_pose = cfg.get("save_pose") or False
        self.save_video = cfg.get("save_video") or False
        self.save_ckpt_dir = logger.save_ckpt_dir
        if self.save_pose or self.save_video:
            raise NotImplementedError(
                "save_pose / save_video are not ported yet (ROADMAP Queue A: "
                "renderer, tooling)")

        self.tricks = {k: cfg["tricks"][k] for k in self.TRICKS_KEYS}

        self.ac = ActorCritic(self.num_obs, self.num_actions,
                              self.model_cfg).to(self.device)

        self.curr_iter = 0
        self.total_envsteps = 0

        par = cfg.get("parallel") or {}
        self.num_devices = int(par.get("num_devices") or 1)
        if self.num_devices > 1:
            raise NotImplementedError(
                "parallel.num_devices > 1 is not ported yet (ROADMAP Queue A: "
                "multi-GPU)")

    # ------------------------------------------------------------------
    # state init / io
    # ------------------------------------------------------------------

    def init_state(self, seed: int):
        """Seeded network weights, env state after its first reset (one
        settling physics step) and a fresh RMS."""
        self.ac.init(seed)
        rng = torch.Generator(device=self.device)
        rng.manual_seed(int(seed))
        env_state = self.env.init_state(self.env.make_generator(seed + 1))
        with torch.no_grad():
            env_state, obs = self.env.reset(env_state)
        rms_state = rms_lib.init_rms(self.num_obs, self.device)
        curr_obs = self._select_obs(obs)
        update = torch.tensor(bool(self.tricks["use_state_norm"]),
                              device=self.device)
        if self.tricks["use_state_norm"]:
            curr_obs, rms_state = rms_lib.normalize(rms_state, curr_obs, update)
        ts = PPOTrainState(rms=rms_state, update_rms=update,
                           curr_obs=curr_obs, rng=rng)
        return ts, env_state

    def _select_obs(self, obs: Dict[str, torch.Tensor]):
        o = obs[self.obs_mode]
        if self.cfg.get("add_proprio_obs") and self.obs_mode != "proprio_state":
            o = torch.cat([o, obs["proprio_state"]], dim=-1)
        return o

    def resume(self, ts: PPOTrainState, path: Optional[str]):
        """Load a checkpoint of the port (``{"iteration", "ac" (state dict),
        "rms" {"n", "mean", "S"}, "update_rms", "total_steps", "tricks",
        "obs_mode"}``) or one written by the JAX package (detected by its
        format, converted through ``utils.convert``)."""
        if not path:
            return ts
        print(f"load ckpt from {path}!")
        if ckpt_lib.is_jax_checkpoint(path):
            d = _from_jax(ckpt_lib.load_jax(path))
        else:
            d = ckpt_lib.load(path)
        for k in self.TRICKS_KEYS:
            if self.tricks[k] != d["tricks"][k]:
                print(f"WARNING: trick {k} inconsistent with ckpt! "
                      f"saved: {d['tricks'][k]}, now: {self.tricks[k]}")
                if k == "use_state_norm":
                    raise SystemExit("state-norm mismatch is not allowed")
        if self.obs_mode != d["obs_mode"]:
            raise ValueError(f"checkpoint was made for obs_mode "
                             f"{d['obs_mode']!r}, not {self.obs_mode!r}")
        self.curr_iter = d["iteration"]
        self.total_envsteps = d["total_steps"]
        self.ac.load_state_dict(d["ac"])
        r = d["rms"]
        dev = self.device
        return ts._replace(
            rms=rms_lib.RMSState(
                n=torch.as_tensor(r["n"], dtype=torch.int32, device=dev),
                mean=torch.as_tensor(r["mean"], dtype=torch.float32, device=dev),
                S=torch.as_tensor(r["S"], dtype=torch.float32, device=dev)),
            update_rms=torch.as_tensor(bool(d["update_rms"]), device=dev),
        )

    # ------------------------------------------------------------------
    # eval
    # ------------------------------------------------------------------

    @torch.no_grad()
    def _eval_round(self, ts: PPOTrainState, env_state):
        """One full episode of the deterministic policy over all envs.
        Returns (env_state, {key_mean, key_max} device scalars, per-step
        mean-reward curve [T])."""
        env_state, obs = self.env.reset(env_state)
        o = self._select_obs(obs)
        if self.tricks["use_state_norm"]:
            o, _ = rms_lib.normalize(ts.rms, o, False)

        T = self.max_episode_length
        sums, maxes = {}, {}
        rew_curve = []
        for _ in range(T):
            actions, _ = self.ac.act_cri(o)
            env_state, next_obs, rew, dones, extras = self.env.step(
                env_state, actions, train=False)
            o = self._select_obs(next_obs)
            if self.tricks["use_state_norm"]:
                o, _ = rms_lib.normalize(ts.rms, o, False)
            infos = {k: v.float() for k, v in extras.items()}
            infos["succ_rate"] = env_state.success.float()
            infos["reward"] = rew
            for k, v in infos.items():
                v = v.reshape(-1)
                # running sum / running per-env max over the episode
                sums[k] = v if k not in sums else sums[k] + v
                maxes[k] = v if k not in maxes else torch.maximum(maxes[k], v)
            rew_curve.append(rew.mean())
        metrics = {}
        for k in sums:
            metrics[f"{k}_mean"] = sums[k].mean() / T
            metrics[f"{k}_max"] = maxes[k].mean()
        return env_state, metrics, torch.stack(rew_curve)

    def eval(self, ts: PPOTrainState, env_state, mode="Val"):
        agg = {}
        curves = []
        for _ in range(self.eval_round):
            env_state, m, rew_curve = self._eval_round(ts, env_state)
            curves.append(rew_curve.cpu().numpy())
            for k, v in fetch_scalars(m).items():
                agg.setdefault(k, []).append(v)
        if self.cfg.get("save_teacher_reward"):
            os.makedirs(self.save_ckpt_dir, exist_ok=True)
            np.save(pjoin(self.save_ckpt_dir, "teacher_reward.npy"),
                    np.mean(curves, axis=0))
        log = {f"{mode}/{k}": float(np.mean(v)) for k, v in agg.items()}
        # freeze RMS once eval max-success > 50 %
        if log.get(f"{mode}/succ_rate_max", 0.0) > 0.5:
            ts = ts._replace(update_rms=torch.tensor(False, device=self.device))
        return ts, env_state, log

    # ------------------------------------------------------------------
    # outer loop
    # ------------------------------------------------------------------

    def run(self, seed: int = 0, resume: Optional[str] = None):
        if not self.test_only:
            raise NotImplementedError(
                "PPO training is not ported yet (ROADMAP Queue A: PPO train "
                "iteration); run with --test_only")
        ts, env_state = self.init_state(seed)
        ts = self.resume(ts, resume or self.cfg.get("resume"))
        ts, env_state, log = self.eval(ts, env_state, mode="Test")
        self.logger.info(log, self.curr_iter)
        self.last_log, self.last_env_state = log, env_state
        return ts
