"""DAgger runner (PyTorch) — the serving part: a state-based PPO teacher and
a vision student, evaluated.

Counterpart of ``partmanip_tpu/algos/dagger.py`` for what ``--test_only``
runs: the runner's construction (the teacher read from its checkpoint with
its obs mode, model config and, for a state-norm teacher, its frozen obs
RMS; the student built for the student obs mode with the proprio split),
``init_state`` (seeded student, env reset, the ring buffer of (student obs,
teacher obs) pairs), ``resume`` / ``load_pretrain`` (student weights from a
checkpoint of the JAX package) and the evaluation rounds,
with the same metric names (``Test/succ_rate_max``, ``Test/reward_mean``,
…).

Not ported yet (ROADMAP Queue A: BC / DAgger training): ``_collect``,
``_dagger_iteration``, ``load_offline``, ``save`` and the training loop;
``run`` without ``test_only`` raises.  The student's optimizer state belongs
to training and is not carried.
"""

from __future__ import annotations

import os
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from ..models.actor_critic import ActorCritic
from ..utils import checkpoint as ckpt_lib
from ..utils import convert
from ..utils.fetch import fetch_scalars

TRAINING_ITEM = "ROADMAP Queue A: BC / DAgger training"
TRAINING = f"DAgger training is not ported yet ({TRAINING_ITEM})"


class DaggerBuffer(NamedTuple):
    stu_obs: torch.Tensor    # [cap, O_stu]
    tea_obs: torch.Tensor    # [cap, O_tea]
    write_idx: torch.Tensor  # i32 scalar (mix_buf_ind)
    size: torch.Tensor       # i32 scalar (cur_buf_size)


class DaggerTrainState(NamedTuple):
    """What the runner carries beside the student network (``DAgger.student``
    holds the parameters)."""

    buffer: DaggerBuffer
    stu_obs: torch.Tensor
    tea_obs: torch.Tensor
    rng: torch.Generator
    pending_force: torch.Tensor   # bool [E], the reward-driven reset mask


def _read_actor_critic(path: str, network: str) -> dict:
    """A checkpoint of the JAX package (PPO or DAgger) →  ``{"ac" (state
    dict), "iteration", "total_steps", "obs_mode", "model_cfg", "tricks",
    "rms"}`` (absent keys ``None``).  The port writes no DAgger checkpoint
    until its training is ported."""
    if not ckpt_lib.is_jax_checkpoint(path):
        raise NotImplementedError(
            f"{path}: only the JAX package's checkpoints are read here; the "
            f"port's own DAgger checkpoints come with {TRAINING_ITEM}")
    j = ckpt_lib.load_jax(path)
    net = (j.get("model_cfg") or {}).get("network", {}).get("name", network)
    return {"ac": convert.actor_critic_from_jax(j["params"]._asdict(), net),
            "iteration": j.get("iteration"), "total_steps": j.get("total_steps"),
            "obs_mode": j.get("obs_mode"), "model_cfg": j.get("model_cfg"),
            "tricks": j.get("tricks") or {},
            "rms": None if j.get("rms") is None else j["rms"]._asdict()}


class DAgger:
    def __init__(self, env, cfg: dict, logger):
        self.env = env
        self.cfg = cfg
        self.logger = logger
        self.device = env.device
        self.num_envs = cfg["num_envs"]
        self.stu_obs_mode = cfg["obs_mode"]
        self.add_proprio_obs = cfg.get("add_proprio_obs", False)
        # env.num_obs already includes the proprio concat of the learn mode
        self.stu_num_obs = env.num_obs[self.stu_obs_mode]
        self.num_actions = env.num_actions
        self.max_episode_length = env.max_episode_length

        self.model_cfg = cfg["model"]
        self.max_iter = cfg["max_iterations"]
        self.n_steps = cfg["n_steps"]
        self.buf_size = cfg["buf_size"]
        self.reward_reset = cfg.get("reward_reset", False)
        self.offline_data_pth = cfg.get("offline_data_pth")
        self.eval_round = cfg["eval_round"]
        self.test_only = cfg.get("test_only") or False
        self.save_ckpt_dir = logger.save_ckpt_dir

        # teacher: a PPO checkpoint with its obs mode
        teacher_path = cfg.get("teacher")
        if not teacher_path or not os.path.exists(teacher_path):
            raise FileNotFoundError(f"teacher ckpt required, got {teacher_path}")
        tea = _read_actor_critic(teacher_path, "MLP")
        if tea["model_cfg"] is None or tea["obs_mode"] is None:
            raise ValueError(f"teacher ckpt {teacher_path} names no model "
                             f"config or obs mode")
        self.tea_obs_mode = tea["obs_mode"]
        self.tea_num_obs = env.num_obs[self.tea_obs_mode]
        self.teacher = ActorCritic(self.tea_num_obs, self.num_actions,
                                   tea["model_cfg"]).to(self.device)
        self.teacher.load_state_dict(tea["ac"])
        self.teacher_path = teacher_path
        # a state-norm teacher labels through its frozen obs RMS
        self.tea_rms = None
        if tea["tricks"].get("use_state_norm"):
            if tea["rms"] is None:
                raise ValueError(
                    f"teacher ckpt {teacher_path} was trained with "
                    "use_state_norm but carries no 'rms' state")
            self.tea_rms = convert.rms_from_jax(tea["rms"], self.device)

        # teacher reward curve for the reward-driven early reset
        tr = cfg.get("teacher_reward")
        if self.reward_reset and tr and os.path.exists(tr):
            self.tea_rew = torch.as_tensor(np.load(tr).astype(np.float32),
                                           device=self.device)
        else:
            self.reward_reset = False
            self.tea_rew = torch.zeros(env.max_episode_length + 1, device=self.device)

        proprio = env.num_obs["proprio_state"] if self.add_proprio_obs else 0
        self.student = ActorCritic(self.stu_num_obs, self.num_actions,
                                   self.model_cfg, proprio_shape=proprio).to(self.device)
        self.curr_iter = 0
        self.total_envsteps = 0

    # ------------------------------------------------------------------

    def _select(self, obs: Dict, mode: str):
        return obs[mode]

    def init_state(self, seed: int):
        """Seeded student, env state after its first reset, an empty ring
        buffer (vision student obs in bf16, as the JAX package keeps them)."""
        self.student.init(seed)
        rng = torch.Generator(device=self.device)
        rng.manual_seed(int(seed))
        env_state = self.env.init_state(self.env.make_generator(seed + 1))
        with torch.no_grad():
            env_state, obs = self.env.reset(env_state)
        cap = self.buf_size * self.num_envs
        vision_obs = self.stu_obs_mode not in ("normal_state", "proprio_state")
        bdt = self.cfg.get("buf_dtype", "bf16" if vision_obs else "f32")
        bdt = torch.bfloat16 if bdt == "bf16" else torch.float32
        dev = self.device
        buf = DaggerBuffer(
            stu_obs=torch.zeros((cap, self.stu_num_obs), dtype=bdt, device=dev),
            tea_obs=torch.zeros((cap, self.tea_num_obs), device=dev),
            write_idx=torch.zeros((), dtype=torch.int32, device=dev),
            size=torch.zeros((), dtype=torch.int32, device=dev))
        ts = DaggerTrainState(
            buffer=buf, stu_obs=self._select(obs, self.stu_obs_mode),
            tea_obs=self._select(obs, self.tea_obs_mode), rng=rng,
            pending_force=torch.zeros(self.num_envs, dtype=torch.bool, device=dev))
        return ts, env_state

    def load_offline(self, ts, folder: str):
        raise NotImplementedError(TRAINING)

    def _collect(self, ts, env_state):
        raise NotImplementedError(TRAINING)

    def _dagger_iteration(self, ts, env_state, lr):
        raise NotImplementedError(TRAINING)

    def save(self, it, ts):
        raise NotImplementedError(TRAINING)

    # ------------------------------------------------------------------

    @torch.no_grad()
    def _eval_round(self, ts: DaggerTrainState, env_state):
        """One full episode of the deterministic student over all envs.
        Returns (env_state, {key_mean, key_max} device scalars)."""
        env_state, obs = self.env.reset(env_state)
        o = self._select(obs, self.stu_obs_mode)
        T = self.max_episode_length
        sums, maxes = {}, {}
        for _ in range(T):
            actions = self.student.act(o)
            env_state, next_obs, rew, dones, extras = self.env.step(
                env_state, actions, train=False)
            infos = {k: v.float() for k, v in extras.items()}
            infos["succ_rate"] = env_state.success.float()
            infos["reward"] = rew
            for k, v in infos.items():
                v = v.reshape(-1)
                sums[k] = v if k not in sums else sums[k] + v
                maxes[k] = v if k not in maxes else torch.maximum(maxes[k], v)
            o = self._select(next_obs, self.stu_obs_mode)
        self.last_obs = o
        metrics = {}
        for k in sums:
            metrics[f"{k}_mean"] = sums[k].mean() / T
            metrics[f"{k}_max"] = maxes[k].mean()
        return env_state, metrics

    def eval(self, ts, env_state, mode="Val"):
        agg = {}
        for _ in range(self.eval_round):
            env_state, m = self._eval_round(ts, env_state)
            for k, v in fetch_scalars(m).items():
                agg.setdefault(k, []).append(v)
        return env_state, {f"{mode}/{k}": float(np.mean(v)) for k, v in agg.items()}

    # ------------------------------------------------------------------

    def resume(self, ts, path: Optional[str]):
        """Student weights, iteration and step count from a checkpoint of the
        JAX package."""
        if not path:
            return ts
        print(f"load ckpt from {path}!")
        d = _read_actor_critic(path, self.model_cfg["network"]["name"])
        self.curr_iter = int(d["iteration"] or 0)
        self.total_envsteps = int(d["total_steps"] or 0)
        self.student.load_state_dict(d["ac"])
        return ts

    def load_pretrain(self, ts, path: Optional[str]):
        """BC-pretrained init: load actor/critic, keep the fresh log_std."""
        if not path:
            return ts
        sd = dict(_read_actor_critic(path, self.model_cfg["network"]["name"])["ac"])
        sd["log_std"] = self.student.log_std.detach().cpu()
        self.student.load_state_dict(sd)
        return ts

    def run(self, seed: int = 0, resume: Optional[str] = None):
        if not self.test_only:
            raise NotImplementedError(TRAINING + "; run with --test_only")
        ts, env_state = self.init_state(seed)
        resume_path = resume or self.cfg.get("resume")
        ts = self.resume(ts, resume_path)
        if not resume_path:   # pretrain would clobber a resumed student
            ts = self.load_pretrain(ts, self.cfg.get("pretrain"))
        if self.offline_data_pth:
            ts = self.load_offline(ts, self.offline_data_pth)
        env_state, log = self.eval(ts, env_state, mode="Test")
        self.logger.info(log, self.curr_iter)
        self.last_log, self.last_env_state = log, env_state
        return ts
