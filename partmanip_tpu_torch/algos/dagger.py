"""DAgger distillation (PyTorch): a state-based PPO teacher labels what a
vision (or state) student sees while the student acts.

Counterpart of ``partmanip_tpu/algos/dagger.py``:

* the teacher is read from its checkpoint (the JAX package's or the port's)
  with its obs mode, model config and, for a state-norm teacher, its frozen
  obs RMS, through which it labels;
* ``_collect``: ``n_steps`` of the student's exploration policy (std
  ``action_std``); the (student obs, teacher obs) pairs seen *before* each
  step are written to a ring buffer of ``buf_size × num_envs`` rows after the
  loop (vision student obs in bf16, state obs in f32);
* **reward-driven early reset**: an env whose reward falls below the
  teacher's reward curve 10 steps earlier is reset at its next step; the
  mask rides in the train state (``pending_force``) across iterations;
* ``_dagger_iteration``: ``n_updates`` epochs of ``n_minibatches`` Adam
  steps (``optax.adam`` arithmetic, :class:`algos.ppo.Adam`) on the MSE
  between the teacher's and the student's activated actions, each step's
  gradient accumulated over ``ceil(mb / minibatch_cap)`` chunks; while the
  buffer holds fewer than 16 rows the student keeps its parameters (the
  optimizer state still advances, as in the JAX package);
* ``load_offline`` (an .npy demo tree), ``save`` / ``resume`` (student and
  Adam state, from the port's checkpoints or the JAX package's),
  ``load_pretrain``, the evaluation rounds and the outer loop, with the
  same metric names (``Train/dagger_loss``, ``Val/succ_rate_max``, …).

The exploration noise and the minibatch shuffles come from the train
state's ``torch.Generator``; the JAX package's PRNG keys do not carry over,
so the parity tests inject the noise and indices JAX draws.
"""

from __future__ import annotations

import os
import time
from os.path import join as pjoin
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from ..models.actor_critic import ActorCritic
from . import rms as rms_lib
from . import storage
from .ppo import Adam
from ..utils import checkpoint as ckpt_lib
from ..utils import convert
from ..utils.fetch import fetch_scalars

REWARD_RESET_DELAY = 10   # steps the teacher's reward curve is read behind
MIN_UPDATE_ROWS = 16      # the student stays as it is below this buffer size


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
    opt: Adam                     # over every student parameter, as optax's


def _read_actor_critic(path: str, network: str) -> dict:
    """A checkpoint of the port or of the JAX package (PPO or DAgger) →
    ``{"ac" (state dict), "opt" (a DAgger checkpoint's Adam state, the port's
    format), "iteration", "total_steps", "obs_mode", "model_cfg", "tricks",
    "rms"}`` (absent keys ``None``)."""
    if not ckpt_lib.is_jax_checkpoint(path):
        d = ckpt_lib.load(path)
        out = {k: d.get(k) for k in ("ac", "opt", "iteration", "total_steps",
                                     "obs_mode", "model_cfg", "rms")}
        return dict(out, tricks=d.get("tricks") or {})
    j = ckpt_lib.load_jax(path)
    net = (j.get("model_cfg") or {}).get("network", {}).get("name", network)
    opt = j.get("opt")
    return {"ac": convert.actor_critic_from_jax(j["params"]._asdict(), net),
            "opt": None if opt is None else convert.adam_state_from_jax(opt, "student", net),
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
        self.n_updates = cfg["n_updates"]
        self.num_mini_batches = cfg["n_minibatches"]
        self.buf_size = cfg["buf_size"]
        self.reward_reset = cfg.get("reward_reset", False)
        self.offline_data_pth = cfg.get("offline_data_pth")
        self.eval_round = cfg["eval_round"]
        self.eval_freq = cfg["eval_frequence"]
        self.save_freq = cfg["save_frequence"]
        self.test_only = cfg.get("test_only") or False
        self.save_ckpt_dir = logger.save_ckpt_dir
        self.lr_schedule = cfg["lr_schedule"]
        if self.lr_schedule not in ("fixed", "linear_decay"):
            raise ValueError(f"lr_schedule {self.lr_schedule!r}")
        self.lr = cfg["lr"]

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
        self.train_logs = []     # every train iteration's log, in order

    # ------------------------------------------------------------------

    def _select(self, obs: Dict, mode: str):
        return obs[mode]

    def init_state(self, seed: int):
        """Seeded student and generator, env state after its first reset, an
        empty ring buffer (vision student obs in bf16, as the JAX package
        keeps them) and a fresh Adam over the student."""
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
            pending_force=torch.zeros(self.num_envs, dtype=torch.bool, device=dev),
            opt=Adam(list(self.student.named_parameters())))
        return ts, env_state

    def load_offline(self, ts: DaggerTrainState, folder: str):
        """Append an .npy demo tree (``<folder>/<scene>/<step>.npy``, each a
        dict with ``tsdf``, ``tea_obs`` and, with ``add_proprio_obs``,
        ``proprio_state``), in sorted order, to the ring buffer: what the JAX
        package's row-by-row writes leave, in one write."""
        stu, tea = storage.read_demo_tree(folder, self.add_proprio_obs, "tea_obs")
        if not stu:
            return ts
        buf = ts.buffer
        n, cap = len(stu), buf.stu_obs.shape[0]
        keep = min(n, cap)            # the rows a wrap has not overwritten
        pos = torch.arange(n - keep, n, device=self.device)
        idx = torch.remainder(buf.write_idx + pos, cap).long()
        buf.stu_obs[idx] = torch.as_tensor(np.stack(stu[n - keep:])).to(buf.stu_obs)
        buf.tea_obs[idx] = torch.as_tensor(np.stack(tea[n - keep:])).to(buf.tea_obs)
        return ts._replace(buffer=buf._replace(
            write_idx=torch.remainder(buf.write_idx + n, cap).to(torch.int32),
            size=torch.clamp(buf.size + n, max=cap).to(torch.int32)))

    # ------------------------------------------------------------------

    @torch.no_grad()
    def _collect(self, ts: DaggerTrainState, env_state, noise=None):
        """Roll ``n_steps`` of the student's exploration policy and write the
        (student obs, teacher obs) pairs seen before each step to the ring
        buffer at ``write_idx`` onwards (mod its capacity), after the loop.
        ``noise`` [n_steps, E, A] replaces the generator's draws.  Returns
        (ts, env_state, infos: per key [n_steps, ...])."""
        buf = ts.buffer
        cap = buf.stu_obs.shape[0]
        stu_rows, tea_rows, infos = [], [], {}
        for t in range(self.n_steps):
            actions = self.student.random_act(
                ts.stu_obs, generator=ts.rng, noise=None if noise is None else noise[t])
            env_state, next_obs, rew, dones, extras = self.env.step(
                env_state, actions, train=True,
                force_reset=ts.pending_force if self.reward_reset else None)
            stu_rows.append(ts.stu_obs.to(buf.stu_obs.dtype))
            tea_rows.append(ts.tea_obs)
            force = torch.zeros_like(ts.pending_force)
            if self.reward_reset:
                prog = env_state.progress
                behind = torch.clamp(prog - REWARD_RESET_DELAY, 0, self.tea_rew.shape[0] - 1)
                force = (prog > REWARD_RESET_DELAY) & (rew < self.tea_rew[behind.long()])
            step = {k: v.float() for k, v in extras.items()}
            step["reward"] = rew
            step["dagger_reward_reset"] = force.float()
            for k, v in step.items():
                infos.setdefault(k, []).append(v)
            ts = ts._replace(pending_force=force,
                             stu_obs=self._select(next_obs, self.stu_obs_mode),
                             tea_obs=self._select(next_obs, self.tea_obs_mode))
        n_new = self.n_steps * self.num_envs
        idx = torch.remainder(
            buf.write_idx + torch.arange(n_new, device=self.device), cap).long()
        buf.stu_obs[idx] = torch.cat(stu_rows)
        buf.tea_obs[idx] = torch.cat(tea_rows)
        buf = buf._replace(
            write_idx=torch.remainder(buf.write_idx + n_new, cap).to(torch.int32),
            size=torch.clamp(buf.size + n_new, max=cap).to(torch.int32))
        return (ts._replace(buffer=buf), env_state,
                {k: torch.stack(v) for k, v in infos.items()})

    def minibatch_sizes(self, cap: int):
        """(mb, chunk, n_chunks): the Adam step's batch (``minibatch_size``,
        at most a 1/n_minibatches share of the buffer) rounded up to whole
        chunks of at most ``minibatch_cap`` rows, over which its gradient is
        accumulated."""
        mb = max(min(cap // self.num_mini_batches,
                     int(self.cfg.get("minibatch_size", 2048))), 1)
        chunk = min(int(self.cfg.get("minibatch_cap", 2048)), mb)
        n_chunks = -(-mb // chunk)
        return n_chunks * chunk, chunk, n_chunks

    @torch.no_grad()
    def _label(self, tea_obs):
        """The teacher's activated mean on raw teacher obs (normalised by its
        frozen RMS first, where it has one)."""
        if self.tea_rms is not None:
            tea_obs, _ = rms_lib.normalize(self.tea_rms, tea_obs, False)
        return self.teacher.act(tea_obs)

    def _loss(self, stu_obs, tea_act):
        return ((tea_act - self.student.update_act(stu_obs)) ** 2).mean()

    def _dagger_iteration(self, ts: DaggerTrainState, env_state, lr):
        """Collect, then ``n_updates × n_minibatches`` Adam steps on the
        buffer.  Returns (ts, env_state, metrics as device scalars)."""
        ts, env_state, infos = self._collect(ts, env_state)
        buf = ts.buffer
        cap = buf.stu_obs.shape[0]
        mb, chunk, n_chunks = self.minibatch_sizes(cap)
        idx_all = storage.buffer_minibatch_indices(
            ts.rng, cap, buf.size, self.n_updates, self.num_mini_batches, mb)
        params = list(self.student.parameters())
        before = [p.detach().clone() for p in params]
        losses = []
        for idx in idx_all:
            self.student.zero_grad(set_to_none=True)
            lsum = 0.0
            for cidx in idx.reshape(n_chunks, chunk):
                loss = self._loss(buf.stu_obs[cidx].float(), self._label(buf.tea_obs[cidx]))
                loss.backward()
                lsum = lsum + loss.detach()
            for p in params:
                if p.grad is not None:
                    p.grad.div_(n_chunks)
            ts.opt.step(lr)
            losses.append(lsum / n_chunks)
        self.student.zero_grad(set_to_none=True)
        # a tiny buffer trains nothing (the optimizer state has advanced)
        small = buf.size < MIN_UPDATE_ROWS
        with torch.no_grad():
            for p, old in zip(params, before):
                p.copy_(torch.where(small, old, p))

        metrics = {"Train/dagger_loss": torch.stack(losses).mean(),
                   "Train/cur_buf_size": buf.size.float(),
                   "Train/mix_buf_ind": buf.write_idx.float()}
        for k, v in infos.items():
            v2 = v.reshape(self.n_steps, -1)
            metrics[f"Train/{k}_mean"] = v2.mean()
            metrics[f"Train/{k}_max"] = v2.max(dim=0).values.mean()
        return ts, env_state, metrics

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

    def save(self, it: int, ts: DaggerTrainState) -> str:
        """Write ``model_{it}.ckpt``: the student and its Adam state (format
        of :func:`_read_actor_critic`)."""
        os.makedirs(self.save_ckpt_dir, exist_ok=True)
        path = pjoin(self.save_ckpt_dir, f"model_{it}.ckpt")
        ckpt_lib.save(path, {
            "iteration": it,
            "ac": self.student.state_dict(),
            "opt": ts.opt.state_dict(),
            "total_steps": self.total_envsteps,
            "obs_mode": self.stu_obs_mode,
            "model_cfg": self.model_cfg,
            "teacher": self.teacher_path,
            "tricks": {"use_state_norm": False},
        })
        print(f"save ckpt to {path}!")
        return path

    def resume(self, ts: DaggerTrainState, path: Optional[str]):
        """Student weights, its Adam state (where the checkpoint has one),
        iteration and step count from a DAgger checkpoint of the port or of
        the JAX package."""
        if not path:
            return ts
        print(f"load ckpt from {path}!")
        d = _read_actor_critic(path, self.model_cfg["network"]["name"])
        self.curr_iter = int(d["iteration"] or 0)
        self.total_envsteps = int(d["total_steps"] or 0)
        self.student.load_state_dict(d["ac"])
        if d["opt"] is not None:
            ts.opt.load_state_dict(d["opt"])
        else:   # a checkpoint written for evaluation only
            print("the checkpoint holds no optimizer state: Adam starts afresh")
        return ts

    def load_pretrain(self, ts, path: Optional[str]):
        """BC-pretrained init: load actor/critic, keep the fresh log_std."""
        if not path:
            return ts
        sd = dict(_read_actor_critic(path, self.model_cfg["network"]["name"])["ac"])
        sd["log_std"] = self.student.log_std.detach().cpu()
        self.student.load_state_dict(sd)
        return ts

    def _lr_now(self):
        if self.lr_schedule == "linear_decay":
            return np.float32(self.lr * max(
                1 - self.curr_iter / self.max_iter * 1.8, 0.1))
        return np.float32(self.lr)

    def run(self, seed: int = 0, resume: Optional[str] = None):
        ts, env_state = self.init_state(seed)
        resume_path = resume or self.cfg.get("resume")
        ts = self.resume(ts, resume_path)
        if not resume_path:   # pretrain would clobber a resumed student
            ts = self.load_pretrain(ts, self.cfg.get("pretrain"))
        if self.offline_data_pth:
            ts = self.load_offline(ts, self.offline_data_pth)
        if self.test_only:
            env_state, log = self.eval(ts, env_state, mode="Test")
            self.logger.info(log, self.curr_iter)
            self.last_log, self.last_env_state = log, env_state
            return ts

        while self.curr_iter < self.max_iter:
            self.curr_iter += 1
            t0 = time.time()
            lr = self._lr_now()
            ts, env_state, metrics = self._dagger_iteration(ts, env_state, float(lr))
            log = fetch_scalars(metrics)          # waits for the iteration
            elapsed = time.time() - t0
            self.total_envsteps += self.n_steps * self.num_envs
            log["Progress/total_steps"] = self.curr_iter
            log["Progress/iteration_time"] = elapsed
            log["Progress/FPS"] = int(self.n_steps * self.num_envs / max(elapsed, 1e-9))
            log["Train/learning_rate"] = float(lr)
            if self.curr_iter % self.eval_freq == 0:
                env_state, ev = self.eval(ts, env_state)
                log.update(ev)
                with torch.no_grad():
                    env_state, obs = self.env.reset(env_state)
                ts = ts._replace(stu_obs=self._select(obs, self.stu_obs_mode),
                                 tea_obs=self._select(obs, self.tea_obs_mode))
            if self.curr_iter % self.save_freq == 0:
                self.save(self.curr_iter, ts)
            self.logger.info(log, self.curr_iter)
            self.train_logs.append(log)
            self.last_log = log
        self.last_env_state, self.last_ts = env_state, ts
        return ts
