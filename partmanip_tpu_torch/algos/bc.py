"""Behavior cloning from offline TSDF demo trees (PyTorch).

Counterpart of ``partmanip_tpu/algos/bc.py``:

* the dataset is a directory of ``scene_*/step_*.npy`` dicts with keys
  ``tsdf``, ``action`` and ``proprio_state`` (what ``collect_demos_torch.py``
  writes), read in sorted order and put on the device once;
* every iteration is one shuffled pass of ``n_minibatches`` Adam steps
  (``optax.adam`` arithmetic, :class:`algos.ppo.Adam` without a clip) on the
  L2 loss between the demo actions and the student's *activated* actions;
  the shuffle is ``np.random.RandomState(seed).permutation``, drawn as the
  JAX package draws it, so both packages see the same minibatches;
* the lr schedules ``fixed``, ``linear_decay`` and ``step_decay``;
* ``save`` / ``resume`` (student and Adam state; a BC checkpoint of the JAX
  package resumes too).  Its checkpoint is what ``DAgger.load_pretrain``
  reads.
"""

from __future__ import annotations

import os
import time
from os.path import join as pjoin
from typing import Optional

import numpy as np
import torch

from ..models.actor_critic import ActorCritic
from ..utils import checkpoint as ckpt_lib
from ..utils.fetch import fetch_scalars
from . import storage
from .dagger import _read_actor_critic
from .ppo import Adam

LR_SCHEDULES = ("fixed", "linear_decay", "step_decay")


def load_demo_tree(data_path: str, add_proprio: bool):
    """All (obs, action) pairs of a scene/step .npy tree, in sorted order:
    (obs [n, res³ (+ proprio)], action [n, A]) as f32 numpy."""
    obs, act = storage.read_demo_tree(data_path, add_proprio, "action")
    return np.stack(obs), np.stack(act)


class BC:
    def __init__(self, env, cfg: dict, logger):
        self.env = env
        self.cfg = cfg
        self.logger = logger
        self.device = env.device
        self.obs_mode = cfg["obs_mode"]
        self.add_proprio_obs = cfg.get("add_proprio_obs", False)
        # env.num_obs already includes the proprio concat of the learn mode
        self.num_obs = env.num_obs[self.obs_mode]
        proprio = env.num_obs["proprio_state"] if self.add_proprio_obs else 0
        self.num_actions = env.num_actions
        self.model_cfg = cfg["model"]
        self.max_iter = cfg["max_iterations"]
        self.n_minibatches = cfg["n_minibatches"]
        self.data_path = cfg["data_path"]
        self.save_freq = cfg["save_frequence"]
        self.save_ckpt_dir = logger.save_ckpt_dir
        self.lr_schedule = cfg["lr_schedule"]
        if self.lr_schedule not in LR_SCHEDULES:
            raise ValueError(f"lr_schedule {self.lr_schedule!r}, not one of {LR_SCHEDULES}")
        self.lr = cfg["lr"]
        self.student = ActorCritic(self.num_obs, self.num_actions, self.model_cfg,
                                   proprio_shape=proprio).to(self.device)
        self.opt = Adam(list(self.student.named_parameters()))
        self.curr_iter = 0
        self.train_logs = []     # every iteration's log, in order

    def _lr_now(self):
        if self.lr_schedule == "linear_decay":
            return np.float32(self.lr * (1 - self.curr_iter / self.max_iter))
        if self.lr_schedule == "step_decay":
            return np.float32(
                self.lr if self.curr_iter < self.max_iter / 2 else self.lr * 0.1)
        return np.float32(self.lr)

    def _update(self, obs: torch.Tensor, act: torch.Tensor, lr: float) -> torch.Tensor:
        """One Adam step on the minibatch's L2 loss; returns the loss (a
        device scalar) and leaves the gradients in ``.grad``."""
        self.student.zero_grad(set_to_none=True)
        loss = ((act - self.student.update_act(obs)) ** 2).mean()
        loss.backward()
        self.opt.step(lr)
        return loss.detach()

    def save(self, it: int) -> str:
        """Write ``model_{it}.ckpt``: the student and its Adam state, in the
        format ``DAgger.load_pretrain`` / ``resume`` read."""
        os.makedirs(self.save_ckpt_dir, exist_ok=True)
        path = pjoin(self.save_ckpt_dir, f"model_{it}.ckpt")
        ckpt_lib.save(path, {
            "iteration": it, "ac": self.student.state_dict(),
            "opt": self.opt.state_dict(), "obs_mode": self.obs_mode,
            "total_steps": 0, "tricks": {"use_state_norm": False}, "teacher": None,
            "model_cfg": self.model_cfg,
        })
        print(f"save ckpt to {path}!")
        return path

    def resume(self, path: Optional[str]) -> None:
        """Student, Adam state and iteration from a BC checkpoint of the port
        or of the JAX package."""
        if not path:
            return
        d = _read_actor_critic(path, self.model_cfg["network"]["name"])
        if d["obs_mode"] != self.obs_mode:
            raise ValueError(f"{path} holds a {d['obs_mode']} student, not {self.obs_mode}")
        self.curr_iter = int(d["iteration"] or 0)
        self.student.load_state_dict(d["ac"])
        if d["opt"] is not None:
            self.opt.load_state_dict(d["opt"])

    def run(self, seed: int = 0, resume: Optional[str] = None):
        """Train to ``max_iterations`` from the seeded student, or from the
        checkpoint ``resume`` names (one at iteration 0 starts the run from
        given parameters).  Returns the student."""
        rng = np.random.RandomState(seed)
        obs, act = load_demo_tree(self.data_path, self.add_proprio_obs)
        obs_d = torch.as_tensor(obs, device=self.device)
        act_d = torch.as_tensor(act, device=self.device)
        n = obs.shape[0]
        bsz = max(n // self.n_minibatches, 1)

        self.student.init(seed)
        self.resume(resume or self.cfg.get("resume"))

        while self.curr_iter < self.max_iter:
            self.curr_iter += 1
            t0 = time.time()
            perm = rng.permutation(n)
            lr = float(self._lr_now())
            losses = []
            for b in range(self.n_minibatches):
                idx = perm[b * bsz:(b + 1) * bsz]
                if idx.shape[0] == 0:
                    continue
                idx = torch.as_tensor(idx, device=self.device)
                losses.append(self._update(obs_d[idx], act_d[idx], lr))
            log = fetch_scalars({"Train/bc_loss": torch.stack(losses).mean()})
            log.update({"Train/learning_rate": lr,
                        "Progress/total_steps": self.curr_iter,
                        "Progress/iteration_time": time.time() - t0})
            if self.curr_iter % self.save_freq == 0:
                self.save(self.curr_iter)
            self.logger.info(log, self.curr_iter)
            self.train_logs.append(log)
            self.last_log = log
        return self.student
