"""PPO with KL-gated decoupled actor/critic phases (PyTorch).

Counterpart of ``partmanip_tpu/algos/ppo.py``: the train iteration —
rollout(n_steps) → GAE → actor phase → critic phase —, the evaluation
rounds, checkpoint save/resume and the outer loop, with the same metric
names (``Train/*``, ``Test/succ_rate_max``, …):

* separate Adam optimizers for actor(+log_std) and critic, the lr schedule
  applied to the actor only; :class:`Adam` computes what ``optax.chain(
  optax.clip_by_global_norm(max_grad_norm), optax.adam(lr))`` computes, in
  its order (``torch.optim.Adam`` places ε and the bias corrections
  differently, and ``clip_grad_norm_`` adds 1e-6 to the norm);
* KL gate: a minibatch update is skipped entirely when the (reference-form)
  KL estimate exceeds ``desired_kl`` — the optimizer state and its step
  count stay as they were;
* tricks: mini/whole adv-norm, clipped value loss, grad clip;
* obs RMS normalization updated during rollouts and frozen once eval
  max-success exceeds 50 %;
* GAE with adv=0 across dones and succ_value-pinned returns (storage.py).

The rollout draws its exploration noise from a ``torch.Generator`` (the JAX
package's PRNG keys do not carry over); the parity test feeds both
trainers a fixed rollout and fixed minibatch indices.

With ``parallel.num_devices`` N > 1 each of N ranks (``parallel/mesh.py``,
started by ``train_torch.py``) holds an env of E/N envs and a replica of
everything else; the rollout's draws, the RMS update, the advantage and
minibatch normalisations, the KL estimate, the clipped-value ``delta``,
every loss (a sum over the rank's rows of a global minibatch over the
global minibatch size, its gradients summed over the ranks before the
clip) and every metric are reduced over the ranks, so the iteration
computes what one process computes for E envs.  Rank 0 logs and saves.
"""

from __future__ import annotations

import math
import os
import time
from os.path import join as pjoin
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from ..models.actor_critic import ActorCritic
from ..parallel import mesh as mesh_lib
from . import rms as rms_lib
from . import storage
from ..utils import checkpoint as ckpt_lib
from ..utils import convert
from ..utils.fetch import fetch_scalars

# (H, W) of the evaluation video's frames, the JAX package's default
VIDEO_RES = (512, 1024)


def video_camera(env, res):
    """(pose [1, 4, 4], intrinsics, H, W) of the evaluation video: the
    env's camera rig's view-0 pose, ``res`` = (H, W)."""
    from ..utils import camera as camera_lib
    cam = env.cfg["cam"]
    poses = camera_lib.gen_camera_poses(cam["look_at"], cam["radius"], num_views=3)[:1]
    h, w = res
    return poses, camera_lib.camera_intrinsics(w, h), h, w


def video_prims(env, sim, env_id: int):
    """The scene's primitives (``envs/vision.scene_prims``) of env
    ``env_id`` alone: its tensor fields sliced, the bool ``ground`` kept
    (the JAX package's ``_eval_capture`` maps it too and raises)."""
    from ..envs import vision as vision_lib
    prims = vision_lib.scene_prims(env, sim)
    return prims._replace(**{k: v[env_id:env_id + 1] for k, v in prims._asdict().items()
                             if isinstance(v, torch.Tensor)})


def _from_jax(j: dict, network: str = "MLP") -> dict:
    """A JAX PPO checkpoint (``checkpoint.load_jax``) in the port's format,
    its Adam states included."""
    return {"iteration": int(j["iteration"]),
            "ac": convert.actor_critic_from_jax(j["params"]._asdict(), network),
            "opt_actor": convert.adam_state_from_jax(j["opt_actor"], "actor", network),
            "opt_critic": convert.adam_state_from_jax(j["opt_critic"], "critic", network),
            "rms": j["rms"]._asdict(), "update_rms": bool(j["update_rms"]),
            "total_steps": int(j["total_steps"]), "tricks": j["tricks"],
            "obs_mode": j["obs_mode"]}


class Adam:
    """``optax.chain(clip_by_global_norm(max_norm), adam(lr))`` (the clip
    only when ``max_norm`` is set) over named parameters, with optax's
    arithmetic: g ← g if ‖g‖ < max_norm else g/‖g‖·max_norm over all
    parameters; μ ← (1−β₁)g + β₁μ, ν ← (1−β₂)g² + β₂ν, count ← count + 1;
    p ← p + (μ/(1−β₁ᶜᵒᵘⁿᵗ)) / (√(ν/(1−β₂ᶜᵒᵘⁿᵗ)) + ε) · (−lr).  A step that
    is not taken leaves every moment and the count as they were.  A
    parameter the loss does not reach (``.grad`` None, e.g. the DAgger
    student's critic) steps with a zero gradient, as optax updates the whole
    parameter tree: its moments decay, it does not move."""

    B1, B2, EPS = 0.9, 0.999, 1e-8        # optax.adam's defaults, as the JAX package uses

    def __init__(self, named_params, max_norm: Optional[float] = None):
        self.names = [n for n, _ in named_params]
        self.params = [p for _, p in named_params]
        self.max_norm = max_norm
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self, lr: float) -> None:
        """Apply one update from the parameters' ``.grad``."""
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in self.params]
        if self.max_norm is not None:
            g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            keep = g_norm < self.max_norm
            grads = [torch.where(keep, g, (g / g_norm) * self.max_norm) for g in grads]
        self.count += 1
        # the bias corrections in f32, as optax computes decay ** count
        f32 = lambda x: torch.tensor(x, dtype=torch.float32)
        bc1 = (1 - f32(self.B1) ** self.count).item()
        bc2 = (1 - f32(self.B2) ** self.count).item()
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            mu.copy_((1 - self.B1) * g + self.B1 * mu)
            nu.copy_((1 - self.B2) * (g * g) + self.B2 * nu)
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.EPS)
            p.copy_(p + u * (-lr))

    def state_dict(self) -> dict:
        return {"count": self.count, "mu": dict(zip(self.names, self.mu)),
                "nu": dict(zip(self.names, self.nu))}

    def load_state_dict(self, d: dict) -> None:
        if set(d["mu"]) != set(self.names) or set(d["nu"]) != set(self.names):
            raise ValueError(f"optimizer state for {sorted(d['mu'])}, "
                             f"not {sorted(self.names)}")
        self.count = int(d["count"])
        for i, n in enumerate(self.names):
            for mine, theirs in ((self.mu, d["mu"]), (self.nu, d["nu"])):
                t = torch.as_tensor(theirs[n], dtype=torch.float32)
                if t.shape != mine[i].shape:
                    raise ValueError(f"optimizer moment {n}: {tuple(t.shape)} vs "
                                     f"{tuple(mine[i].shape)}")
                mine[i].copy_(t)


class PPOTrainState(NamedTuple):
    """What the runner carries beside the network (``PPO.ac`` holds the
    parameters)."""

    rms: rms_lib.RMSState
    update_rms: torch.Tensor      # bool scalar (freeze flag)
    curr_obs: torch.Tensor        # [E, O] normalized obs carried across iters
    rng: torch.Generator          # policy-noise / minibatch generator
    opt_actor: Adam               # actor network + log_std
    opt_critic: Adam


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
        self.succ_value = cfg["succ_value"]
        self.model_cfg = cfg["model"]
        self.max_iter = cfg["max_iterations"]
        self.n_steps = cfg["n_steps"]
        self.n_updates = cfg["n_updates"]
        self.num_mini_batches = cfg["n_minibatches"]

        self.eval_round = cfg["eval_round"]
        self.eval_freq = cfg["eval_frequence"]
        self.save_freq = cfg["save_frequence"]
        self.test_only = cfg.get("test_only") or False
        self.save_pose = cfg.get("save_pose") or False
        self.save_video = cfg.get("save_video") or False
        self.save_ckpt_dir = logger.save_ckpt_dir

        self.lr_schedule = cfg["lr_schedule"]
        if self.lr_schedule not in ("fixed", "linear_decay", "step_decay"):
            raise ValueError(f"lr_schedule {self.lr_schedule!r}")
        self.lr = cfg["lr"]
        self.desired_kl = cfg["desired_kl"]
        if not self.desired_kl > 0:
            raise ValueError(f"desired_kl must be > 0, got {self.desired_kl}")
        self.epsilon_clip = cfg["epsilon_clip"]
        self.gamma = cfg["gamma"]
        self.lam = cfg["lam"]
        self.sampler = cfg["sampler"]

        self.tricks = {k: cfg["tricks"][k] for k in self.TRICKS_KEYS}
        self.max_grad_norm = cfg["tricks"].get("max_grad_norm", 0.5)

        self.ac = ActorCritic(self.num_obs, self.num_actions,
                              self.model_cfg).to(self.device)

        self.curr_iter = 0
        self.total_envsteps = 0
        self.iteration_seconds = []    # wall time of each train iteration

        # env-axis data parallelism: the env holds this rank's envs
        # (parallel/mesh.py); everything else is replicated
        par = cfg.get("parallel") or {}
        self.num_devices = int(par.get("num_devices") or 1)
        self.mesh = getattr(env, "mesh", None)
        ranks = 1 if self.mesh is None else self.mesh.size
        if ranks != self.num_devices:
            raise ValueError(
                f"parallel.num_devices {self.num_devices}, but the env is sharded over "
                f"{ranks} rank(s): train_torch.py starts the ranks (parallel/mesh.launch)")
        if self.mesh is not None and env.num_envs * ranks != self.num_envs:
            raise ValueError(f"the env holds {env.num_envs} envs, not num_envs "
                             f"{self.num_envs} / {ranks} ranks")
        self.is_main = self.mesh is None or self.mesh.rank == 0

    # ------------------------------------------------------------------
    # state init / io
    # ------------------------------------------------------------------

    def _optimizers(self):
        """Fresh (actor + log_std, critic) optimizers over ``self.ac``."""
        clip = self.max_grad_norm if self.tricks["use_grad_clip"] else None
        actor = [(n, p) for n, p in self.ac.named_parameters() if not n.startswith("critic.")]
        critic = [(n, p) for n, p in self.ac.named_parameters() if n.startswith("critic.")]
        return Adam(actor, clip), Adam(critic, clip)

    def init_state(self, seed: int):
        """Seeded network weights and generator, env state after its first
        reset (one settling physics step), a fresh RMS and fresh
        optimizers."""
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
            curr_obs, rms_state = rms_lib.normalize(rms_state, curr_obs, update, self.mesh)
        opt_actor, opt_critic = self._optimizers()
        ts = PPOTrainState(rms=rms_state, update_rms=update, curr_obs=curr_obs,
                           rng=rng, opt_actor=opt_actor, opt_critic=opt_critic)
        return ts, env_state

    def _select_obs(self, obs: Dict[str, torch.Tensor]):
        o = obs[self.obs_mode]
        if self.cfg.get("add_proprio_obs") and self.obs_mode != "proprio_state":
            o = torch.cat([o, obs["proprio_state"]], dim=-1)
        return o

    def save(self, it: int, ts: PPOTrainState) -> str:
        """Write ``model_{it}.ckpt`` (format of :meth:`resume`)."""
        os.makedirs(self.save_ckpt_dir, exist_ok=True)
        path = pjoin(self.save_ckpt_dir, f"model_{it}.ckpt")
        ckpt_lib.save(path, {
            "iteration": it,
            "ac": self.ac.state_dict(),
            "opt_actor": ts.opt_actor.state_dict(),
            "opt_critic": ts.opt_critic.state_dict(),
            "rms": ts.rms._asdict(),
            "update_rms": bool(ts.update_rms),
            "total_steps": self.total_envsteps,
            "tricks": self.tricks,
            "obs_mode": self.obs_mode,
            "model_cfg": self.model_cfg,
        })
        print(f"save ckpt to {path}!")
        return path

    def resume(self, ts: PPOTrainState, path: Optional[str]):
        """Load a checkpoint of the port (``{"iteration", "ac" (state dict),
        "opt_actor" / "opt_critic" ({"count", "mu", "nu"}; optional), "rms" {"n",
        "mean", "S"}, "update_rms", "total_steps", "tricks", "obs_mode"}``)
        or one written by the JAX package (detected by its format, converted
        through ``utils.convert``, its Adam states included)."""
        if not path:
            return ts
        print(f"load ckpt from {path}!")
        if ckpt_lib.is_jax_checkpoint(path):
            d = _from_jax(ckpt_lib.load_jax(path), self.model_cfg["network"]["name"])
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
        if "opt_actor" in d:
            ts.opt_actor.load_state_dict(d["opt_actor"])
            ts.opt_critic.load_state_dict(d["opt_critic"])
        else:   # a checkpoint written for evaluation only
            print("the checkpoint holds no optimizer state: Adam starts afresh")
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
    # train iteration
    # ------------------------------------------------------------------

    @torch.no_grad()
    def _rollout(self, ts: PPOTrainState, env_state):
        """n_steps of policy + env, collecting the Rollout (time-major)."""
        obs, rms_state = ts.curr_obs, ts.rms
        steps, infos = [], {}
        for _ in range(self.n_steps):
            actions, logp, values, mu, sigma = self.ac.random_act_cri(
                obs, generator=ts.rng, mesh=self.mesh)
            env_state, next_obs, rew, dones, extras = self.env.step(
                env_state, actions, train=True)
            o = self._select_obs(next_obs)
            if self.tricks["use_state_norm"]:
                o, rms_state = rms_lib.normalize(rms_state, o, ts.update_rms, self.mesh)
            steps.append(storage.Rollout(
                observations=obs, actions=actions, rewards=rew, dones=dones,
                succs=env_state.reset_succ, values=values[..., 0],
                log_probs=logp, mu=mu, sigma=sigma))
            step_infos = {k: v.float() for k, v in extras.items()}
            step_infos["value_pred"] = values[..., 0]
            for k, v in step_infos.items():
                infos.setdefault(k, []).append(v)
            obs = o
        ro = storage.Rollout(*[torch.stack(x) for x in zip(*steps)])
        infos = {k: torch.stack(v) for k, v in infos.items()}
        return ts._replace(curr_obs=obs, rms=rms_state), env_state, ro, infos

    def _rows_mean(self, x, n):
        """The mean over a minibatch of ``n`` rows of which ``x`` holds this
        rank's: ``x.mean()`` in one process, else this rank's part of it
        (``x.sum() / n``, summed over the ranks with the gradients)."""
        return x.mean() if self.mesh is None else x.sum() / n

    def _actor_loss(self, obs, actions, old_logp, advantages, n=None):
        mean = self.ac.actor(obs)
        std = self.ac.std()
        raw = self.ac.deactivate(actions)
        logp = self.ac._log_prob(mean, std, raw)
        ratio = torch.exp(logp - old_logp)
        surr = -advantages * ratio
        surr_clipped = -advantages * torch.clamp(
            ratio, 1.0 - self.epsilon_clip, 1.0 + self.epsilon_clip)
        return self._rows_mean(torch.maximum(surr, surr_clipped), n)

    def _critic_loss(self, obs, returns, old_values, n=None):
        value = self.ac.critic(obs)[..., 0]
        if self.tricks["use_clipped_value_loss"]:
            delta = mesh_lib.mean(self.mesh, torch.abs(self.epsilon_clip * old_values), n)
            ret_c = old_values + torch.clamp(returns - old_values, -delta, delta)
            return self._rows_mean((value - ret_c.detach()) ** 2, n)
        return self._rows_mean((returns - value) ** 2, n)

    @torch.no_grad()
    def _kl(self, obs, old_mu, old_sigma, n=None):
        """Reference-form KL estimate: stored sigma rows are log-std; the
        estimate uses exp(sigma) as std.  Its mean over the minibatch's
        ``n`` rows of every rank."""
        mu = self.ac.actor(obs)
        sigma = self.ac.log_std.expand(mu.shape)
        kl = torch.sum(
            sigma - old_sigma
            + (torch.exp(old_sigma) ** 2 + (old_mu - mu) ** 2)
            / (2.0 * torch.exp(sigma) ** 2) - 0.5, dim=-1)
        return mesh_lib.mean(self.mesh, kl, n)

    def _mean(self, x):
        """The mean of ``x``'s elements over every rank's (each holding as
        many)."""
        return mesh_lib.mean(self.mesh, x, x.numel() * (1 if self.mesh is None else self.mesh.size))

    def _local_rows(self, epoch_idx):
        """Each minibatch's rows (global flat indices t·E + e into the
        rollout of all E envs) as this rank's flat indices t·E/N + e − lo,
        for the envs e of this rank; in one process the minibatches as
        they are."""
        if self.mesh is None:
            return list(epoch_idx)
        E, El = self.num_envs, self.env.num_envs
        lo = self.mesh.rank * El
        g = epoch_idx.cpu()
        t, e = g // E, g % E
        mine = (e >= lo) & (e < lo + El)
        loc = t * El + (e - lo)
        return [loc[i][mine[i]].to(epoch_idx.device) for i in range(g.shape[0])]

    def _train_iteration(self, ts: PPOTrainState, env_state, lr):
        """Rollout, GAE, the KL-gated actor phase and the critic phase over
        ``n_updates`` epochs of minibatches.  Returns (ts, env_state,
        metrics as device scalars)."""
        ts, env_state, ro, infos = self._rollout(ts, env_state)
        with torch.no_grad():
            last_values = self.ac.cri(ts.curr_obs)[..., 0]
        returns, advantages = storage.compute_returns(
            ro, last_values, self.gamma, self.lam,
            None if self.succ_value is None else float(self.succ_value),
            self.tricks["whole_adv_norm"], self.mesh)

        mesh = self.mesh
        total = self.n_steps * self.num_envs                 # every rank's rows
        flat = lambda x: x.reshape((-1,) + x.shape[2:])
        obs_f, act_f, logp_f = flat(ro.observations), flat(ro.actions), flat(ro.log_probs)
        mu_f, sigma_f = flat(ro.mu), flat(ro.sigma)
        adv_f, ret_f, val_f = flat(advantages), flat(returns), flat(ro.values)
        epoch_idx = storage.minibatch_indices(
            ts.rng, total, self.num_mini_batches, self.sampler,
            n_epochs=self.n_updates, device=obs_f.device)
        mb = epoch_idx.shape[1]
        batches = self._local_rows(epoch_idx)

        # ---- actor phase (the lr schedule applies to the actor only) ----
        kls, losses, applied = [], [], []
        for idx in batches:
            o, a, lp, ad = obs_f[idx], act_f[idx], logp_f[idx], adv_f[idx]
            if self.tricks["mini_adv_norm"]:
                m = mesh_lib.mean(mesh, ad, mb)
                ad = (ad - m) / (mesh_lib.std(mesh, ad, m, mb) + 1e-8)
            kl = self._kl(o, mu_f[idx], sigma_f[idx], mb)
            self.ac.zero_grad(set_to_none=True)
            loss = self._actor_loss(o, a, lp, ad, mb)
            loss.backward()
            loss = mesh_lib.all_sum_grads(mesh, ts.opt_actor.params, loss)
            gate = bool(kl <= self.desired_kl)
            if gate:
                ts.opt_actor.step(lr)
            kls.append(kl)
            losses.append(loss.detach() if gate else torch.zeros_like(loss))
            applied.append(gate)

        # ---- critic phase ----
        v_losses = []
        for idx in batches:
            self.ac.zero_grad(set_to_none=True)
            loss = self._critic_loss(obs_f[idx], ret_f[idx], val_f[idx], mb)
            loss.backward()
            loss = mesh_lib.all_sum_grads(mesh, ts.opt_critic.params, loss)
            ts.opt_critic.step(self.lr)
            v_losses.append(loss.detach())
        self.ac.zero_grad(set_to_none=True)

        kls = torch.stack(kls)
        gate_f = torch.tensor(applied, dtype=kls.dtype, device=kls.device)
        n_applied = torch.clamp(gate_f.sum(), min=1.0)
        noise = torch.exp(self.ac.log_std.detach())
        metrics = {
            "Train/value_gt_return_mean": self._mean(returns),
            "Train/value_gt_return_max": mesh_lib.all_max(mesh, returns.max()),
            "Train/value_function_loss": torch.stack(v_losses).mean(),
            "Train/surrogate_loss": torch.stack(losses).sum() / n_applied,
            # KL averaged over *applied* minibatches only
            "Train/kl": (kls * gate_f).sum() / n_applied,
            "Train/kl_max": kls.max(),
            "Train/kl_update_count": gate_f.sum(),
            # noise-std curves log exp(log_std) like the reference (the
            # effective sampling std is exp(2·log_std))
            "Train/mean_action_noise_std": noise.mean(),
            "Train/mean_t_noise_std": noise[:3].mean(),
            "Train/mean_r_noise_std": noise[3:-1].mean(),
            "Train/mean_gripper_noise_std": noise[-1],
        }
        # per-key mean and mean-of-per-env-max ([T, E]-stacked infos; the
        # env's replicated extras are every rank's already)
        for k, v in infos.items():
            v2 = v.reshape(self.n_steps, -1)
            mean = (lambda x: x.mean()) if k in mesh_lib.REPLICATED_FIELDS else self._mean
            metrics[f"Train/{k}_mean"] = mean(v2)
            metrics[f"Train/{k}_max"] = mean(v2.max(dim=0).values)
        return ts, env_state, metrics

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
        rew_curve, replicated = [], set()
        for _ in range(T):
            actions, _ = self.ac.act_cri(o)
            env_state, next_obs, rew, dones, extras = self.env.step(
                env_state, actions, train=False)
            o = self._select_obs(next_obs)
            if self.tricks["use_state_norm"]:
                o, _ = rms_lib.normalize(ts.rms, o, False)
            infos = {k: v.float() for k, v in extras.items()}
            replicated = {k for k in extras if k in mesh_lib.REPLICATED_FIELDS}
            infos["succ_rate"] = env_state.success.float()
            infos["reward"] = rew
            for k, v in infos.items():
                v = v.reshape(-1)
                # running sum / running per-env max over the episode
                sums[k] = v if k not in sums else sums[k] + v
                maxes[k] = v if k not in maxes else torch.maximum(maxes[k], v)
            rew_curve.append(rew.mean() if self.mesh is None else rew.sum())
        metrics = {}
        for k in sums:
            mean = (lambda x: x.mean()) if k in replicated else self._mean
            metrics[f"{k}_mean"] = mean(sums[k]) / T
            metrics[f"{k}_max"] = mean(maxes[k])
        curve = torch.stack(rew_curve)
        if self.mesh is not None:
            curve = mesh_lib.all_sum(self.mesh, curve) / self.num_envs
        return env_state, metrics, curve

    @torch.no_grad()
    def _eval_capture(self, ts: PPOTrainState, env_state):
        """One evaluation episode with pose dumps and / or video frames (the
        JAX package's ``_eval_capture``), before the evaluation rounds.

        Pose-only capture is :meth:`_eval_capture_poses`.  With video, env
        ``min(3, E - 1)`` is rendered once a step at :data:`VIDEO_RES` by
        ``raymarch.render_rgb`` from the rig's view-0 pose, its depth
        through kernel B2 on the card, and written with ``utils/video``;
        poses, if asked for too, are copied to the host every step
        (:func:`video_camera`, :func:`video_prims`)."""
        from ..ops import raymarch
        from ..utils import video as video_lib
        if self.mesh is not None:
            raise ValueError("evaluation capture (--save_pose / --save_video) dumps one "
                             "process's envs: run it with parallel.num_devices 1")
        if self.save_pose and not self.save_video:
            return self._eval_capture_poses(ts, env_state)
        env_state, obs = self.env.reset(env_state)
        o = self._select_obs(obs)
        if self.tricks["use_state_norm"]:
            o, _ = rms_lib.normalize(ts.rms, o, False)
        pose_dir = pjoin(self.logger.save_pose_dir, f"Iter{self.curr_iter}")
        video_dir = pjoin(self.logger.save_video_dir, f"Iter{self.curr_iter}")
        cam = video_camera(self.env, VIDEO_RES)
        env_id = min(3, self.num_envs - 1)
        save_dicts = []
        for i in range(self.max_episode_length):
            actions, _ = self.ac.act_cri(o)
            if self.save_pose:
                d = {k: v.cpu().numpy() for k, v in self.env.scene_pose(env_state).items()}
                d["state"] = o.float().cpu().numpy()
                d["action"] = actions.float().cpu().numpy()
                save_dicts.append(d)
            rgb = raymarch.render_rgb(video_prims(self.env, env_state.sim, env_id), *cam)
            video_lib.save_rgb_frame(pjoin(video_dir, f"{i:04d}.png"),
                                     rgb[0, 0].cpu().numpy())
            env_state, next_obs, rew, dones, extras = self.env.step(
                env_state, actions, train=False)
            o = self._select_obs(next_obs)
            if self.tricks["use_state_norm"]:
                o, _ = rms_lib.normalize(ts.rms, o, False)
        if self.save_pose:
            success = env_state.success.cpu().numpy()
            os.makedirs(pose_dir, exist_ok=True)
            for i, d in enumerate(save_dicts):
                d["success"] = success
                np.save(pjoin(pose_dir, f"{i}.npy"), d)
        video_lib.path_to_video(video_dir)
        return env_state

    @torch.no_grad()
    def _eval_capture_poses(self, ts: PPOTrainState, env_state):
        """Pose-only capture: the episode's pose dicts, states and actions
        stacked on the device, copied to the host once, and written as
        ``Iter{n}/{i}.npy`` dicts (``rot``, ``pos``, ``state``, ``action``,
        ``success``), as the JAX package writes them."""
        env_state, obs = self.env.reset(env_state)
        o = self._select_obs(obs)
        if self.tricks["use_state_norm"]:
            o, _ = rms_lib.normalize(ts.rms, o, False)
        steps = []
        for _ in range(self.max_episode_length):
            actions, _ = self.ac.act_cri(o)
            out = dict(self.env.scene_pose(env_state))
            out["state"] = o.float()
            out["action"] = actions.float()
            steps.append(out)
            env_state, next_obs, rew, dones, extras = self.env.step(
                env_state, actions, train=False)
            o = self._select_obs(next_obs)
            if self.tricks["use_state_norm"]:
                o, _ = rms_lib.normalize(ts.rms, o, False)
        outs = {k: torch.stack([s[k] for s in steps]).cpu().numpy() for k in steps[0]}
        success = env_state.success.cpu().numpy()
        pose_dir = pjoin(self.logger.save_pose_dir, f"Iter{self.curr_iter}")
        os.makedirs(pose_dir, exist_ok=True)
        for i in range(self.max_episode_length):
            d = {k: v[i] for k, v in outs.items()}
            d["success"] = success
            np.save(pjoin(pose_dir, f"{i}.npy"), d)
        return env_state

    def eval(self, ts: PPOTrainState, env_state, mode="Val"):
        agg = {}
        curves = []
        if self.save_pose or self.save_video:
            env_state = self._eval_capture(ts, env_state)
        for _ in range(self.eval_round):
            env_state, m, rew_curve = self._eval_round(ts, env_state)
            curves.append(rew_curve.cpu().numpy())
            for k, v in fetch_scalars(m).items():
                agg.setdefault(k, []).append(v)
        if self.cfg.get("save_teacher_reward") and self.is_main:
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

    def _lr_now(self):
        if self.lr_schedule == "linear_decay":
            return np.float32(
                max(self.lr * (1 - self.curr_iter / self.max_iter), 1e-5))
        if self.lr_schedule == "step_decay":
            return np.float32(
                1e-5 if self.curr_iter > self.max_iter // 2 else self.lr)
        return np.float32(self.lr)

    def run(self, seed: int = 0, resume: Optional[str] = None):
        ts, env_state = self.init_state(seed)
        ts = self.resume(ts, resume or self.cfg.get("resume"))
        if self.test_only:
            ts, env_state, log = self.eval(ts, env_state, mode="Test")
            if self.is_main:
                self.logger.info(log, self.curr_iter)
            self.last_log, self.last_env_state = log, env_state
            return ts

        while self.curr_iter < self.max_iter:
            self.curr_iter += 1
            t0 = time.time()
            lr = self._lr_now()
            ts, env_state, metrics = self._train_iteration(ts, env_state, float(lr))
            log = fetch_scalars(metrics)          # waits for the iteration
            elapsed = time.time() - t0
            self.iteration_seconds.append(elapsed)
            self.total_envsteps += self.n_steps * self.num_envs
            log["Progress/total_steps"] = self.curr_iter
            log["Progress/iteration_time"] = elapsed
            log["Progress/FPS"] = int(self.n_steps * self.num_envs / max(elapsed, 1e-9))
            log["Train/learning_rate"] = float(lr)
            if self.is_main:
                self.logger.info(log, self.curr_iter)
            self.last_log = log

            if self.curr_iter % self.eval_freq == 0:
                ts, env_state, eval_log = self.eval(ts, env_state)
                if self.is_main:
                    self.logger.info(eval_log, self.curr_iter)
                with torch.no_grad():
                    env_state, obs = self.env.reset(env_state)
                o = self._select_obs(obs)
                if self.tricks["use_state_norm"]:
                    o, new_rms = rms_lib.normalize(ts.rms, o, ts.update_rms, self.mesh)
                    ts = ts._replace(rms=new_rms)
                ts = ts._replace(curr_obs=o)
            if self.curr_iter % self.save_freq == 0 and self.is_main:
                self.save(self.curr_iter, ts)
        self.last_env_state = env_state
        return ts
