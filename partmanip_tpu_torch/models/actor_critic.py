"""Actor-critic with state-independent learned log-std and tanh action
activation (``torch.nn``).

Counterpart of ``partmanip_tpu/models/actor_critic.py``:

* the effective sampling std is exp(log_std)² = exp(2·log_std), with
  log_std initialized to log(action_std);
* actions are stored *activated* (tanh·clipAction) and de-activated with
  atanh(clip(·, ±(1−1e−5))) when re-evaluating log-probs.

Sampling takes either an explicit ``torch.Generator`` or ready-made noise
(tests feed both packages the same numbers).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from ..parallel import mesh as mesh_lib
from .networks import load_resnet34_pretrained, make_network


class ActorCritic(nn.Module):
    """The two networks plus ``log_std``, and the sampling/eval functions."""

    def __init__(self, num_obs: int, num_actions: int, model_cfg: dict,
                 proprio_shape: int = 0):
        super().__init__()
        net_cfg = model_cfg["network"]
        self.net_cfg = net_cfg
        self.actor = make_network(net_cfg["name"], num_obs, num_actions,
                                  net_cfg, proprio_shape)
        self.critic = make_network(net_cfg["name"], num_obs, 1, net_cfg,
                                   proprio_shape)
        self.num_actions = num_actions
        self.num_obs = num_obs
        self.action_std = float(model_cfg["action_std"])
        self.max_action = float(model_cfg["clipAction"])
        if not self.max_action > 0:
            raise ValueError(f"clipAction must be > 0, got {self.max_action}")
        self.action_activate = model_cfg["action_activate"]
        self.log_std = nn.Parameter(torch.full(
            (num_actions,), math.log(max(self.action_std, 1e-8))))

    def init(self, seed: int) -> None:
        """(Re-)initialize all parameters from ``seed``; a ResNet /
        depthResNet whose network config names a ``pretrained`` ``.npz``
        (``tools/resnet_convert.py``) then takes its backbone from it, in
        the actor and the critic."""
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(int(seed))
            self.actor.reset_parameters()
            self.critic.reset_parameters()
        pre = self.net_cfg.get("pretrained")
        if pre and self.net_cfg["name"] in ("ResNet", "depthResNet"):
            load_resnet34_pretrained(self.actor, pre)
            load_resnet34_pretrained(self.critic, pre)
        with torch.no_grad():
            self.log_std.fill_(math.log(max(self.action_std, 1e-8)))

    # --- effective exploration std (see module docstring) ---
    def std(self) -> torch.Tensor:
        return torch.exp(2.0 * self.log_std)

    def activate(self, a):
        if self.action_activate == "tanh":
            return torch.tanh(a) * self.max_action
        if self.action_activate is not None:
            raise ValueError(f"action_activate {self.action_activate!r}")
        return a

    def deactivate(self, a):
        if self.action_activate == "tanh":
            return torch.atanh(torch.clamp(a / self.max_action,
                                           -1 + 1e-5, 1 - 1e-5))
        return a

    def _log_prob(self, mean, std, raw_actions):
        var = std * std
        lp = (-0.5 * ((raw_actions - mean) ** 2) / var
              - torch.log(std) - 0.5 * math.log(2 * math.pi))
        return lp.sum(dim=-1)

    def _noise(self, mean, generator, noise, mesh=None):
        """Standard normal noise shaped like ``mean``; with a ``mesh``
        (``parallel/mesh.py``) drawn at every rank's rows and this rank's
        kept, so each env gets the noise it gets in one process."""
        if noise is not None:
            return noise
        return mesh_lib.shard_draw(
            mesh, mean.shape[0],
            lambda n: torch.randn((n,) + tuple(mean.shape[1:]), generator=generator,
                                  device=mean.device, dtype=mean.dtype))

    def act(self, obs):
        """Deterministic activated action (eval path)."""
        return self.activate(self.actor(obs))

    def update_act(self, obs):
        """Differentiable activated mean (the BC / DAgger loss path; the
        MLP's compute dtype applies under autograd too)."""
        return self.activate(self.actor(obs))

    def act_cri(self, obs):
        return self.activate(self.actor(obs)), self.critic(obs)

    def cri(self, obs):
        return self.critic(obs)

    def random_act_cri(self, obs, generator=None, noise=None, mesh=None):
        """Sample actions; returns (activated action, log_prob, value, mu,
        log_std_row)."""
        mean = self.actor(obs)
        std = self.std()
        raw = mean + std * self._noise(mean, generator, noise, mesh)
        logp = self._log_prob(mean, std, raw)
        value = self.critic(obs)
        sigma_row = self.log_std.expand(mean.shape)
        return self.activate(raw), logp, value, mean, sigma_row

    def random_act(self, obs, generator=None, noise=None):
        mean = self.actor(obs)
        raw = mean + self.std() * self._noise(mean, generator, noise)
        return self.activate(raw)

    def evaluate(self, obs, stored_actions):
        """Log-prob/entropy/value of stored (activated) actions."""
        mean = self.actor(obs)
        std = self.std()
        raw = self.deactivate(stored_actions)
        logp = self._log_prob(mean, std, raw)
        entropy = (0.5 + 0.5 * math.log(2 * math.pi) + torch.log(std)).sum(-1)
        value = self.critic(obs)
        sigma_row = self.log_std.expand(mean.shape)
        return logp, entropy, value, mean, sigma_row
