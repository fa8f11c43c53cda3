"""The committed expert checkpoint read by the reference's own copy of
the checkpoint reader (``plain/utils/checkpoint``, ``plain/utils/convert``):
its actor-critic parameters by state-dict name and its frozen observation
statistics, as a raw file both sides read."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from . import nets
from .plain.utils import checkpoint, convert


def load(path: str, device) -> Tuple[Dict[str, torch.Tensor], Optional[dict]]:
    """(parameters on ``device``, ``{"mean", "std"}`` of its obs RMS where it
    was trained with state normalisation, else ``None``)."""
    j = checkpoint.load_jax(path)
    net = (j.get("model_cfg") or {}).get("network", {}).get("name", "MLP")
    params = {k: v.float().to(device)
              for k, v in convert.actor_critic_from_jax(j["params"]._asdict(), net).items()}
    rms = None
    if (j.get("tricks") or {}).get("use_state_norm"):
        r = {k: torch.as_tensor(v, dtype=torch.float32, device=device)
             for k, v in j["rms"]._asdict().items()}
        rms = {"mean": r["mean"], "std": torch.sqrt(r["S"] / torch.clamp(r["n"], min=1))}
    return params, rms


def act(params, rms, obs, clip: float, prec: str = "f32"):
    """The teacher's deterministic activated action on raw observations."""
    if rms is not None:
        obs = (obs - rms["mean"]) / rms["std"]
    with nets.precision(prec):
        return nets.activate(nets.mlp(params, "actor", obs, prec), clip)
