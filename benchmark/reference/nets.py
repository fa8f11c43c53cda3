"""Plain networks and optimizer of the reference: the actor-critic MLP and
the PointNet student as functions of a ``{name: tensor}`` parameter dict
(the program's state-dict names), optax's ``clip_by_global_norm`` +
``adam`` arithmetic, and the precisions the controls compute in.

The reference computes in float32 with TF32 off.  ``fp8`` (the control
of a bfloat16 network) rounds every matrix product's two inputs to
float8 e4m3 with a per-tensor scale (amax / 448) before an f32 product;
``tf32`` (the control of a float32 network) runs the products with TF32
on."""

from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Dict, List, Optional

import torch

FP8_MAX = 448.0


def _q8(t: torch.Tensor) -> torch.Tensor:
    s = t.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    return (t / s).to(torch.float8_e4m3fn).to(torch.float32) * s


@contextmanager
def precision(prec: str):
    """TF32 on only for ``tf32``; off otherwise (the reference's f32)."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    on = prec == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def linear(p: Dict[str, torch.Tensor], name: str, x: torch.Tensor, prec: str) -> torch.Tensor:
    w, b = p[f"{name}.weight"], p[f"{name}.bias"]
    if prec == "bf16":                   # a witness: the program's bf16 autocast, op for op
        bf = torch.bfloat16
        return torch.nn.functional.linear(x.to(bf), w.to(bf), b.to(bf))
    if prec == "fp8":
        return _q8(x) @ _q8(w).T + b
    return x @ w.T + b


def mlp(p, net: str, x, prec: str = "f32"):
    """``models/networks.MLP`` with tanh: hidden layers then the head (in
    f32 whatever ``prec`` computed it in)."""
    i = 0
    while f"{net}.hidden.{i}.weight" in p:
        x = torch.tanh(linear(p, f"{net}.hidden.{i}", x, prec))
        i += 1
    return linear(p, f"{net}.head", x, prec).float()


def action_gaps(want: torch.Tensor, got: torch.Tensor, name: str = "policy.action") -> dict:
    """The widest gap of ``got`` from ``want`` relative to ``want``'s largest
    magnitude, and the 99th percentile and median over rows of each row's
    widest gap (same scale)."""
    scale = want.abs().max().clamp(min=1e-30)
    per_row = (got.float() - want.float()).abs().reshape(want.shape[0], -1).amax(dim=1) / scale
    per_row = per_row.double()
    return {name: float(per_row.max()), f"{name}.p99": float(torch.quantile(per_row, 0.99)),
            f"{name}.median": float(torch.quantile(per_row, 0.5))}


def pointnet(p, net: str, x, point_num: int, proprio: int, prec: str = "f32"):
    """``models/networks.PointNet`` with tanh (max pool, no mean
    subtraction): per point C → 128 → 256 → 512 (no activation after the
    512), max over points, ‖ proprio, → 128 → 32 → head."""
    b = x.shape[0]
    if proprio:
        pro, pc = x[:, -proprio:], x[:, :-proprio].reshape(b, point_num, -1)
    else:
        pro, pc = None, x.reshape(b, point_num, -1)
    h = pc
    for i in range(3):
        h = linear(p, f"{net}.point.{i}", h, prec)
        if i < 2:
            h = torch.tanh(h)
    h = h.amax(dim=1)
    if pro is not None:
        h = torch.cat([h, pro], dim=-1)
    for i in range(2):
        h = torch.tanh(linear(p, f"{net}.hidden.{i}", h, prec))
    return linear(p, f"{net}.head", h, prec)


def activate(a, clip: float):
    return torch.tanh(a) * clip


def deactivate(a, clip: float):
    return torch.atanh(torch.clamp(a / clip, -1 + 1e-5, 1 - 1e-5))


def log_prob(mean, std, raw):
    return (-0.5 * ((raw - mean) ** 2) / (std * std) - torch.log(std)
            - 0.5 * math.log(2 * math.pi)).sum(dim=-1)


class Adam:
    """optax ``chain(clip_by_global_norm(max_norm), adam(lr))`` over the
    named leaves; a step not taken leaves the moments and count as they
    were.  ``first_grad`` keeps the (clipped) gradient of the first step."""

    B1, B2, EPS = 0.9, 0.999, 1e-8

    def __init__(self, params: Dict[str, torch.Tensor], names: List[str],
                 max_norm: Optional[float]):
        self.p, self.names, self.max_norm = params, names, max_norm
        self.mu = {n: torch.zeros_like(params[n]) for n in names}
        self.nu = {n: torch.zeros_like(params[n]) for n in names}
        self.count = 0
        self.first_grad = None

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor], lr: float) -> None:
        g = {n: grads[n] if grads.get(n) is not None else torch.zeros_like(self.p[n])
             for n in self.names}
        if self.max_norm is not None:
            norm = torch.sqrt(sum((v * v).sum() for v in g.values()))
            if not bool(norm < self.max_norm):
                g = {n: v / norm * self.max_norm for n, v in g.items()}
        if self.first_grad is None:
            self.first_grad = {n: v.clone() for n, v in g.items()}
        self.count += 1
        f32 = lambda x: torch.tensor(x, dtype=torch.float32)
        bc1 = float(1 - f32(self.B1) ** self.count)
        bc2 = float(1 - f32(self.B2) ** self.count)
        for n in self.names:
            self.mu[n] = (1 - self.B1) * g[n] + self.B1 * self.mu[n]
            self.nu[n] = (1 - self.B2) * g[n] * g[n] + self.B2 * self.nu[n]
            self.p[n] = self.p[n] - lr * (self.mu[n] / bc1) / (torch.sqrt(self.nu[n] / bc2) + self.EPS)
