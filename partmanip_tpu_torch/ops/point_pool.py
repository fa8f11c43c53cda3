"""PointNet's last point layer and its max pool over points as one autograd
op, whose backward touches only the argmax points.

PointNet (``models/networks.py``) maps each point to 512 channels with no
activation after the last layer, then takes the max over the points.
Autograd through ``Linear`` + ``amax`` hands that layer a dense
``[B, N, 512]`` gradient that is zero except at each (row, channel)'s
maxima, and multiplies those zeros in two GEMMs.  :class:`LinearMaxPool`
keeps the forward (``F.linear`` in f32, then the max: the same pooled
values bit for bit) and saves, instead of the layer's output, the first
index of each maximum, the count of points equal to it and, where that
count exceeds 1, a bitmask of them.  Its backward computes

* ``db[c] = Σ_b g[b, c]``,
* ``dW[c] = Σ_b g[b, c] / k[b, c] · Σ_{p ∈ ties(b, c)} h2[b, p]``,
* ``dh2[b, p] = Σ_{c : p ∈ ties(b, c)} g[b, c] / k[b, c] · W[c]`` (dense,
  zero off the argmax points),

splitting the gradient evenly among equal maxima as ``amax`` (and the JAX
package's ``jnp.max``) do.

* :func:`linear_max_pool` — the entry point: the fused op where a gradient
  is wanted, ``F.linear(...).amax(1)`` under ``torch.no_grad``;
* :func:`pool_plain` / :func:`backward_plain` — the plain version (the
  pool, then autograd's arithmetic from the saved maxima), which serves CPU
  tensors;
* :func:`pool_cuda` / :func:`backward_cuda` — the kernels of
  ``csrc/point_pool.cu`` for CUDA tensors; ``launch_counts`` rises by one
  per forward (``point_pool.forward``) and per backward
  (``point_pool.backward``, two launches);
* :class:`PoolCounters` — what the backward passes saw: the share of
  (row, channel) pools that tie and the argmax points per row.
"""

from __future__ import annotations

import ctypes
import os

import torch
import torch.nn.functional as F

from ..utils import cuda_lib

SOURCE = os.path.join(cuda_lib.CSRC, "point_pool.cu")
_ptr, _i32 = ctypes.c_void_p, ctypes.c_int
LIBRARY = cuda_lib.Library(
    "point_pool", SOURCE, "libpoint_pool.so",
    {"point_pool_forward": ((_ptr, _ptr, _ptr, _ptr, _ptr, _i32, _i32, _i32, _ptr), _i32),
     "point_pool_backward": ((_ptr, _ptr, _ptr, _ptr, _ptr, _ptr, _ptr, _ptr, _ptr, _ptr,
                              _i32, _i32, _i32, _i32, _i32, _i32, _ptr), _i32)})
MAX_CHANNELS = 1024           # the sort key's channel bits (point_pool.cu C_BITS)
MAX_WIDTH = 1024              # columns of h2: a thread each
SMEM_LIMIT = 48 * 1024        # the input-gradient kernel's shared memory, without opt-in

launch_counts = cuda_lib.launch_counter("point_pool.forward", "point_pool.backward")


def words(n: int) -> int:
    """32-bit words of one (row, channel)'s bitmask over ``n`` points."""
    return (n + 31) // 32


def _pack_bits(sel: torch.Tensor) -> torch.Tensor:
    """bool [B, N, C] → i32 [B, C, W]: bit p % 32 of word p // 32."""
    B, N, C = sel.shape
    W = words(N)
    sel = F.pad(sel, (0, 0, 0, 32 * W - N)).reshape(B, W, 32, C)
    out = torch.zeros((B, W, C), dtype=torch.int32, device=sel.device)
    for q in range(32):
        out |= sel[:, :, q].to(torch.int32) << q
    return out.transpose(1, 2).contiguous()


def _unpack_bits(mask: torch.Tensor, n: int) -> torch.Tensor:
    """i32 [B, C, W] → bool [B, n, C], the inverse of :func:`_pack_bits`."""
    B, C, W = mask.shape
    m = mask.transpose(1, 2)
    bits = torch.stack([((m >> q) & 1).bool() for q in range(32)], dim=2)
    return bits.reshape(B, 32 * W, C)[:, :n]


def pool_plain(h: torch.Tensor):
    """h [B, N, C] → (pooled [B, C], first index of the max i32 [B, C],
    count of points equal to it i32 [B, C], bitmask of those points i32
    [B, C, W])."""
    pooled = h.amax(dim=1)
    eq = h == pooled[:, None, :]
    first = eq.to(torch.uint8).argmax(dim=1).to(torch.int32)
    return pooled, first, eq.sum(dim=1, dtype=torch.int32), _pack_bits(eq)


def backward_plain(g, h2, weight, first, count, mask):
    """The gradients of ``pooled = max_p (h2 Wᵀ + b)`` from ``g`` [B, C]
    and :func:`pool_plain`'s maxima, as autograd through ``amax`` and
    ``Linear`` computes them (a dense ``[B, N, C]`` gradient, ``g / count``
    at each maximum): (dh2 [B, N, D], dW [C, D], db [C], per row its argmax
    points and tied channels i32 [B, 2])."""
    B, N, D = h2.shape
    C = weight.shape[0]
    tied = count > 1
    single = torch.zeros((B, N, C), dtype=torch.bool, device=h2.device)
    single.scatter_(1, first[:, None, :].long(), True)
    sel = torch.where(tied[:, None, :], _unpack_bits(mask, N), single)
    dh = sel * (g / count)[:, None, :]
    dh2 = dh @ weight
    dw = dh.reshape(B * N, C).T @ h2.reshape(B * N, D)
    stats = torch.stack([sel.any(dim=2).sum(dim=1), tied.sum(dim=1)], dim=1)
    return dh2, dw, g.sum(dim=0), stats.to(torch.int32)


def _check_cuda(what, *tensors):
    for t in tensors:
        if not t.is_cuda or t.dtype not in (torch.float32, torch.int32) or not t.is_contiguous():
            raise ValueError(f"the point pool kernels take contiguous f32 / i32 CUDA tensors "
                             f"({what}), got {t.dtype} {tuple(t.shape)} on {t.device}")


def pool_cuda(h: torch.Tensor):
    """:func:`pool_plain` by ``pool_forward_kernel``; the bitmask words of
    channels whose count is 1 are left unset (the backward reads none)."""
    _check_cuda("h", h)
    if h.dtype != torch.float32 or h.dim() != 3:
        raise ValueError(f"the point pool takes f32 [B, N, C], got {h.dtype} {tuple(h.shape)}")
    B, N, C = h.shape
    if C % 4 or h.data_ptr() % 16 or not (B >= 1 and 1 <= N < 2 ** 21 and C <= MAX_CHANNELS):
        raise ValueError(f"the point pool kernel cannot pool [B={B}, N={N}, C={C}] "
                         f"(C a multiple of 4 up to {MAX_CHANNELS}, 16-byte aligned)")
    dev = h.device
    pooled = torch.empty((B, C), dtype=torch.float32, device=dev)
    first = torch.empty((B, C), dtype=torch.int32, device=dev)
    count = torch.empty((B, C), dtype=torch.int32, device=dev)
    mask = torch.empty((B, C, words(N)), dtype=torch.int32, device=dev)
    err = LIBRARY.load().point_pool_forward(h.data_ptr(), pooled.data_ptr(), first.data_ptr(),
                                            count.data_ptr(), mask.data_ptr(), B, N, C,
                                            cuda_lib.stream_of(h))
    cuda_lib.check_launch(err, "point pool forward")
    launch_counts["point_pool.forward"] += 1
    return pooled, first, count, mask


def input_grad_smem(N: int, C: int) -> int:
    """Dynamic shared memory of ``pool_input_grad_kernel`` in bytes: sort
    keys (C rounded up to a power of 2), weights and staged words (C each),
    each point's run as two 16-bit positions."""
    return 4 * (1 << max(C - 1, 0).bit_length()) + 8 * C + 4 * N


def backward_cuda(g, h2, weight, first, count, mask):
    """:func:`backward_plain` by ``pool_weight_grad_kernel`` and
    ``pool_input_grad_kernel``: fixed summation orders, no atomics."""
    _check_cuda("g, h2, weight, first, count, mask", g, h2, weight, first, count, mask)
    B, N, D = h2.shape
    C = weight.shape[0]
    smem = input_grad_smem(N, C)
    if weight.shape[1] != D or D > MAX_WIDTH or smem > SMEM_LIMIT:
        raise ValueError(f"the point pool backward cannot take h2 {tuple(h2.shape)}, "
                         f"W {tuple(weight.shape)} (width up to {MAX_WIDTH}, "
                         f"{smem} B of shared memory against {SMEM_LIMIT})")
    dev = h2.device
    dh2 = torch.empty_like(h2)
    dw = torch.empty_like(weight)
    db = torch.empty(C, dtype=torch.float32, device=dev)
    stats = torch.empty((B, 2), dtype=torch.int32, device=dev)
    err = LIBRARY.load().point_pool_backward(
        g.data_ptr(), h2.data_ptr(), weight.data_ptr(), first.data_ptr(), count.data_ptr(),
        mask.data_ptr(), dh2.data_ptr(), dw.data_ptr(), db.data_ptr(), stats.data_ptr(),
        B, N, C, D, 32 * words(D), smem, cuda_lib.stream_of(h2))
    cuda_lib.check_launch(err, "point pool backward")
    launch_counts["point_pool.backward"] += 1
    return dh2, dw, db, stats


class PoolCounters:
    """Sums over the backward passes of :class:`LinearMaxPool` since the
    last :meth:`reset`: tied pools and argmax points on the device (no
    host synchronisation), pools and rows on the host."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.sums, self.pools, self.rows = None, 0, 0

    def add(self, stats: torch.Tensor, channels: int):
        s = stats.sum(dim=0, dtype=torch.int64)
        self.sums = s if self.sums is None else self.sums + s
        self.rows += stats.shape[0]
        self.pools += stats.shape[0] * channels

    def read(self) -> dict:
        """Device scalars: ``tie_share``, the share of (row, channel) pools
        whose maximum ties, and ``critical_points``, the distinct argmax
        points per row; empty before any backward."""
        if not self.rows:
            return {}
        return {"tie_share": self.sums[1] / self.pools,
                "critical_points": self.sums[0] / self.rows}


class LinearMaxPool(torch.autograd.Function):
    """``F.linear(h2, weight, bias).amax(dim=1)`` whose backward reads only
    the argmax points (the module docstring)."""

    @staticmethod
    def forward(ctx, h2, weight, bias, counters):
        h = F.linear(h2, weight, bias)
        pooled, first, count, mask = pool_cuda(h) if h.is_cuda else pool_plain(h)
        ctx.save_for_backward(h2, weight, first, count, mask)
        ctx.counters = counters
        return pooled

    @staticmethod
    def backward(ctx, g):
        h2, weight, first, count, mask = ctx.saved_tensors
        step = backward_cuda if g.is_cuda else backward_plain
        dh2, dw, db, stats = step(g.contiguous(), h2, weight, first, count, mask)
        if ctx.counters is not None:
            ctx.counters.add(stats, weight.shape[0])
        return dh2, dw, db, None


def linear_max_pool(h2, weight, bias, counters: PoolCounters = None):
    """h2 [B, N, D] → max over the N points of ``h2 Wᵀ + b``, [B, C]."""
    if torch.is_grad_enabled() and (h2.requires_grad or weight.requires_grad
                                    or bias.requires_grad):
        return LinearMaxPool.apply(h2, weight, bias, counters)
    return F.linear(h2, weight, bias).amax(dim=1)
