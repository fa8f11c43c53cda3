"""Farthest-point sampling (PyTorch plain version and kernel B3).

Counterpart of ``partmanip_tpu/ops/fps.py``: pytorch3d
``sample_farthest_points`` semantics with ``random_start_point=False`` —
selection starts at index 0, each next pick is the point whose minimum
squared distance to the picked set is largest (the lowest index among
equals, as ``jnp.argmax``), and invalid points are expected to be pre-zeroed
by the caller so that they collapse into one origin cluster.

* :func:`farthest_point_sampling` — the entry point: points on a CUDA device
  launch kernel B3 (``csrc/fps.cu``), points on the CPU take
  :func:`farthest_point_sampling_plain`;
* :func:`farthest_point_sampling_plain` — the k − 1 step loop over [B, N];
  the squared distance is the fused multiply-add chain
  fma(dz, dz, fma(dy, dy, dx·dx)) that the JAX package's XLA loop computes
  on the CPU and the kernel computes with ``__fmaf_rn`` (:func:`fma_f32`
  rounds each step once), so that all three pick the same indices even
  where distinct points tie;
* :func:`farthest_point_sampling_cuda` — kernel B3: indices i32 [B, k], as
  the JAX package's ``farthest_point_sampling_pallas`` returns them (no
  padding of N needed); ``launch_counts`` rises by one per launch.
"""

from __future__ import annotations

import ctypes
import os

import torch

from ..utils import cuda_lib

SOURCE = os.path.join(cuda_lib.CSRC, "fps.cu")
_ptr, _i32 = ctypes.c_void_p, ctypes.c_int
LIBRARY = cuda_lib.Library(
    "b3", SOURCE, "libfps.so",
    {"fps_launch": ((_ptr, _ptr, _ptr, _i32, _i32, _i32, _ptr), _i32)})

launch_counts = cuda_lib.launch_counter("b3")


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a·b + c of f32 tensors rounded once to f32, as a fused multiply-add
    (PyTorch has none): the product is exact in float64, the sum is taken
    with its exact error (TwoSum) and rounded to odd, from which rounding to
    f32 is correct (53 ≥ 24 + 2 bits)."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, float("inf"), float("-inf")).to(s.dtype)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def _gather(points, idx):
    return torch.gather(points, 1, idx.long()[..., None].expand(
        idx.shape + points.shape[-1:]))


def farthest_point_sampling_plain(points: torch.Tensor, k: int):
    """points [B, N, C] → (sampled [B, k, C], indices i64 [B, k])."""
    B, N, C = points.shape
    rows = torch.arange(B, device=points.device)
    idx = torch.zeros((B, k), dtype=torch.int64, device=points.device)
    min_d = torch.full((B, N), float("inf"), device=points.device)
    last = torch.zeros(B, dtype=torch.int64, device=points.device)
    for i in range(1, k):
        diff = points - points[rows, last][:, None, :]
        d = diff[..., 0] * diff[..., 0]
        for c in range(1, C):
            d = fma_f32(diff[..., c], diff[..., c], d)
        min_d = torch.minimum(min_d, d)
        last = torch.argmax(min_d, dim=1)
        idx[:, i] = last
    return _gather(points, idx), idx


def farthest_point_sampling_cuda(points: torch.Tensor, k: int) -> torch.Tensor:
    """Kernel B3: points f32 [B, N, 3] on a CUDA device → indices i32
    [B, k]."""
    if not points.is_cuda:
        raise ValueError("kernel B3 needs a CUDA tensor (the plain version is "
                         "farthest_point_sampling_plain)")
    if points.dtype != torch.float32 or points.dim() != 3 or points.shape[-1] != 3:
        raise ValueError(f"kernel B3 takes f32 [B, N, 3], got {points.dtype} "
                         f"{tuple(points.shape)}")
    B, N, _ = points.shape
    if not (1 <= k and B >= 1 and N >= 1) or N >= 2 ** 31 - 4096 or B > 2 ** 31 - 1:
        raise ValueError(f"kernel B3 cannot sample k={k} of B={B} x N={N}")
    packed = torch.nn.functional.pad(points, (0, 1)).contiguous()   # float4 rows
    mind = torch.empty((B, N), dtype=torch.float32, device=points.device)
    idx = torch.empty((B, k), dtype=torch.int32, device=points.device)
    lib = LIBRARY.load()
    err = lib.fps_launch(packed.data_ptr(), mind.data_ptr(), idx.data_ptr(), B, N,
                         int(k), cuda_lib.stream_of(points))
    cuda_lib.check_launch(err, "farthest point sampling (B3)")
    launch_counts["b3"] += 1
    return idx


def farthest_point_sampling(points: torch.Tensor, k: int):
    """points [B, N, C] → (sampled [B, k, C], indices [B, k]): kernel B3 for
    points on a CUDA device (C = 3), the plain loop for points on the CPU."""
    if points.is_cuda:
        idx = farthest_point_sampling_cuda(points, k)
        return _gather(points, idx), idx
    return farthest_point_sampling_plain(points, k)
