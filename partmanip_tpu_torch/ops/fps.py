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
  padding of N needed); ``launch_counts`` rises by one per launch.  Each
  row runs on a thread-block cluster of up to :data:`MAX_CLUSTER` CTAs
  (:func:`launch_config`; :func:`pick_cluster` takes the size that needs
  the fewest waves on this card), whose first phase collapses the row's
  all-zero points into the lowest-index one (:func:`compaction_plain` is
  that phase's plain version): they tie at every iteration, so the picks
  are the same indices;
* :func:`launch` — the launch itself, which also returns the compacted
  length of each row.
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
    {"fps_launch": ((_ptr, _ptr, _ptr, _ptr, _ptr, _ptr, _i32, _i32, _i32, _i32, _i32, _ptr),
                    _i32),
     "fps_max_active_clusters": ((_i32, _i32, _ptr), _i32)})
MAX_CLUSTER = 8               # CTAs a row at most: the portable cluster size
THREADS = 1024                # threads a CTA
SMEM_LIMIT = 232_448          # shared memory a block may use on sm_90 (227 KB)
STATIC_SMEM = 1024            # bound of the kernel's static shared memory (fps.cu)
POINT_BYTES = 16              # x, y, z and the running minimum

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


def compaction_plain(points: torch.Tensor) -> torch.Tensor:
    """The points kernel B3 keeps of each row, bool [B, N]: index 0, every
    point that is not all ±0, and the lowest-index all-±0 point.  The
    kernel's compacted row is ``points[b, keep[b]]`` in this order."""
    B, N, _ = points.shape
    zero = (points == 0).all(-1)
    first = torch.arange(N, device=points.device) == 0
    keep = ~zero | first
    lowest = torch.where(zero.any(1), zero.int().argmax(1), 0)
    keep[torch.arange(B, device=points.device), lowest] = True
    return keep


def launch_config(B: int, N: int, cluster: int) -> dict:
    """Kernel B3's launch for B rows of N points on clusters of ``cluster``
    CTAs a row; each CTA keeps up to ``points_on_chip`` points of its share
    of the compacted row in shared memory (a row's compacted length is
    known on the device only, so the share is bounded by N / cluster)."""
    cap_max = (SMEM_LIMIT - STATIC_SMEM) // POINT_BYTES
    cap = min(cap_max, -(-N // cluster))
    return {"cluster": cluster, "ctas": B * cluster, "threads": THREADS,
            "points_on_chip": cap, "dynamic_smem_bytes": POINT_BYTES * cap,
            "smem_bytes": POINT_BYTES * cap + STATIC_SMEM}


def max_active_clusters(N: int, cluster: int) -> int:
    """How many of kernel B3's clusters of ``cluster`` CTAs fit on the card
    at once at a row length of N (``cudaOccupancyMaxActiveClusters``; a
    cluster must fit within one GPC)."""
    out = ctypes.c_int(0)
    cap = launch_config(1, N, cluster)["points_on_chip"]
    err = LIBRARY.load().fps_max_active_clusters(cluster, cap, ctypes.byref(out))
    cuda_lib.check_launch(err, "farthest point sampling (B3) occupancy query")
    return out.value


def pick_cluster(B: int, resident: dict) -> int:
    """The cluster size for B rows, given ``resident`` {size: clusters that
    fit at once}: of the sizes that fit at all, the fewest waves, then the
    largest size (the least work a CTA)."""
    fits = [c for c in resident if resident[c] > 0]
    if not fits:
        raise ValueError(f"kernel B3: no cluster size fits on this device ({resident})")
    return min(fits, key=lambda c: (-(-B // resident[c]), -c))


_CLUSTER_CACHE: dict = {}


def cluster_for(B: int, N: int, device) -> int:
    """:func:`pick_cluster` over the sizes 1..MAX_CLUSTER on ``device``,
    cached per (B, N, device)."""
    key = (B, N, str(device))
    if key not in _CLUSTER_CACHE:
        with torch.cuda.device(device):
            resident = {c: max_active_clusters(N, c) for c in range(1, MAX_CLUSTER + 1)}
        _CLUSTER_CACHE[key] = pick_cluster(B, resident)
    return _CLUSTER_CACHE[key]


def launch(points: torch.Tensor, k: int, cluster: int = None, trace: torch.Tensor = None):
    """Kernel B3: points f32 [B, N, 3] on a CUDA device → (indices i32
    [B, k], compacted length of each row i32 [B]), on clusters of
    :func:`cluster_for` CTAs a row, or of ``cluster`` (``chip_smoke.py``
    holds and times the kernel on several sizes).  ``trace``, i64
    [B · cluster, 3] on the same device, receives each CTA's SM and its
    start and end on the card's global timer (ns)."""
    if not points.is_cuda:
        raise ValueError("kernel B3 needs a CUDA tensor (the plain version is "
                         "farthest_point_sampling_plain)")
    if points.dtype != torch.float32 or points.dim() != 3 or points.shape[-1] != 3:
        raise ValueError(f"kernel B3 takes f32 [B, N, 3], got {points.dtype} "
                         f"{tuple(points.shape)}")
    B, N, _ = points.shape
    if not (1 <= k < 2 ** 31 and B >= 1 and N >= 1) or N >= 2 ** 31 - 4096 \
            or B * MAX_CLUSTER > 2 ** 31 - 1:
        raise ValueError(f"kernel B3 cannot sample k={k} of B={B} x N={N}")
    if cluster is None:
        cluster = cluster_for(B, N, points.device)
    if not 1 <= cluster <= MAX_CLUSTER:
        raise ValueError(f"kernel B3 takes clusters of 1 to {MAX_CLUSTER} CTAs, not {cluster}")
    cfg = launch_config(B, N, cluster)
    if trace is not None and (trace.dtype != torch.int64 or trace.device != points.device
                              or tuple(trace.shape) != (cfg["ctas"], 3)
                              or not trace.is_contiguous()):
        raise ValueError(f"kernel B3's trace is i64 [{cfg['ctas']}, 3] on {points.device}")
    points = points.contiguous()
    dev = points.device
    comp = torch.empty((B, N, 4), dtype=torch.float32, device=dev)
    mind = torch.empty((B, N), dtype=torch.float32, device=dev)
    idx = torch.empty((B, k), dtype=torch.int32, device=dev)
    counts = torch.empty(B, dtype=torch.int32, device=dev)
    lib = LIBRARY.load()
    err = lib.fps_launch(points.data_ptr(), comp.data_ptr(), mind.data_ptr(), idx.data_ptr(),
                         counts.data_ptr(), None if trace is None else trace.data_ptr(),
                         B, N, int(k), cluster, cfg["points_on_chip"],
                         cuda_lib.stream_of(points))
    cuda_lib.check_launch(err, "farthest point sampling (B3)")
    launch_counts["b3"] += 1
    return idx, counts


def farthest_point_sampling_cuda(points: torch.Tensor, k: int) -> torch.Tensor:
    """Kernel B3: points f32 [B, N, 3] on a CUDA device → indices i32
    [B, k]."""
    return launch(points, k)[0]


def farthest_point_sampling(points: torch.Tensor, k: int):
    """points [B, N, C] → (sampled [B, k, C], indices [B, k]): kernel B3 for
    points on a CUDA device (C = 3), the plain loop for points on the CPU."""
    if points.is_cuda:
        idx = farthest_point_sampling_cuda(points, k)
        return _gather(points, idx), idx
    return farthest_point_sampling_plain(points, k)
