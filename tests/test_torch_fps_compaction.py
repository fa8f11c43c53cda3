"""Kernel B3's design on the CPU: why collapsing the zero cluster picks the
same indices, and how the kernel is launched.

* the plain model of the kernel: compact each row as its first phase does
  (``fps.compaction_plain``: index 0, every point that is not all ±0, the
  lowest-index all-±0 point), run the plain FPS loop on the compacted row,
  map the picks back to original indices — index for index equal to
  ``farthest_point_sampling_plain`` on the whole row, on random clouds,
  zero clusters of 60 % and 87 %, ``-0.0`` zeros, a row whose index 0 is
  not zero, an all-zero row and k above the number of distinct points;
* the launch: clusters of up to 8 CTAs a row, of the size that needs the
  fewest waves, the largest among those (6 on an H100 at the main path's
  16 rows: 96 CTAs), never a size that does not fit at all; at most
  232,448 bytes of shared memory a CTA at its N = 442,368, the whole
  compacted row on chip there;
* the C signatures, and CPU points refused by the kernel's launch."""

import ctypes
import re

import numpy as np
import pytest
import torch

import _torch_vision as tv
from partmanip_tpu_torch.ops import fps
from partmanip_tpu_torch.utils import cuda_lib


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with tv.one_torch_thread():
        yield


def _cloud(kind, B=2, N=600):
    rs = np.random.RandomState(31)
    pts = rs.randn(B, N, 3).astype(np.float32)
    if kind in ("zero60", "zero87"):
        pts[rs.rand(B, N) < (0.6 if kind == "zero60" else 0.87)] = 0.0
    elif kind == "neg_zero":               # zeros of either sign, index 0 among them
        zero = rs.rand(B, N) < 0.8
        zero[:, 0] = True
        signs = np.where(rs.rand(B, N, 3) < 0.5, -1.0, 1.0).astype(np.float32)
        pts[zero] = (0.0 * signs)[zero]
    elif kind == "index0_nonzero":
        pts[:, 1:][rs.rand(B, N - 1) < 0.87] = 0.0
    elif kind == "all_zero":
        pts[:] = 0.0
    elif kind == "few_distinct":           # 40 distinct points, repeated, and zeros
        pts = pts[:, rs.randint(0, 40, N)]
        pts[:, rs.rand(N) < 0.3] = 0.0
    return torch.as_tensor(pts)


def _compacted_fps(points, k):
    """The kernel's algorithm, plainly: FPS on each compacted row, picks
    mapped back to original indices."""
    keep = fps.compaction_plain(points)
    out = []
    for b in range(points.shape[0]):
        orig = torch.nonzero(keep[b])[:, 0]
        _, idx = fps.farthest_point_sampling_plain(points[b:b + 1, orig], k)
        out.append(orig[idx[0]])
    return torch.stack(out)


@pytest.mark.parametrize("kind,k", [
    ("random", 64), ("zero60", 64), ("zero87", 96), ("neg_zero", 64),
    ("index0_nonzero", 64), ("all_zero", 16), ("few_distinct", 64)])
def test_compacted_fps_picks_the_same_indices(kind, k):
    pts = _cloud(kind)
    keep = fps.compaction_plain(pts)
    zero = (pts == 0).all(-1)
    assert bool(keep[:, 0].all())
    assert torch.equal(keep.sum(1), (~zero).sum(1) + (zero.any(1) & ~zero[:, 0]) + zero[:, 0])
    _, want = fps.farthest_point_sampling_plain(pts, k)
    np.testing.assert_array_equal(_compacted_fps(pts, k).numpy(), want.numpy())
    if kind in ("all_zero", "few_distinct"):        # k above the distinct points
        assert int((want == 0).sum(1).min()) > 1


def test_launch_configuration():
    # the cluster size comes from the clusters that fit at once on the card
    # (cudaOccupancyMaxActiveClusters): an H100 80GB HBM3 reads these at the
    # main path's N, where clusters of 8 and 7 fit only 15 times (a cluster
    # lies within one GPC), so the 16 rows run in one wave of clusters of 6
    h100 = {1: 132, 2: 66, 3: 39, 4: 30, 5: 22, 6: 17, 7: 15, 8: 15}
    cluster = fps.pick_cluster(16, h100)                 # the main path
    assert cluster == 6
    cfg = fps.launch_config(16, 442_368, cluster)
    assert (cfg["cluster"], cfg["ctas"], cfg["threads"]) == (6, 96, 1024)
    assert cfg["smem_bytes"] <= 232_448 and cfg["dynamic_smem_bytes"] == 16 * cfg["points_on_chip"]
    # a render cloud keeps 13 % of its points: 59k a row, 9.8k a CTA, all on chip
    assert cfg["points_on_chip"] * cfg["cluster"] >= 0.15 * 442_368
    small = fps.launch_config(3, 7, 8)
    assert (small["ctas"], small["points_on_chip"]) == (24, 1)
    assert fps.launch_config(1, 10 ** 7, 8)["smem_bytes"] <= 232_448
    # the fewest waves, then the largest size
    assert fps.pick_cluster(15, h100) == 8 and fps.pick_cluster(2, h100) == 8
    assert fps.pick_cluster(200, h100) == 1
    assert fps.pick_cluster(16, {**h100, 6: 19, 7: 16}) == 7
    # a size that cannot be resident at all is never chosen
    assert fps.pick_cluster(1, {**h100, 7: 0, 8: 0}) == 6
    with pytest.raises(ValueError, match="no cluster size fits"):
        fps.pick_cluster(1, dict.fromkeys(h100, 0))


def test_c_signatures_and_cpu_refusal(monkeypatch):
    monkeypatch.setattr(cuda_lib, "find_nvcc", lambda: "nvcc")
    assert fps.LIBRARY.command()[-1] == fps.SOURCE
    with open(fps.SOURCE) as f:
        src = f.read()
    assert "cudaLaunchAttributeClusterDimension" in src and "map_shared_rank" in src
    assert f"constexpr int MAX_CLUSTER = {fps.MAX_CLUSTER};" in src
    assert f"constexpr int THREADS = {fps.THREADS};" in src
    assert f"constexpr int STATIC_SMEM = {fps.STATIC_SMEM};" in src
    for name in ("fps_launch", "fps_max_active_clusters"):
        params = re.search(rf"int {name}\((.*?)\)", src, re.S).group(1).split(",")
        argtypes, restype = fps.LIBRARY.signatures[name]
        kinds = [ctypes.c_int if p.split()[0] == "int" and "*" not in p else ctypes.c_void_p
                 for p in params]
        assert list(argtypes) == kinds and restype is ctypes.c_int, name
    with pytest.raises(ValueError, match="CUDA"):
        fps.launch(_cloud("random"), 8)
