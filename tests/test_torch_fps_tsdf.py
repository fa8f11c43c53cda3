"""Farthest-point sampling and the depth → point cloud pipeline of the port
against the JAX package, on the CPU (the plain version of kernel B3).

* the plain FPS index for index against ``fps.farthest_point_sampling``
  (the JAX package's XLA loop) and against ``farthest_point_sampling_pallas``
  run by ``pltpu.force_tpu_interpret_mode()``, on random clouds and on
  clouds whose invalid points were zeroed into one origin cluster (ties
  everywhere: the lowest index must win);
* ``make_tsdf_spec`` tables equal; ``integrate`` to 1e-6;
* ``depth_to_pointcloud`` equal, bit for bit, on a shared depth input (the
  unprojection rounds as the JAX package's einsum, so FPS sees the same
  cloud);
* routing: CPU points never reach the kernel, the kernel refuses CPU
  tensors, and its build command and C signature."""

import re

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import _torch_vision as tv
from jax.experimental.pallas import tpu as pltpu

from partmanip_tpu.ops import fps as jfps
from partmanip_tpu.ops import raymarch as jrm
from partmanip_tpu.ops import tsdf as jtsdf
from partmanip_tpu.utils import camera as jcam
from partmanip_tpu_torch.ops import fps as tfps
from partmanip_tpu_torch.ops import tsdf as ttsdf
from partmanip_tpu_torch.utils import cuda_lib


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with tv.one_torch_thread():
        yield


def _cloud(kind, B=2, N=640):
    rs = np.random.RandomState(12)
    pts = rs.randn(B, N, 3).astype(np.float32)
    if kind == "zero_cluster":
        pts[:, rs.rand(N) < 0.6] = 0.0
    elif kind == "grid":          # exact distance ties between distinct points
        g = np.stack(np.meshgrid(*[np.arange(8.0)] * 3, indexing="ij"), -1).reshape(-1, 3)
        pts = np.tile(g[None, :N], (B, 1, 1)).astype(np.float32) * 0.1
    return pts


@pytest.mark.parametrize("kind", ["random", "zero_cluster", "grid"])
def test_plain_fps_matches_the_xla_loop(kind):
    pts = _cloud(kind, N=512)
    want_pts, want = jfps.farthest_point_sampling(jnp.asarray(pts), 96)
    got_pts, got = tfps.farthest_point_sampling(torch.as_tensor(pts), 96)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_pts.numpy(), np.asarray(want_pts))


@pytest.mark.parametrize("kind", ["random", "zero_cluster"])
def test_plain_fps_matches_the_pallas_kernel(kind):
    pts = _cloud(kind, N=640)                                   # N % 128 == 0
    with pltpu.force_tpu_interpret_mode():
        want = jfps.farthest_point_sampling_pallas(jnp.asarray(pts), 48)
    _, got = tfps.farthest_point_sampling(torch.as_tensor(pts), 48)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _round_f32(x):
    """The float32 nearest to the rational x, ties to even."""
    from fractions import Fraction
    f = np.float32(float(x))
    best = None
    for cand in (np.nextafter(f, np.float32(-np.inf)), f, np.nextafter(f, np.float32(np.inf))):
        key = (abs(Fraction(float(cand)) - x), int(np.float32(cand).view(np.int32)) & 1)
        if best is None or key < best[0]:
            best = (key, cand)
    return best[1]


def test_fma_rounds_once():
    """``fps.fma_f32`` is a fused multiply-add: a·b + c rounded once, to the
    nearest f32 (checked against exact rationals, over wide exponents)."""
    from fractions import Fraction
    rs = np.random.RandomState(9)
    a, b, c = (rs.randn(3, 3000) * 2.0 ** rs.randint(-30, 30, (3, 3000))).astype(np.float32)
    c[:1000] = -(a[:1000].astype(np.float64) * b[:1000]).astype(np.float32)  # cancellation
    got = tfps.fma_f32(*(torch.as_tensor(x) for x in (a, b, c))).numpy()
    want = np.array([_round_f32(Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z)))
                     for x, y, z in zip(a, b, c)], np.float32)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def _spec(pkg, H=36, W=64):
    lib = jtsdf if pkg == "jax" else ttsdf
    poses = jcam.gen_camera_poses([0, 0, 0.7], 1.5, num_views=3)
    return lib.make_tsdf_spec(poses, jcam.camera_intrinsics(W, H), H, W, size=2,
                              resolution=20, origin=[-1, -1, 0.05])


def test_tsdf_tables_and_integration():
    js, ts = _spec("jax"), _spec("torch")
    for name, a, b in zip(js._fields, js, ts):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a), err_msg=name)
    depth = np.random.RandomState(3).uniform(0.5, 3.0, (2, 3, 36, 64)).astype(np.float32)
    np.testing.assert_allclose(ttsdf.integrate(ts, torch.as_tensor(depth)).numpy(),
                               np.asarray(jtsdf.integrate(js, jnp.asarray(depth))),
                               atol=1e-6, rtol=0)


def test_depth_to_pointcloud_on_a_shared_depth():
    js, ts = _spec("jax"), _spec("torch")
    E = 2
    prims = jrm.ScenePrims(
        sphere_center=jnp.asarray(np.array([[[0.0, 0, 0.5], [0.3, -0.2, 0.3]]] * E, np.float32)),
        sphere_radius=jnp.full((E, 2), 0.2),
        box_pos=jnp.asarray(np.array([[[-0.4, 0.1, 0.4]]] * E, np.float32)),
        box_quat=jnp.tile(jnp.asarray([0.0, 0, 0.3827, 0.9239]), (E, 1, 1)),
        box_half=jnp.tile(jnp.asarray([0.2, 0.1, 0.3]), (E, 1, 1)),
        box_mask=jnp.ones((E, 1)), ground=True)
    depth = np.array(jrm.render_depth(prims, js.cam_pose, js.intrinsic, 36, 64))
    want = np.asarray(jtsdf.depth_to_pointcloud(js, jnp.asarray(depth), k=256))
    got = ttsdf.depth_to_pointcloud(ts, torch.as_tensor(depth), k=256).numpy()
    assert got.shape == want.shape == (E, 256, 3)
    np.testing.assert_array_equal(got, want)
    live = np.abs(got).sum(-1) > 0
    assert live.mean() > 0.9


def test_cpu_points_never_reach_the_kernel(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("the kernel was asked for on the CPU")
    monkeypatch.setattr(tfps, "farthest_point_sampling_cuda", boom)
    for name in ("load", "start"):
        monkeypatch.setattr(cuda_lib.Library, name, boom)
    before = tfps.launch_counts["b3"]
    tfps.farthest_point_sampling(torch.as_tensor(_cloud("random")), 8)
    assert tfps.launch_counts["b3"] == before
    monkeypatch.undo()
    with pytest.raises(ValueError, match="CUDA"):
        tfps.farthest_point_sampling_cuda(torch.as_tensor(_cloud("random")), 8)


def test_build_command_and_c_signature(monkeypatch):
    import ctypes
    monkeypatch.setattr(cuda_lib, "find_nvcc", lambda: "nvcc")
    cmd = tfps.LIBRARY.command()
    assert "arch=compute_90a,code=sm_90a" in cmd and cmd[-1] == tfps.SOURCE
    assert not any("fast" in c for c in cmd)
    with open(tfps.SOURCE) as f:
        src = f.read()
    # the distance is the fused multiply-add chain of the plain version
    assert "__fmaf_rn(dz, dz, __fmaf_rn(dy, dy, __fmul_rn(dx, dx)))" in src
    params = re.search(r"int fps_launch\((.*?)\)", src, re.S).group(1).split(",")
    argtypes, restype = tfps.LIBRARY.signatures["fps_launch"]
    kinds = [ctypes.c_int if p.split()[0] == "int" and "*" not in p else ctypes.c_void_p
             for p in params]
    assert list(argtypes) == kinds and restype is ctypes.c_int
