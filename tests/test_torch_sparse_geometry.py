"""The sparse geometry of the port's ``depth_sparse`` mode and of the
surface extraction (``partmanip_tpu_torch/ops/tsdf.py`` ``sparse_voxel``,
``sparse_points``, ``extract_surface_points``, ``surface_points``) against
the JAX package's (``partmanip_tpu/ops/tsdf.py``), jitted, on the CPU.

* ``sparse_voxel``: both sides get the **same depth** (the JAX package's
  render of a seeded scene, 3 views of 36×64), so that their fused volumes
  are identical (checked bit for bit, and the near masks |tsdf| < 0.2 with
  them) before the picks are compared: the farthest-point sampling indices
  equal (the JAX package's XLA loop on its own points against the port's),
  the outputs (coordinates and TSDF values) equal bit for bit.
* ``extract_surface_points``: both sides get the same seeded volume (a
  scene of boxes and the ground, clipped); the zero crossings round as XLA
  rounds them on the CPU, so the sampled points equal bit for bit, and the
  JAX package's picks, located in the port's point list, are the port's
  indices.
* The near band's edges: |tsdf| = 0.2 is out, the largest f32 below it in;
  far voxels become voxel (0, 0, 0), which the first pick (index 0)
  already covers."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import _torch_vision as tv
from partmanip_tpu.ops import fps as jfps
from partmanip_tpu.ops import raymarch as jr
from partmanip_tpu.ops import tsdf as jt
from partmanip_tpu_torch.ops import fps as tfps
from partmanip_tpu_torch.ops import tsdf as tt
from partmanip_tpu_torch.utils import camera

K = 1024


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with tv.one_torch_thread():
        yield


def _specs(res, size=0.5, origin=(-0.25, -0.25, -0.0503), h=36, w=64):
    poses = camera.gen_camera_poses([0, 0, 0], 0.8, num_views=3)
    K_ = camera.camera_intrinsics(w, h)
    return (jt.make_tsdf_spec(poses, K_, h, w, size=size, resolution=res, origin=origin),
            tt.make_tsdf_spec(poses, K_, h, w, size=size, resolution=res, origin=origin))


def _depth(spec, seed, E=2):
    """The JAX package's exact render of seeded spheres and boxes on the
    ground, [E, 3, H, W]."""
    rs = np.random.RandomState(seed)
    S, G = 5, 3
    sc = rs.uniform(-0.12, 0.12, (E, S, 3)).astype(np.float32)
    sc[..., 2] = rs.uniform(0.04, 0.2, (E, S))
    bp = rs.uniform(-0.12, 0.12, (E, G, 3)).astype(np.float32)
    bp[..., 2] = rs.uniform(0.0, 0.12, (E, G))
    q = rs.randn(E, G, 4).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    arrays = (sc, rs.uniform(0.02, 0.06, (E, S)).astype(np.float32), bp, q,
              rs.uniform(0.02, 0.07, (E, G, 3)).astype(np.float32), np.ones((E, G), np.float32))
    fn = jax.jit(lambda a: jr.render_depth(jr.ScenePrims(*a, ground=True), spec.cam_pose,
                                           spec.intrinsic, spec.im_h, spec.im_w))
    return np.array(fn(tuple(map(jnp.asarray, arrays))))


@pytest.mark.parametrize("seed", [0, 1])
def test_sparse_voxel_matches_with_equal_indices(seed):
    jspec, tspec = _specs(24)
    depth = _depth(jspec, seed)
    jvol = np.asarray(jax.jit(lambda d: jt.integrate(jspec, d))(jnp.asarray(depth)))
    tvol = tt.integrate(tspec, torch.as_tensor(depth))
    np.testing.assert_array_equal(tvol.numpy(), jvol)          # identical volumes
    pts, flat = tt.sparse_points(tspec, tvol)
    flat_j = jvol.reshape(2, -1)
    near = (flat_j < 0.2) & (flat_j > -0.2)
    coords = np.stack(np.meshgrid(*[np.arange(24)] * 3, indexing="ij"), -1).reshape(-1, 3)
    np.testing.assert_array_equal(pts.numpy(), np.where(near[..., None], coords, 0.0))
    assert 0.02 < near.mean() < 0.5
    # the JAX package's picks (its XLA loop) and the port's (the plain loop)
    _, jidx = jax.jit(lambda p: jfps.farthest_point_sampling(p, K))(jnp.asarray(pts.numpy()))
    _, tidx = tfps.farthest_point_sampling(pts, K)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    want = np.asarray(jax.jit(lambda d: jt.sparse_voxel(jspec, d, K))(jnp.asarray(depth)))
    got = tt.sparse_voxel(tspec, torch.as_tensor(depth), K).numpy()
    assert got.shape == want.shape == (2, K, 4)
    np.testing.assert_array_equal(got, want)


def _box_volume(spec, seed, E=2):
    """A seeded scene of boxes on the ground as a TSDF volume [E, r, r, r]."""
    rs = np.random.RandomState(seed)
    w = spec.world_points
    vols = []
    for _ in range(E):
        d = w[:, 2].copy()
        for _ in range(4):
            c = rs.uniform(-0.15, 0.15, 3)
            c[2] = rs.uniform(0.02, 0.15)
            q = np.abs(w - c) - rs.uniform(0.02, 0.08, 3)
            d = np.minimum(d, np.linalg.norm(np.maximum(q, 0), axis=-1)
                           + np.minimum(q.max(-1), 0))
        vols.append(np.clip(d / spec.sdf_trunc, -1, 1))
    r = spec.resolution
    return np.stack(vols).reshape(E, r, r, r).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_extract_surface_points_matches_with_equal_indices(seed):
    jspec, tspec = _specs(32)
    vol = _box_volume(jspec, seed)
    k = 512
    want = np.asarray(jax.jit(lambda v: jt.extract_surface_points(jspec, v, k))(
        jnp.asarray(vol)))
    got = tt.extract_surface_points(tspec, torch.as_tensor(vol), k).numpy()
    assert got.shape == want.shape == (2, k, 3)
    np.testing.assert_array_equal(got, want)
    pts = tt.surface_points(tspec, torch.as_tensor(vol)).numpy()
    assert pts.shape == (2, 3 * 32 * 32 * 31, 3)
    live = (pts != 0).any(-1)
    assert (live.sum(1) > k).all()
    # both packages' picks, located among the port's points (the live
    # crossings are distinct; the first pick is index 0), against the
    # plain loop's indices on them
    _, idx = tfps.farthest_point_sampling(torch.as_tensor(pts), k)
    for e in range(2):
        rows = {tuple(p): i for i, p in enumerate(pts[e]) if live[e, i]}
        for picks in (want, got):
            np.testing.assert_array_equal(idx[e].numpy(),
                                          [0] + [rows[tuple(p)] for p in picks[e, 1:]])


def test_near_band_edges_and_the_origin():
    _, tspec = _specs(4)
    vol = torch.ones((1, 4, 4, 4))
    below = float(np.nextafter(np.float32(0.2), np.float32(0)))
    vol[0, 0, 0, 1] = 0.2                  # out
    vol[0, 0, 0, 2] = below                # in
    vol[0, 1, 2, 3] = -below               # in
    vol[0, 3, 3, 3] = -0.2                 # out
    pts, flat = tt.sparse_points(tspec, vol)
    near = (pts != 0).any(-1)[0]
    assert near.nonzero().flatten().tolist() == [2, 1 * 16 + 2 * 4 + 3]
    assert pts[0, 2].tolist() == [0, 0, 2] and pts[0, 27].tolist() == [1, 2, 3]
    out = tt.sparse_voxel(tspec, torch.ones((1, 3, 36, 64)), k=4)
    assert out.shape == (1, 4, 4) and (out[..., :3] == 0).all()
