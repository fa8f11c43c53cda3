"""The renderer's extras in the port (``partmanip_tpu_torch/ops/raymarch.py``
``scene_sdf_seg``, ``scene_normal``, ``render_rgb``, ``render_depth_seg``)
against the JAX package's (``partmanip_tpu/ops/raymarch.py``), jitted, on
seeded scenes of spheres, oriented boxes (one of them dead) and the ground,
one view of 36×64.

``render_rgb`` is fed the **same depth** on both sides (the JAX package's
own render), so that both shade the same hit points; its segment ids are
held pixel for pixel there.  Tolerances:
* scene distance 1e-6 m (norms and rotations in the same operations, XLA's
  contractions aside), segment ids equal at every point;
* normals 3e-5 (a unit vector through two normalisations), RGB 3e-5
  (albedo ≤ 0.95 times the normal's shading);
* ``render_depth_seg``: no pixel hits in one package and misses in the
  other, depth within 1e-5 m where both hit, segment ids equal."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import _torch_vision as tv
from partmanip_tpu.ops import raymarch as jr
from partmanip_tpu_torch.ops import raymarch as tr
from partmanip_tpu_torch.utils import camera

H, W = 36, 64
DIST_TOL, NORMAL_TOL, RGB_TOL, DEPTH_TOL = 1e-6, 3e-5, 3e-5, 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with tv.one_torch_thread():
        yield


def _scene(seed, E=2, S=6, G=4):
    """Seeded spheres and boxes above the ground; box G − 1 of env 0 dead."""
    rs = np.random.RandomState(seed)
    sc = rs.uniform(-0.2, 0.2, (E, S, 3)).astype(np.float32)
    sc[..., 2] = rs.uniform(0.05, 0.3, (E, S))
    sr = rs.uniform(0.03, 0.08, (E, S)).astype(np.float32)
    bp = rs.uniform(-0.2, 0.2, (E, G, 3)).astype(np.float32)
    bp[..., 2] = rs.uniform(0.0, 0.2, (E, G))
    q = rs.randn(E, G, 4).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    bh = rs.uniform(0.03, 0.1, (E, G, 3)).astype(np.float32)
    bm = np.ones((E, G), np.float32)
    bm[0, -1] = 0.0
    return sc, sr, bp, q, bh, bm


def _prims(arrays):
    return (lambda a: jr.ScenePrims(*a, ground=True),
            tr.ScenePrims(*map(torch.as_tensor, arrays), ground=True))


def _rig():
    poses = camera.gen_camera_poses([0, 0, 0], 0.8, num_views=1)
    return poses, camera.camera_intrinsics(W, H)


def _jax_depth(arrays):
    poses, K = _rig()
    jp, _ = _prims(arrays)
    fn = jax.jit(lambda a: jr.render_depth_seg(jp(a), poses, K, H, W))
    return [np.array(x) for x in fn(tuple(map(jnp.asarray, arrays)))]


def _hit_points(depth):
    """The world points of a [E, 1, H, W] depth image, [E, H·W, 3] (the
    port's ray table, which both extras use)."""
    poses, K = _rig()
    dirs, origins = tr._camera_rays(poses, K, H, W, "cpu")
    tz = torch.as_tensor(depth).reshape(depth.shape[0], -1)
    return origins[0] + tz[..., None] * dirs[0][None]


@pytest.mark.parametrize("seed", [0, 1])
def test_scene_sdf_seg_and_normals_match(seed):
    """At the hit points of the JAX render and at jittered points around
    them (which reach the spheres' and boxes' insides and the ground)."""
    arrays = _scene(seed)
    jp, tp = _prims(arrays)
    depth, _ = _jax_depth(arrays)
    p = _hit_points(depth)
    p = torch.cat([p, p + torch.as_tensor(np.random.RandomState(seed).normal(
        0, 0.01, p.shape).astype(np.float32))], dim=1)
    ja = tuple(map(jnp.asarray, arrays))
    jd, js = jax.jit(lambda a, x: jr.scene_sdf_seg(jp(a), x))(ja, jnp.asarray(p.numpy()))
    td, ts = tr.scene_sdf_seg(tp, p)
    js = np.asarray(js)
    assert ts.dtype == torch.int32
    np.testing.assert_array_equal(ts.numpy(), js)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=DIST_TOL)
    assert set(np.unique(js)) >= {0, 1, 2, 3} and not (js == 2 + 3).all()
    jn = jax.jit(lambda a, x, s: jr.scene_normal(jp(a), x, s))(ja, jnp.asarray(p.numpy()),
                                                             jnp.asarray(js))
    tn = tr.scene_normal(tp, p, ts)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=0, atol=NORMAL_TOL)
    np.testing.assert_allclose(np.linalg.norm(tn.numpy(), axis=-1), 1.0, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_render_rgb_from_the_same_depth(seed):
    arrays = _scene(seed)
    jp, tp = _prims(arrays)
    poses, K = _rig()
    depth, _ = _jax_depth(arrays)
    want = np.asarray(jax.jit(lambda a, d: jr.render_rgb(jp(a), poses, K, H, W, depth=d))(
        tuple(map(jnp.asarray, arrays)), jnp.asarray(depth)))
    got = tr.render_rgb(tp, poses, K, H, W, depth=torch.as_tensor(depth)).numpy()
    assert got.shape == want.shape == (2, 1, H, W, 3) and got.dtype == np.float32
    # the segment of every pixel, from the same hit points
    p = _hit_points(depth)
    _, ts = tr.scene_sdf_seg(tp, p)
    _, js = jax.jit(lambda a, x: jr.scene_sdf_seg(jp(a), x))(
        tuple(map(jnp.asarray, arrays)), jnp.asarray(p.numpy()))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_allclose(got, want, rtol=0, atol=RGB_TOL)
    hit = depth[:, 0] < 100.0 * 0.99
    assert hit.mean() > 0.1 and (got[:, 0][~hit] == 0).all() and (got[:, 0][hit] > 0).any()


def test_render_depth_seg_matches():
    arrays = _scene(2)
    poses, K = _rig()
    jd, js = _jax_depth(arrays)
    _, tp = _prims(arrays)
    td, ts = tr.render_depth_seg(tp, poses, K, H, W)
    td, ts = td.numpy(), ts.numpy()
    assert td.shape == ts.shape == (2, 1, H, W) and ts.dtype == np.int32
    both = (td < 100.0) & (jd < 100.0)
    assert ((td < 100.0) != (jd < 100.0)).sum() == 0 and both.mean() > 0.1
    np.testing.assert_allclose(td[both], jd[both], rtol=0, atol=DEPTH_TOL)
    np.testing.assert_array_equal(ts, js)
    assert (ts[~both] == 0).all()


def test_render_rgb_takes_its_depth_from_render_depth():
    """Without ``depth`` the port shades the hit points of
    ``raymarch.render_depth`` (exact, culled): kernel B2 for prims on a
    CUDA device, the plain march here."""
    arrays = _scene(3)
    _, tp = _prims(arrays)
    poses, K = _rig()
    depth = tr.render_depth(tp, poses, K, H, W)
    got = tr.render_rgb(tp, poses, K, H, W)
    torch.testing.assert_close(got, tr.render_rgb(tp, poses, K, H, W, depth=depth),
                               rtol=0, atol=0)
    np.testing.assert_array_equal(tr.PALETTE, jr._PALETTE)
