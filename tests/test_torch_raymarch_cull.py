"""Per-tile cone culling in the port's depth renderer against the JAX
package's TPU kernel, on the CPU (the plain version of kernel B2).

The TPU kernel (``raymarch_tpu._march_kernel``) evaluates, for the rays of
a 32×32-pixel tile, only the primitives whose bounding sphere touches the
tile's ray cone.  That changes the result: a primitive that a ray never
hits still shortens its sphere-tracing steps.  So the port culls as the
TPU kernel does (``cull=True``, the default) and keeps the unculled march
of the JAX package's XLA path behind ``cull=False``.

* the tile cone tables equal ``raymarch_tpu._tile_rays``'s ``axes`` /
  ``cos_t`` exactly (a 36×64 rig and a 72×128 rig with a ragged last tile
  row);
* ``raymarch.prim_masks`` equals ``raymarch_tpu._prim_masks`` exactly;
* the culled render against ``render_depth_tpu(interpret=True)``, exact and
  coarse-to-fine, on 12 spheres and 10 rotated boxes (2 dead) at 96×128,
  where culling keeps a fifth of the (tile, primitive) pairs: no hit flip,
  at most 1e-5 m where both hit, on every ray;
* the unculled render against ``raymarch.render_depth`` (XLA) at the same
  bound, but for rays at the stopping threshold: a ray whose scene distance
  at one step lies within rounding of ``eps`` may stop one step earlier or
  later in the other implementation (their f32 arithmetic differs in the
  last bit: XLA on the CPU contracts multiply-adds); at most 2 rays may be
  off by more than 1e-5, each by at most one step (≤ eps) and within 1e-5
  of the port's march with ``eps`` moved by 1e-6 — and the unculled render
  differs from the TPU kernel's on most of the image, which is the fault
  the culling repairs (ROADMAP Queue C)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import _torch_vision as tv

from partmanip_tpu.ops import raymarch as jrm
from partmanip_tpu.ops import raymarch_tpu
from partmanip_tpu.utils import camera as jcam
from partmanip_tpu_torch.ops import raymarch as trm
from partmanip_tpu_torch.ops import raymarch_cuda

H, W = 96, 128
FAR, EPS = 100.0, 1e-3
BOTH_HIT_TOL = 1e-5
EDGE = 1e-6                # how far eps moves to show a ray at the threshold
MAX_EDGE_RAYS = 2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with tv.one_torch_thread():
        yield


def _scene_arrays(seed=0, S=12, G=10):
    """S spheres and G rotated boxes (2 dead) over the ground, in front of
    the rig."""
    rs = np.random.RandomState(seed)
    q = rs.randn(1, G, 4)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    mask = np.ones((1, G))
    mask[0, rs.choice(G, 2, replace=False)] = 0.0
    a = dict(
        sphere_center=np.concatenate([rs.uniform(-0.3, 0.3, (1, S, 2)),
                                      rs.uniform(0.02, 0.3, (1, S, 1))], -1),
        sphere_radius=rs.uniform(0.02, 0.06, (1, S)),
        box_pos=np.concatenate([rs.uniform(-0.3, 0.3, (1, G, 2)),
                                rs.uniform(0.03, 0.25, (1, G, 1))], -1),
        box_quat=q, box_half=rs.uniform(0.01, 0.06, (1, G, 3)), box_mask=mask)
    return {k: v.astype(np.float32) for k, v in a.items()}


def _prims(pkg, arrays):
    if pkg == "jax":
        return jrm.ScenePrims(**{k: jnp.asarray(v) for k, v in arrays.items()}, ground=True)
    return trm.ScenePrims(**{k: torch.as_tensor(v) for k, v in arrays.items()}, ground=True)


def _rig(h, w):
    poses = jcam.gen_camera_poses([0, 0, 0.1], radius=0.8, num_views=3)
    return poses, jcam.camera_intrinsics(w, h)


def _assert_same_depth(got, want, render=None):
    """No hit flip; within BOTH_HIT_TOL where both hit.  With ``render``
    (the port's render at a given ``eps``), up to MAX_EDGE_RAYS rays at the
    stopping threshold may be one step (≤ eps) apart, and only if moving
    ``eps`` by EDGE brings them within BOTH_HIT_TOL."""
    assert got.shape == want.shape
    hit_g, hit_w = got < FAR, want < FAR
    assert int((hit_g != hit_w).sum()) == 0
    both = hit_g & hit_w
    assert both.mean() > 0.5
    err = np.abs(got - want)
    off = both & (err > BOTH_HIT_TOL)
    assert int(off.sum()) <= (0 if render is None else MAX_EDGE_RAYS), err[both].max()
    if off.any():
        assert err[off].max() <= EPS * (1 + 1e-3), err[off].max()
        moved = np.minimum(np.abs(render(EPS - EDGE) - want), np.abs(render(EPS + EDGE) - want))
        assert moved[off].max() <= BOTH_HIT_TOL, moved[off]


@pytest.mark.parametrize("h,w", [(36, 64), (72, 128)])
def test_tile_cone_tables_equal_the_tpu_wrappers(h, w):
    poses, intr = _rig(h, w)
    want = raymarch_tpu._tile_rays(np.asarray(poses), np.asarray(intr), h, w)
    rays = raymarch_cuda.ray_table(poses, intr, h, w, "cpu")
    T = -(-h // 32) * -(-w // 32)
    assert rays.axes.shape == (3, T, 3) and rays.cos_t.shape == (3, T)
    np.testing.assert_array_equal(rays.axes.numpy(), want["axes"])
    np.testing.assert_array_equal(rays.cos_t.numpy(), want["cos_t"])
    np.testing.assert_array_equal(rays.origins.numpy(), want["origins"])
    ii, jj = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    np.testing.assert_array_equal(rays.tile_of.numpy(),
                                  ((ii // 32) * -(-w // 32) + jj // 32).reshape(-1))


@pytest.mark.parametrize("h,w,seed", [(36, 64, 0), (72, 128, 1), (96, 128, 0)])
def test_prim_masks_equal_the_tpu_wrappers(h, w, seed):
    poses, intr = _rig(h, w)
    arrays = _scene_arrays(seed)
    arrays = {k: np.concatenate([v, v[:, ::-1]]) for k, v in arrays.items()}   # 2 envs
    jp = _prims("jax", arrays)
    sph = jnp.concatenate([jp.sphere_center, jp.sphere_radius[..., None]], -1)
    box = jnp.concatenate([jp.box_pos, jp.box_quat, jp.box_half, jp.box_mask[..., None]], -1)
    r = raymarch_tpu._tile_rays(np.asarray(poses), np.asarray(intr), h, w)
    want = np.asarray(raymarch_tpu._prim_masks(
        sph, box, jnp.asarray(r["origins"]), jnp.asarray(r["axes"]),
        jnp.asarray(r["cos_t"]), FAR))
    rays = raymarch_cuda.ray_table(poses, intr, h, w, "cpu")
    got = trm.prim_masks(_prims("torch", arrays), rays.origins, rays.axes, rays.cos_t, FAR)
    assert got.dtype == torch.bool and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want.astype(bool))
    dead = torch.as_tensor(arrays["box_mask"] == 0)[:, None, None]   # [E, 1, 1, G]
    assert not (got[..., 12:] & dead).any()
    assert 0.05 < got.float().mean() < 0.5                       # culling at work


@pytest.mark.parametrize("c2f", [False, True], ids=["exact", "coarse_to_fine"])
def test_culled_render_matches_the_pallas_kernel(c2f):
    poses, intr = _rig(H, W)
    poses = poses[:1]
    arrays = _scene_arrays()
    tp = _prims("torch", arrays)
    want = np.asarray(raymarch_tpu.render_depth_tpu(
        _prims("jax", arrays), poses, intr, H, W, interpret=True, coarse_to_fine=c2f))

    def render(eps=EPS, cull=True):
        return trm.render_depth(tp, poses, intr, H, W, eps=eps, coarse_to_fine=c2f,
                                cull=cull).numpy()

    kept = trm.tile_masks(tp, raymarch_cuda.ray_table(poses, intr, H, W, "cpu"), FAR)
    assert float(kept.float().mean()) < 0.5
    _assert_same_depth(render(), want)
    # without culling the march is another function: most pixels differ
    assert (np.abs(render(cull=False) - want) > 1e-4).mean() > (0.3 if not c2f else 0.01)


def test_unculled_render_matches_the_xla_renderer():
    poses, intr = _rig(H, W)
    poses = poses[:1]
    arrays = _scene_arrays()
    tp = _prims("torch", arrays)
    want = np.asarray(jrm.render_depth(_prims("jax", arrays), poses, intr, H, W))
    _assert_same_depth(trm.render_depth(tp, poses, intr, H, W, cull=False).numpy(), want,
                       lambda eps: trm.render_depth(tp, poses, intr, H, W, eps=eps,
                                                    cull=False).numpy())
