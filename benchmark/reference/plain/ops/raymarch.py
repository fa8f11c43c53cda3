"""Batched SDF-raymarched depth cameras (PyTorch).

Counterpart of ``partmanip_tpu/ops/raymarch.py``: per-env depth images are
sphere-traced against the scene's analytic SDF (robot collision spheres +
oriented boxes + the ground plane, the primitives the contact solver uses).
The output is **positive z-depth** in the camera frame, ``far`` where a ray
misses.  Rays have z-normalized camera-frame directions, so the march
parameter is the z-depth; each step advances by the SDF along the unit ray.

* :func:`scene_sdf` — min-SDF of the scene at world points;
* :func:`prim_masks` — per-tile cone culling: which primitives each 32×32
  pixel tile of a view can see (``raymarch_tpu._prim_masks``, in f32);
* :func:`march_plain` — the plain march of given rays from given start
  depths (what kernel B2 computes, op for op: no fused multiply-adds, the
  box distance in the kernel's component form, the same done / hit tests).
  With ``cull`` (the default) a ray's scene distance is the minimum over
  the primitives kept for its tile and the ground, as in the TPU kernel;
  without, over every live primitive, as in the JAX package's XLA path;
* :func:`render_depth` — the entry point.  Prims on a CUDA device go to
  kernel B2 (``ops/raymarch_cuda.py``), prims on the CPU to
  :func:`march_plain`; both through the same ray table, the same masks and
  the same coarse-to-fine routine.

Culling changes the result, not only the work: a primitive that a ray never
hits still shortens its sphere-tracing steps, so a culled march stops at
other depths than an unculled one (up to 0.22 m where both hit on a 96×128
render; ROADMAP Queue C).  The JAX package renders with culling on a
TPU and without it on the CPU.

The renderer's extras, in the JAX package's operations (``linalg.norm``
and ``quat_rotate_inverse``, not the kernel's component form):

* :func:`scene_sdf_seg` — the scene distance and the segment id of the
  nearest surface (0 ground, 1 robot, 2 + g box g);
* :func:`scene_normal` — analytic normals at points of known segment;
* :func:`render_rgb` — Lambertian shading of per-segment albedo
  (:data:`PALETTE`) at the hit points of a depth image (by default
  :func:`render_depth`'s, so kernel B2's on the GPU); the shading pass is
  plain PyTorch, as the JAX package computes it in XLA;
* :func:`render_depth_seg` — depth and segment images from a plain,
  unculled march of its own, as the JAX package's.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import rotations as rot

# rays per chunk of the plain march: keeps its [E, chunk, G] temporaries
# near 64 MB at full width
_CHUNK_ELEMS = 1 << 24


class ScenePrims(NamedTuple):
    """Analytic scene primitives for one batch of envs.

    sphere_*: [E, S]; box_*: [E, G]; masks are 1.0 for live prims.
    """

    sphere_center: torch.Tensor   # [E, S, 3]
    sphere_radius: torch.Tensor   # [E, S]
    box_pos: torch.Tensor         # [E, G, 3]
    box_quat: torch.Tensor        # [E, G, 4]  xyzw
    box_half: torch.Tensor        # [E, G, 3]
    box_mask: torch.Tensor        # [E, G]
    ground: bool = True


class RayTable(NamedTuple):
    """The rays of one rig at one image size (``raymarch_cuda.ray_table``)."""

    dirs: torch.Tensor            # f32 [V, 3, H·W] world directions, row-major pixels
    origins: torch.Tensor         # f32 [V, 3]
    axes: torch.Tensor            # f32 [V, T, 3] unit axis of each tile's ray cone
    cos_t: torch.Tensor           # f32 [V, T] cos of the cone's half-angle
    tile_of: torch.Tensor         # i64 [H·W] the 32×32 tile of each pixel
    im_h: int
    im_w: int


def _sphere_dist(prims: ScenePrims, px, py, pz):
    """[E, N] points (components) → [E, N, S] sphere distances."""
    c = prims.sphere_center[:, None]                      # [E, 1, S, 3]
    rx = px[..., None] - c[..., 0]
    ry = py[..., None] - c[..., 1]
    rz = pz[..., None] - c[..., 2]
    return torch.sqrt(rx * rx + ry * ry + rz * rz) - prims.sphere_radius[:, None]


def _box_dist(prims: ScenePrims, px, py, pz):
    """[E, N] points → [E, N, G] box distances, dead boxes at 1e6.  The
    conjugate-quaternion rotation is written out per component (the form of
    the TPU kernel, ``raymarch_tpu._march_kernel``, and of kernel B2)."""
    b = prims.box_pos[:, None]                            # [E, 1, G, 3]
    q = prims.box_quat[:, None]
    h = prims.box_half[:, None]
    qx, qy, qz, qw = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    rx = px[..., None] - b[..., 0]
    ry = py[..., None] - b[..., 1]
    rz = pz[..., None] - b[..., 2]
    tx = 2.0 * (-qy * rz + qz * ry)
    ty = 2.0 * (-qz * rx + qx * rz)
    tz = 2.0 * (-qx * ry + qy * rx)
    lx = rx + qw * tx + (-qy * tz + qz * ty)
    ly = ry + qw * ty + (-qz * tx + qx * tz)
    lz = rz + qw * tz + (-qx * ty + qy * tx)
    ax = torch.abs(lx) - h[..., 0]
    ay = torch.abs(ly) - h[..., 1]
    az = torch.abs(lz) - h[..., 2]
    ox = torch.clamp(ax, min=0.0)
    oy = torch.clamp(ay, min=0.0)
    oz = torch.clamp(az, min=0.0)
    d_out = torch.sqrt(ox * ox + oy * oy + oz * oz)
    d_in = torch.clamp(torch.maximum(torch.maximum(ax, ay), az), max=0.0)
    d = d_out + d_in
    return torch.where(prims.box_mask[:, None] > 0, d, torch.full_like(d, 1e6))


def _scene_dist(prims: ScenePrims, px, py, pz, keep=None):
    """[E, N] points → [E, N] scene distance; ``keep`` [E, N, S+G] bool
    drops the primitives it is False for (the ground is never dropped)."""
    d = torch.full_like(px, 1e6)
    S = prims.sphere_radius.shape[1]
    if prims.sphere_center is not None and S:
        ds = _sphere_dist(prims, px, py, pz)
        if keep is not None:
            ds = torch.where(keep[..., :S], ds, torch.full_like(ds, 1e6))
        d = torch.minimum(d, ds.amin(-1))
    if prims.box_pos is not None and prims.box_pos.shape[1]:
        db = _box_dist(prims, px, py, pz)
        if keep is not None:
            db = torch.where(keep[..., S:], db, torch.full_like(db, 1e6))
        d = torch.minimum(d, db.amin(-1))
    if prims.ground:
        d = torch.minimum(d, pz)
    return d


def _live(prims: ScenePrims) -> torch.Tensor:
    """[E, S+G] bool: every sphere, the boxes whose mask is set."""
    return torch.cat([torch.ones_like(prims.sphere_radius), prims.box_mask], dim=1) > 0


def prim_masks(prims: ScenePrims, origins: torch.Tensor, axes: torch.Tensor,
               cos_t: torch.Tensor, far: float) -> torch.Tensor:
    """Which primitives each tile can see: bool [E, V, T, S+G] (spheres,
    then boxes), the f32 counterpart of ``raymarch_tpu._prim_masks``
    (:111-140) in its order of operations.  A primitive is kept when its
    bounding sphere (a box's: radius ‖half‖) touches the tile's ray cone,
    is not behind the camera or beyond ``far``, or contains the camera;
    dead boxes (``box_mask`` 0) are never kept.

    origins [V, 3], axes [V, T, 3], cos_t [V, T]."""
    hb = prims.box_half
    centers = torch.cat([prims.sphere_center, prims.box_pos], dim=1)           # [E, P, 3]
    r_box = torch.sqrt(hb[..., 0] * hb[..., 0] + hb[..., 1] * hb[..., 1]
                       + hb[..., 2] * hb[..., 2])
    radius = torch.cat([prims.sphere_radius, r_box], dim=1)                   # [E, P]

    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))            # [V, T]
    vec = centers[:, None, None] - origins[None, :, None, None]               # [E, V, 1, P, 3]
    ax = axes[None, :, :, None]                                               # [1, V, T, 1, 3]
    a = (vec[..., 0] * ax[..., 0] + vec[..., 1] * ax[..., 1]
         + vec[..., 2] * ax[..., 2])                                          # [E, V, T, P]
    d2 = vec[..., 0] * vec[..., 0] + vec[..., 1] * vec[..., 1] + vec[..., 2] * vec[..., 2]
    q = torch.sqrt(torch.clamp(d2 - a * a, min=0.0))
    r = radius[:, None, None]
    outside = (q * cos_t[None, :, :, None] - a * sin_t[None, :, :, None]) > r
    behind = a < -r
    too_far = (a - r) > far
    contains_apex = d2 <= r * r
    return (~(outside | behind | too_far) | contains_apex) & _live(prims)[:, None, None]


def tile_masks(prims: ScenePrims, rays: RayTable, far: float,
               cull: bool = True) -> torch.Tensor:
    """The primitives each tile's march evaluates, bool [E, V, T, S+G]:
    :func:`prim_masks` with ``cull``, else every live primitive."""
    if cull:
        return prim_masks(prims, rays.origins, rays.axes, rays.cos_t, far)
    V, T = rays.cos_t.shape
    return _live(prims)[:, None, None].expand(-1, V, T, -1)


def march_plain(prims: ScenePrims, rays: RayTable, t0, n_steps: int, far: float,
                eps: float, cull: bool = True, count_evals: bool = False):
    """Sphere-trace rays from per-ray start depths: the plain version of
    kernel B2.

    ``rays`` a :class:`RayTable` (directions z-normalized in the camera
    frame), t0 a float or [E, V, N]  →  depth [E, V, N] (``far`` on a miss).
    Each ray evaluates the primitives :func:`tile_masks` keeps for its tile
    (``cull``).  With ``count_evals`` also returns the work each ray needs
    in the kernel, i64 [E, V, N, 3]: its scene evaluations (its march until
    done, plus the hit test), and the sphere and the box distances those
    evaluate."""
    E, S = prims.sphere_radius.shape
    V, _, N = rays.dirs.shape
    dev = rays.dirs.device
    masks = tile_masks(prims, rays, far, cull)
    out = torch.empty((E, V, N), dtype=torch.float32, device=dev)
    if count_evals:
        evals = torch.empty((E, V, N, 3), dtype=torch.int64, device=dev)
    G = prims.box_pos.shape[1] if prims.box_pos is not None else 0
    chunk = max(1, _CHUNK_ELEMS // max(1, E * max(G, S, 1)))
    for v in range(V):
        ox, oy, oz = (rays.origins[v, i] for i in range(3))
        for a in range(0, N, chunk):
            b = min(N, a + chunk)
            dx, dy, dz = (rays.dirs[v, i, a:b][None] for i in range(3))   # [1, n]
            keep = masks[:, v, rays.tile_of[a:b]]                            # [E, n, S+G]
            inv = 1.0 / torch.sqrt(dx * dx + dy * dy + dz * dz)
            if isinstance(t0, torch.Tensor):
                tz = t0[:, v, a:b].clone()
            else:
                tz = torch.full((E, b - a), float(t0), device=dev)
            alive = torch.ones_like(tz, dtype=torch.bool)
            n_eval = torch.zeros_like(tz, dtype=torch.int64)
            for _ in range(n_steps):
                dist = _scene_dist(prims, ox + tz * dx, oy + tz * dy, oz + tz * dz, keep)
                n_eval += alive.to(torch.int64)
                done = (dist < eps) | (tz > far)
                alive &= ~done
                tz = torch.where(done, tz, tz + torch.clamp(dist, min=0.0) * inv)
            dist = _scene_dist(prims, ox + tz * dx, oy + tz * dy, oz + tz * dz, keep)
            hit = (dist < 10 * eps) & (tz <= far)
            out[:, v, a:b] = torch.where(hit, tz, torch.full_like(tz, far))
            if count_evals:
                n_eval += 1
                evals[:, v, a:b, 0] = n_eval
                evals[:, v, a:b, 1] = n_eval * keep[..., :S].sum(-1)
                evals[:, v, a:b, 2] = n_eval * keep[..., S:].sum(-1)
    return (out, evals) if count_evals else out


def render_depth(prims: ScenePrims, cam_pose, intrinsic, im_h: int, im_w: int,
                 n_steps: int = 40, far: float = 100.0, eps: float = 1e-3,
                 coarse_to_fine: bool = False, cull: bool = True) -> torch.Tensor:
    """Sphere-traced depth images [E, V, H, W] (positive z-depth).

    cam_pose [V, 4, 4] world-from-camera (OpenCV convention) and intrinsic
    [3, 3] are numpy.  Prims on a CUDA device launch kernel B2, prims on the
    CPU take :func:`march_plain`.  ``coarse_to_fine`` (with H and W
    multiples of 4) marches a quarter-resolution pre-pass and refines at
    full resolution from a conservative per-ray start, and ``cull`` skips
    the primitives outside each tile's view cone, both as the JAX package's
    TPU kernel does (its XLA path does neither)."""
    from . import raymarch_cuda
    return raymarch_cuda.render_with(march_plain, prims, cam_pose, intrinsic,
                                     im_h, im_w, n_steps=n_steps, far=far,
                                     eps=eps, coarse_to_fine=coarse_to_fine,
                                     cull=cull)


# ----------------------------------------------------------------------
# the renderer's extras: segments, normals, RGB
# ----------------------------------------------------------------------

# albedo of each segment: ground, robot, then a repeating box palette
PALETTE = np.array([
    [0.55, 0.55, 0.58],   # 0 ground
    [0.92, 0.92, 0.95],   # 1 robot
    [0.65, 0.45, 0.28], [0.30, 0.45, 0.70], [0.45, 0.62, 0.35],
    [0.70, 0.55, 0.30], [0.55, 0.35, 0.55], [0.35, 0.55, 0.55],
], np.float32)


