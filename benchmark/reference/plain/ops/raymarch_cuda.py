"""The ray tables of kernel B2's camera and its coarse-to-fine routine,
around the plain march (the kernel itself is the program's).

* :func:`ray_table` — per view the row-major world ray directions
  ``[V, 3, H·W]`` and origins, and per 32×32 tile its ray cone (unit axis
  = the mean of the tile's rays, ``cos_t`` = their least dot product with
  it; padding rays of ragged tiles left out), built in float64 numpy and
  cast to f32 once; cached per (rig, size, device);
* :func:`render_with` — the coarse-to-fine routine around a march: a
  quarter-resolution march from 0.05, a 3×3 min filter (out-of-bounds
  neighbours ignored), t0 = clip(0.9·dmin − 0.05, 0.05, far), nearest 4×
  upsample, a 16-step full-resolution refine; each pass culls with the
  tiles of its own resolution.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .raymarch import RayTable, ScenePrims, tile_masks

BLK = 32                # tile edge in pixels (raymarch_tpu.BLK): 32 x 32 threads a block
# the refine march of coarse-to-fine runs this many steps (raymarch_tpu.py:348)
REFINE_STEPS = 16


_RAY_CACHE: dict = {}


# ----------------------------------------------------------------------
# ray tables
# ----------------------------------------------------------------------

def _tile_cones(cam_pose, intrinsic, im_h: int, im_w: int):
    """(axes [V, T, 3], cos_t [V, T], tile_of [H·W]) of 32×32 tiles in
    row-major tile order: ``raymarch_tpu._tile_rays`` :60-101 (the same
    float64 operations on the same padded ray list, so the f32 tables come
    out equal)."""
    V = cam_pose.shape[0]
    fx, fy = intrinsic[0, 0], intrinsic[1, 1]
    cx, cy = intrinsic[0, 2], intrinsic[1, 2]
    u = (np.arange(im_w) - cx) / fx
    v = (np.arange(im_h) - cy) / fy
    uu, vv = np.meshgrid(u, v)
    dirs_cam = np.stack([uu, vv, np.ones_like(uu)], -1).reshape(-1, 3)
    tile = BLK * BLK
    nbw = -(-im_w // BLK)
    T = -(-im_h // BLK) * nbw
    ii, jj = np.meshgrid(np.arange(im_h), np.arange(im_w), indexing="ij")
    tile_of = ((ii // BLK) * nbw + (jj // BLK)).reshape(-1)
    ray_pos = tile_of * tile + ((ii % BLK) * BLK + (jj % BLK)).reshape(-1)
    dirs_pad = np.tile(np.array([0.0, 0.0, 1.0]), (T * tile, 1))
    dirs_pad[ray_pos] = dirs_cam
    valid = np.zeros(T * tile, bool)
    valid[ray_pos] = True
    dirs_w = np.einsum("nc,vbc->vnb", dirs_pad, cam_pose[:, :3, :3])
    dn = dirs_w / np.linalg.norm(dirs_w, axis=-1, keepdims=True)
    dn_t = dn.reshape(V, T, tile, 3)
    valid = valid.reshape(T, tile)
    axes = np.empty((V, T, 3), np.float64)
    cos_t = np.empty((V, T), np.float64)
    for t in range(T):
        sel = dn_t[:, t, valid[t]]
        ax = sel.mean(axis=1)
        ax /= np.linalg.norm(ax, axis=-1, keepdims=True)
        axes[:, t] = ax
        cos_t[:, t] = np.einsum("vnc,vc->vn", sel, ax).min(axis=1)
    return (axes.astype(np.float32), np.clip(cos_t, -1.0, 1.0).astype(np.float32),
            tile_of)


def ray_table(cam_pose, intrinsic, im_h: int, im_w: int, device) -> RayTable:
    """The :class:`raymarch.RayTable` of a rig on ``device``: world ray
    directions with camera-frame z = 1 for row-major pixels, the origins,
    and the tile cones.  Built in float64 numpy and cast once
    (``raymarch_tpu._tile_rays`` :60-101); cached."""
    cam_pose = np.asarray(cam_pose)
    intrinsic = np.asarray(intrinsic)
    key = (cam_pose.tobytes(), intrinsic.tobytes(), im_h, im_w, str(device))
    hit = _RAY_CACHE.get(key)
    if hit is not None:
        return hit
    fx, fy = intrinsic[0, 0], intrinsic[1, 1]
    cx, cy = intrinsic[0, 2], intrinsic[1, 2]
    u = (np.arange(im_w) - cx) / fx
    v = (np.arange(im_h) - cy) / fy
    uu, vv = np.meshgrid(u, v)
    dirs_cam = np.stack([uu, vv, np.ones_like(uu)], -1).reshape(-1, 3)
    dirs_w = np.einsum("nc,vbc->vnb", dirs_cam, cam_pose[:, :3, :3])  # [V, N, 3]
    dirs = np.ascontiguousarray(np.moveaxis(dirs_w, -1, 1).astype(np.float32))
    axes, cos_t, tile_of = _tile_cones(cam_pose, intrinsic, im_h, im_w)
    hit = RayTable(dirs=torch.as_tensor(dirs, device=device),
                   origins=torch.as_tensor(cam_pose[:, :3, 3].astype(np.float32),
                                           device=device),
                   axes=torch.as_tensor(axes, device=device),
                   cos_t=torch.as_tensor(cos_t, device=device),
                   tile_of=torch.as_tensor(tile_of, device=device), im_h=im_h, im_w=im_w)
    _RAY_CACHE[key] = hit
    return hit


# ----------------------------------------------------------------------
# the kernel
# ----------------------------------------------------------------------

# ----------------------------------------------------------------------
# coarse-to-fine routine
# ----------------------------------------------------------------------

def coarse_start(d_coarse: torch.Tensor, far: float) -> torch.Tensor:
    """Per-ray start of the refine march from the coarse depth [E, V, h, w]:
    the 3×3 neighbourhood minimum (out-of-bounds neighbours ignored), minus
    a relative and an absolute margin, clipped to [0.05, far], upsampled 4×
    nearest → [E, V, 4h, 4w]."""
    dmin = -F.max_pool2d(-d_coarse, kernel_size=3, stride=1, padding=1)
    t0 = torch.clamp(dmin * 0.9 - 0.05, 0.05, far)
    return t0.repeat_interleave(4, dim=2).repeat_interleave(4, dim=3)


def coarse_intrinsic(intrinsic) -> np.ndarray:
    """The intrinsic of the quarter-resolution pass (f32, as the TPU
    wrapper casts it)."""
    intr_c = np.asarray(intrinsic, np.float64).copy()
    intr_c[:2] /= 4.0
    return intr_c.astype(np.float32)


def render_with(march_fn, prims: ScenePrims, cam_pose, intrinsic, im_h: int,
                im_w: int, n_steps: int = 40, far: float = 100.0,
                eps: float = 1e-3, coarse_to_fine: bool = False,
                cull: bool = True) -> torch.Tensor:
    """Depth images [E, V, H, W] through ``march_fn`` (:func:`march` or
    ``raymarch.march_plain``), exact or coarse-to-fine
    (``raymarch_tpu.render_depth_tpu`` :334-351), culled or not."""
    E = prims.sphere_radius.shape[0]
    dev = prims.sphere_radius.device
    cam_pose = np.asarray(cam_pose)
    V = cam_pose.shape[0]
    if coarse_to_fine and im_h % 4 == 0 and im_w % 4 == 0:
        hc, wc = im_h // 4, im_w // 4
        rays_c = ray_table(cam_pose, coarse_intrinsic(intrinsic), hc, wc, dev)
        d_c = march_fn(prims, rays_c, 0.05, n_steps, far, eps, cull=cull)
        t0 = coarse_start(d_c.reshape(E, V, hc, wc), far).reshape(E, V, -1)
        rays = ray_table(cam_pose, intrinsic, im_h, im_w, dev)
        out = march_fn(prims, rays, t0.contiguous(), REFINE_STEPS, far, eps, cull=cull)
    else:
        rays = ray_table(cam_pose, intrinsic, im_h, im_w, dev)
        out = march_fn(prims, rays, 0.05, n_steps, far, eps, cull=cull)
    return out.reshape(E, V, im_h, im_w)
