"""Multi-view depth → workspace point clouds (PyTorch): the voxel→pixel
tables of a camera rig are precomputed once in numpy
(:func:`make_tsdf_spec`); :func:`workspace_points` unprojects all views
and crops to the workspace box (points outside become the origin).

The unprojection rounds as one fused multiply-add chain over the three
camera coordinates, each step rounded once (:func:`fma_f32`), which gives
the same f32 points on every device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


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



class TSDFSpec(NamedTuple):
    """Static fusion tables for one camera rig."""

    size: float
    resolution: int
    origin: np.ndarray        # [3]
    voxel_size: float
    sdf_trunc: float
    cam_pose: np.ndarray      # [V, 4, 4] world-from-camera
    intrinsic: np.ndarray     # [3, 3]
    im_h: int
    im_w: int
    # precomputed per (view, voxel):
    pix_x: np.ndarray         # i32 [V, N]
    pix_y: np.ndarray         # i32 [V, N]
    pix_z: np.ndarray         # f32 [V, N] voxel depth in camera frame
    valid: np.ndarray         # bool [V, N]
    world_points: np.ndarray  # f32 [N, 3] voxel centers


def make_tsdf_spec(cam_pose, intrinsic, im_h, im_w, size=0.5, resolution=50,
                   origin=(-0.25, -0.25, -0.0503)) -> TSDFSpec:
    """Build the projection tables (≙ ``register_camera``)."""
    origin = np.asarray(origin, np.float32)
    voxel_size = size / resolution
    sdf_trunc = 4 * voxel_size
    r = np.arange(resolution)
    gx, gy, gz = np.meshgrid(r, r, r, indexing="ij")
    coords = np.stack([gx, gy, gz], -1).reshape(-1, 3)
    world = origin + voxel_size * coords                     # [N, 3]

    Rt = cam_pose[:, :3, :3]
    t = cam_pose[:, :3, 3]
    cam_c = np.einsum("nc,vcb->vnb", world, Rt) - np.einsum(
        "vc,vcb->vb", t, Rt)[:, None, :]
    fx, fy = intrinsic[0, 0], intrinsic[1, 1]
    cx, cy = intrinsic[0, 2], intrinsic[1, 2]
    pz = cam_c[..., 2]
    px = np.round(cam_c[..., 0] * fx / np.maximum(pz, 1e-9) + cx).astype(np.int64)
    py = np.round(cam_c[..., 1] * fy / np.maximum(pz, 1e-9) + cy).astype(np.int64)
    valid = (px >= 0) & (px < im_w) & (py >= 0) & (py < im_h) & (pz > 0)
    return TSDFSpec(
        size=size, resolution=resolution, origin=origin,
        voxel_size=voxel_size, sdf_trunc=sdf_trunc,
        cam_pose=np.asarray(cam_pose, np.float32),
        intrinsic=np.asarray(intrinsic, np.float32), im_h=im_h, im_w=im_w,
        pix_x=np.where(valid, px, 0).astype(np.int32),
        pix_y=np.where(valid, py, 0).astype(np.int32),
        pix_z=pz.astype(np.float32), valid=valid,
        world_points=world.astype(np.float32),
    )


def workspace_points(spec: TSDFSpec, depth: torch.Tensor) -> torch.Tensor:
    """Unproject all views and crop to the workspace AABB: depth [E, V, H, W]
    → world points [E, V·H·W, 3], the ones outside the box set to the
    origin."""
    E, V, H, W = depth.shape
    dev = depth.device
    uu, vv = np.meshgrid(np.arange(W), np.arange(H))
    fx, fy = spec.intrinsic[0, 0], spec.intrinsic[1, 1]
    cx, cy = spec.intrinsic[0, 2], spec.intrinsic[1, 2]
    ray_x = torch.as_tensor(((uu - cx) / fx).reshape(-1).astype(np.float32), device=dev)
    ray_y = torch.as_tensor(((vv - cy) / fy).reshape(-1).astype(np.float32), device=dev)

    z = depth.reshape(E, V, -1)[..., None]                   # [E, V, HW, 1]
    cam = (z * ray_x[:, None], z * ray_y[:, None], z)        # camera-frame x, y, z
    R = torch.as_tensor(spec.cam_pose[:, :3, :3], device=dev)[None, :, None]  # [1, V, 1, 3, 3]
    t = torch.as_tensor(spec.cam_pose[:, :3, 3], device=dev)[None, :, None]   # [1, V, 1, 3]
    world = cam[0] * R[..., 0]
    for c in (1, 2):
        world = fma_f32(cam[c], R[..., c], world)
    world = world + t
    world = world.reshape(E, -1, 3)

    lo = torch.as_tensor(spec.origin, device=dev)
    hi = lo + spec.size
    valid = ((world > lo) & (world < hi)).all(dim=-1)
    return world * valid[..., None]


