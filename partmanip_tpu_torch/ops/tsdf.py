"""Multi-view depth → point clouds / TSDF fusion (PyTorch).

Counterpart of ``partmanip_tpu/ops/tsdf.py``: the voxel→pixel projection
tables of a camera rig are precomputed once in numpy (:func:`make_tsdf_spec`,
the same tables); :func:`depth_to_pointcloud` unprojects all views, crops to
the workspace box (points outside become the origin, as the reference zeroes
them) and reduces each env's cloud to k points by farthest-point sampling —
kernel B3 for depth on a CUDA device, the plain loop for depth on the CPU.

The unprojection rounds as the JAX package's ``einsum`` does on the CPU
(one fused multiply-add chain over the three camera coordinates, each step
rounded once, ``fps.fma_f32``), which gives the same f32 points on every
device, so that farthest-point sampling, whose picks follow the last bit of
every distance, sees the same cloud.

:func:`integrate` fuses the views into a TSDF volume;
:func:`sparse_voxel` keeps its near-surface voxels and samples 1024 of
their integer coordinates (with the TSDF value at each);
:func:`extract_surface_points` samples the volume's zero crossings.  Both
sample with the same farthest-point sampling (kernel B3 on a CUDA device,
the plain loop on the CPU), though the JAX package runs them through its
XLA loop: B3 picks the indices that loop picks.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .fps import farthest_point_sampling, fma_f32


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


def integrate(spec: TSDFSpec, depth: torch.Tensor) -> torch.Tensor:
    """Fuse depth [E, V, H, W] into a TSDF volume [E, res, res, res]
    (averaging fusion ≙ ``TSDFVolume.integrate``)."""
    E, V = depth.shape[:2]
    dev = depth.device
    flat = depth.reshape(E, V, -1)
    lin = (spec.pix_y.astype(np.int64) * spec.im_w + spec.pix_x.astype(np.int64))
    lin = torch.as_tensor(lin, device=dev)[None].expand(E, -1, -1)
    depth_val = torch.gather(flat, 2, lin)                   # [E, V, N]
    diff = depth_val - torch.as_tensor(spec.pix_z, device=dev)[None]
    tsdf = torch.clamp(diff / spec.sdf_trunc, max=1.0)
    valid = (torch.as_tensor(spec.valid, device=dev)[None] & (depth_val > 0)
             & (diff >= -spec.sdf_trunc))
    n_valid = valid.sum(dim=1).float()                       # [E, N]
    avg = torch.where(valid, tsdf, torch.zeros_like(tsdf)).sum(dim=1) \
        / torch.clamp(n_valid, min=1.0)
    vol = torch.where(n_valid > 0, avg, torch.ones_like(avg))
    r = spec.resolution
    return vol.reshape(E, r, r, r)


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


def depth_to_pointcloud(spec: TSDFSpec, depth: torch.Tensor,
                        k: int = 1024) -> torch.Tensor:
    """Unproject all views, crop to the workspace AABB, FPS to k points
    (≙ ``TSDFVolume.depth2pc``; invalid points are zeroed before FPS like
    the reference).  depth [E, V, H, W] → [E, k, 3]."""
    pc, _ = farthest_point_sampling(workspace_points(spec, depth), k)
    return pc


def _grid_coords(shape) -> np.ndarray:
    """f32 [prod(shape), 3] integer coordinates of a grid, x-major."""
    g = np.meshgrid(*[np.arange(n) for n in shape], indexing="ij")
    return np.stack(g, -1).reshape(-1, 3).astype(np.float32)


def surface_points(spec: TSDFSpec, vol: torch.Tensor) -> torch.Tensor:
    """The points :func:`extract_surface_points` samples from, [E,
    3·r²·(r − 1), 3]: on every grid edge whose two values change sign (both
    inside the truncation, |v| < 1) the linear zero crossing
    ``origin + voxel_size · (base + clip(t, 0, 1) · axis)`` with
    t = a / (a − b), edges along x, then y, then z; the other edges' points
    set to the origin.  The last multiply-add rounds as XLA computes it on
    the CPU, where the JAX package is held: once (fused) in x and y, twice
    in z (``fps.fma_f32``); farthest-point sampling follows every last
    bit."""
    E, r = vol.shape[0], spec.resolution
    dev = vol.device
    origin = torch.as_tensor(spec.origin, device=dev)
    voxel = torch.tensor(spec.voxel_size, dtype=torch.float32, device=dev)
    pts, masks = [], []
    for axis in range(3):
        a = vol.narrow(1 + axis, 0, r - 1)
        b = vol.narrow(1 + axis, 1, r - 1)
        cross = (a * b < 0) & (torch.abs(a) < 1.0) & (torch.abs(b) < 1.0)
        diff = a - b
        t = a / torch.where(torch.abs(diff) > 1e-12, diff, torch.full_like(diff, 1e-12))
        shape = [r, r, r]
        shape[axis] -= 1
        local = torch.as_tensor(_grid_coords(shape), device=dev)[None].repeat(E, 1, 1)
        local[..., axis] += torch.clamp(t, 0.0, 1.0).reshape(E, -1)
        xy = fma_f32(voxel, local[..., :2], origin[:2].expand_as(local[..., :2]))
        pts.append(torch.cat([xy, origin[2] + voxel * local[..., 2:]], dim=-1))
        masks.append(cross.reshape(E, -1))
    return torch.cat(pts, dim=1) * torch.cat(masks, dim=1)[..., None]


def extract_surface_points(spec: TSDFSpec, vol: torch.Tensor,
                           k: int = 1024) -> torch.Tensor:
    """Level-0 surface points of TSDF volumes [E, r, r, r] → [E, k, 3]:
    farthest-point sampling of :func:`surface_points`."""
    return farthest_point_sampling(surface_points(spec, vol), k)[0]


def sparse_points(spec: TSDFSpec, vol: torch.Tensor, thres: float = 0.2):
    """(points [E, r³, 3], flat volume [E, r³]): the integer coordinates of
    the voxels with |tsdf| < ``thres``, the others the origin (voxel
    (0, 0, 0))."""
    flat = vol.reshape(vol.shape[0], -1)
    r = spec.resolution
    coords = torch.as_tensor(_grid_coords((r, r, r)), device=vol.device)
    near = (flat < thres) & (flat > -thres)
    return torch.where(near[..., None], coords[None], torch.zeros((), device=vol.device)), flat


def sparse_voxel(spec: TSDFSpec, depth: torch.Tensor, k: int = 1024,
                 thres: float = 0.2) -> torch.Tensor:
    """Near-surface voxel sampling: depth [E, V, H, W] → [E, k, 4] (the
    integer voxel coordinates i, j, k and the TSDF value there):
    farthest-point sampling of :func:`sparse_points` of the fused volume
    (exact: squared distances of small integers round nowhere, so ties go
    to the lowest index, as ``jnp.argmax``)."""
    pts, flat = sparse_points(spec, integrate(spec, depth), thres)
    sampled, idx = farthest_point_sampling(pts, k)
    return torch.cat([sampled, torch.gather(flat, 1, idx.long())[..., None]], dim=-1)
