"""Kernel B2: the sphere-tracing depth camera on the GPU, its ray tables
and the coarse-to-fine routine.

Counterpart of ``partmanip_tpu/ops/raymarch_tpu.py`` (the Pallas kernel
``_march_kernel``, launched by ``_render_tpu``, entry ``render_depth_tpu``).
The kernel source is ``csrc/raymarch.cu``: one thread per ray over
E × V × H·W, each block of one (env, view) with that env's primitives in
shared memory; a ray marches until it is done or ``n_steps`` run out (a done
ray never moves again, so stopping it early is exact).  It is compiled with
``-fmad=false`` so that it repeats :func:`raymarch.march_plain` op for op.
The TPU kernel's cone culling (``_prim_masks``) is left out: the minimum
over primitives is the same whichever are skipped.

* :func:`ray_table` — the per-pixel world ray directions ``[V, 3, H·W]``
  and origins of a rig, built in float64 numpy as the JAX package builds
  them and cast to f32 once; cached per (rig, size, device) like
  ``_RAY_CACHE``;
* :func:`render_with` — the coarse-to-fine routine around any march (the
  kernel's or the plain one): a quarter-resolution march from 0.05, a 3×3
  min filter (out-of-bounds neighbours ignored), t0 = clip(0.9·dmin − 0.05,
  0.05, far), nearest 4× upsample, a 16-step full-resolution refine;
* :func:`march` — the kernel launch (CUDA tensors only); ``launch_counts``
  rises by one per launch.

What bounds it on an H100: operations.  Every step of every ray evaluates
all S spheres and the live boxes (11 and 54 f32 operations each);
bytes are the primitives, the ray table and the image, a few MB.  The design
keeps every ray's march in registers and the primitives in shared memory,
so device memory is touched once per ray.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np
import torch
import torch.nn.functional as F

from ..utils import cuda_lib
from .raymarch import ScenePrims

SOURCE = os.path.join(cuda_lib.CSRC, "raymarch.cu")
_ptr, _i32, _f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
LIBRARY = cuda_lib.Library(
    "b2", SOURCE, "libraymarch.so",
    {"rm_launch": ((_ptr, _ptr, _ptr, _ptr, _ptr, _f32, _ptr, _i32, _i32, _i32,
                    _i32, _i32, _i32, _f32, _f32, _f32, _i32, _i32, _ptr), _i32)},
    extra_flags=["-fmad=false"])
THREADS = 256
# the refine march of coarse-to-fine runs this many steps (raymarch_tpu.py:348)
REFINE_STEPS = 16

launch_counts = cuda_lib.launch_counter("b2")

_RAY_CACHE: dict = {}


# ----------------------------------------------------------------------
# ray tables
# ----------------------------------------------------------------------

def ray_table(cam_pose, intrinsic, im_h: int, im_w: int, device):
    """(dirs f32 [V, 3, H·W], origins f32 [V, 3]) on ``device``: world ray
    directions with camera-frame z = 1, row-major pixels.  Built in float64
    numpy and cast once (``raymarch_tpu._tile_rays`` :60-82); cached."""
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
    hit = (torch.as_tensor(dirs, device=device),
           torch.as_tensor(cam_pose[:, :3, 3].astype(np.float32), device=device))
    _RAY_CACHE[key] = hit
    return hit


# ----------------------------------------------------------------------
# the kernel
# ----------------------------------------------------------------------

def pack_prims(prims: ScenePrims):
    """(sph f32 [E, S, 4], box f32 [E, G, 11]) as the kernel reads them:
    centre + radius; position, quaternion (xyzw), half extents, mask."""
    sph = torch.cat([prims.sphere_center, prims.sphere_radius[..., None]],
                    dim=-1).float().contiguous()
    box = torch.cat([prims.box_pos, prims.box_quat, prims.box_half,
                     prims.box_mask[..., None]], dim=-1).float().contiguous()
    return sph, box


def march(prims: ScenePrims, dirs: torch.Tensor, origins: torch.Tensor, t0,
          n_steps: int, far: float, eps: float) -> torch.Tensor:
    """Kernel B2: the march of :func:`raymarch.march_plain` (same arguments,
    depth [E, V, N]) in one launch.  CUDA tensors only."""
    sph, box = pack_prims(prims)
    E, S = sph.shape[:2]
    G = box.shape[1]
    V, three, N = dirs.shape
    dev = sph.device
    if not (sph.is_cuda and box.is_cuda and dirs.is_cuda and origins.is_cuda):
        raise ValueError("kernel B2 needs CUDA tensors (the plain version is "
                         "raymarch.march_plain)")
    if len({sph.device, box.device, dirs.device, origins.device}) != 1:
        raise ValueError("kernel B2 needs every tensor on one device")
    if three != 3 or tuple(origins.shape) != (V, 3) or box.shape[0] != E:
        raise ValueError(f"shapes sph {tuple(sph.shape)}, box {tuple(box.shape)}, "
                         f"dirs {tuple(dirs.shape)}, origins {tuple(origins.shape)}")
    if dirs.dtype != torch.float32 or origins.dtype != torch.float32:
        raise TypeError("ray tables must be f32")
    dirs, origins = dirs.contiguous(), origins.contiguous()
    if isinstance(t0, torch.Tensor):
        if tuple(t0.shape) != (E, V, N) or t0.dtype != torch.float32 or t0.device != dev:
            raise ValueError(f"t0 {tuple(t0.shape)} {t0.dtype} is not f32 [E, V, N]")
        t0 = t0.contiguous()
        t0_ptr, t0_const = t0.data_ptr(), 0.0
    else:
        t0_ptr, t0_const = None, float(t0)
    if E < 1 or V < 1 or N < 1 or (N + THREADS - 1) // THREADS >= 2 ** 31:
        raise ValueError(f"empty or oversized render E={E} V={V} N={N}")
    if E > 65535 or V > 65535:
        raise ValueError("kernel B2 takes at most 65535 envs and views")
    if (4 * S + 11 * G) * 4 > 48 * 1024:
        raise ValueError(f"{S} spheres and {G} boxes do not fit the kernel's "
                         f"48 KB of shared memory")
    out = torch.empty((E, V, N), dtype=torch.float32, device=dev)
    lib = LIBRARY.load()
    err = lib.rm_launch(sph.data_ptr(), box.data_ptr(), dirs.data_ptr(),
                        origins.data_ptr(), t0_ptr, t0_const, out.data_ptr(),
                        E, V, N, S, G, int(n_steps), float(far), float(eps),
                        float(10 * eps), int(bool(prims.ground)), THREADS,
                        cuda_lib.stream_of(out))
    cuda_lib.check_launch(err, "raymarch (B2)")
    launch_counts["b2"] += 1
    return out


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


def render_with(march_fn, prims: ScenePrims, cam_pose, intrinsic, im_h: int,
                im_w: int, n_steps: int = 40, far: float = 100.0,
                eps: float = 1e-3, coarse_to_fine: bool = False) -> torch.Tensor:
    """Depth images [E, V, H, W] through ``march_fn`` (:func:`march` or
    ``raymarch.march_plain``), exact or coarse-to-fine
    (``raymarch_tpu.render_depth_tpu`` :334-351)."""
    E = prims.sphere_radius.shape[0]
    dev = prims.sphere_radius.device
    cam_pose = np.asarray(cam_pose)
    V = cam_pose.shape[0]
    if coarse_to_fine and im_h % 4 == 0 and im_w % 4 == 0:
        hc, wc = im_h // 4, im_w // 4
        intr_c = np.asarray(intrinsic, np.float64).copy()
        intr_c[:2] /= 4.0
        dirs_c, org_c = ray_table(cam_pose, intr_c.astype(np.float32), hc, wc, dev)
        d_c = march_fn(prims, dirs_c, org_c, 0.05, n_steps, far, eps)
        t0 = coarse_start(d_c.reshape(E, V, hc, wc), far).reshape(E, V, -1)
        dirs, org = ray_table(cam_pose, intrinsic, im_h, im_w, dev)
        out = march_fn(prims, dirs, org, t0.contiguous(), REFINE_STEPS, far, eps)
    else:
        dirs, org = ray_table(cam_pose, intrinsic, im_h, im_w, dev)
        out = march_fn(prims, dirs, org, 0.05, n_steps, far, eps)
    return out.reshape(E, V, im_h, im_w)

