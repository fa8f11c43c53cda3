"""Batched SDF-raymarched depth cameras (PyTorch).

Counterpart of ``partmanip_tpu/ops/raymarch.py``: per-env depth images are
sphere-traced against the scene's analytic SDF (robot collision spheres +
oriented boxes + the ground plane, the primitives the contact solver uses).
The output is **positive z-depth** in the camera frame, ``far`` where a ray
misses.  Rays have z-normalized camera-frame directions, so the march
parameter is the z-depth; each step advances by the SDF along the unit ray.

* :func:`scene_sdf` — min-SDF of the scene at world points;
* :func:`march_plain` — the plain exact march of given rays from given start
  depths (what kernel B2 computes, op for op: no fused multiply-adds, the
  box distance in the kernel's component form, the same done / hit tests);
* :func:`render_depth` — the entry point.  Prims on a CUDA device go to
  kernel B2 (``ops/raymarch_cuda.py``), prims on the CPU to
  :func:`march_plain`; both through the same ray table and the same
  coarse-to-fine routine.

``render_rgb``, ``scene_sdf_seg``, ``scene_normal`` and ``render_depth_seg``
are not ported yet: the observation modes that need them raise (ROADMAP
Queue A: remaining vision modes).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

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


def _scene_dist(prims: ScenePrims, px, py, pz):
    d = torch.full_like(px, 1e6)
    if prims.sphere_center is not None and prims.sphere_center.shape[1]:
        d = torch.minimum(d, _sphere_dist(prims, px, py, pz).amin(-1))
    if prims.box_pos is not None and prims.box_pos.shape[1]:
        d = torch.minimum(d, _box_dist(prims, px, py, pz).amin(-1))
    if prims.ground:
        d = torch.minimum(d, pz)
    return d


def scene_sdf(prims: ScenePrims, p: torch.Tensor) -> torch.Tensor:
    """Min-SDF of the scene at world points p [E, N, 3] → [E, N]."""
    return _scene_dist(prims, p[..., 0], p[..., 1], p[..., 2])


def march_plain(prims: ScenePrims, dirs: torch.Tensor, origins: torch.Tensor,
                t0, n_steps: int, far: float, eps: float,
                count_evals: bool = False):
    """Sphere-trace rays from per-ray start depths: the plain version of
    kernel B2.

    dirs [V, 3, N] world ray directions (z-normalized in the camera frame),
    origins [V, 3], t0 a float or [E, V, N]  →  depth [E, V, N] (``far`` on
    a miss).  With ``count_evals`` also returns the number of scene
    evaluations each ray needs in the kernel (its march until done, plus
    the hit test), i32 [E, V, N]."""
    E = prims.sphere_radius.shape[0]
    V, _, N = dirs.shape
    out = torch.empty((E, V, N), dtype=torch.float32, device=dirs.device)
    evals = torch.empty((E, V, N), dtype=torch.int32, device=dirs.device)
    G = prims.box_pos.shape[1] if prims.box_pos is not None else 0
    S = prims.sphere_radius.shape[1]
    chunk = max(1, _CHUNK_ELEMS // max(1, E * max(G, S, 1)))
    for v in range(V):
        ox, oy, oz = (origins[v, i] for i in range(3))
        for a in range(0, N, chunk):
            b = min(N, a + chunk)
            dx, dy, dz = (dirs[v, i, a:b][None] for i in range(3))   # [1, n]
            inv = 1.0 / torch.sqrt(dx * dx + dy * dy + dz * dz)
            if isinstance(t0, torch.Tensor):
                tz = t0[:, v, a:b].clone()
            else:
                tz = torch.full((E, b - a), float(t0), device=dirs.device)
            alive = torch.ones_like(tz, dtype=torch.bool)
            n_eval = torch.zeros_like(tz, dtype=torch.int32)
            for _ in range(n_steps):
                dist = _scene_dist(prims, ox + tz * dx, oy + tz * dy, oz + tz * dz)
                n_eval += alive.to(torch.int32)
                done = (dist < eps) | (tz > far)
                alive &= ~done
                tz = torch.where(done, tz, tz + torch.clamp(dist, min=0.0) * inv)
            dist = _scene_dist(prims, ox + tz * dx, oy + tz * dy, oz + tz * dz)
            hit = (dist < 10 * eps) & (tz <= far)
            out[:, v, a:b] = torch.where(hit, tz, torch.full_like(tz, far))
            evals[:, v, a:b] = n_eval + 1
    return (out, evals) if count_evals else out


def render_depth(prims: ScenePrims, cam_pose, intrinsic, im_h: int, im_w: int,
                 n_steps: int = 40, far: float = 100.0, eps: float = 1e-3,
                 coarse_to_fine: bool = False) -> torch.Tensor:
    """Sphere-traced depth images [E, V, H, W] (positive z-depth).

    cam_pose [V, 4, 4] world-from-camera (OpenCV convention) and intrinsic
    [3, 3] are numpy.  Prims on a CUDA device launch kernel B2, prims on the
    CPU take :func:`march_plain`.  ``coarse_to_fine`` (with H and W
    multiples of 4) marches a quarter-resolution pre-pass and refines at
    full resolution from a conservative per-ray start, as the JAX package's
    TPU kernel does (its XLA path ignores the flag)."""
    from . import raymarch_cuda
    march = (raymarch_cuda.march if prims.sphere_radius.is_cuda
             else march_plain)
    return raymarch_cuda.render_with(march, prims, cam_pose, intrinsic,
                                     im_h, im_w, n_steps=n_steps, far=far,
                                     eps=eps, coarse_to_fine=coarse_to_fine)
