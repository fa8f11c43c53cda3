"""Signed-distance fields of meshes: baking and the contact-path grid query
(PyTorch).

Counterpart of ``partmanip_tpu/ops/sdf.py`` for what the physics step
needs:

* :func:`bake_mesh_sdf` — a truncated SDF grid of a triangle mesh: exact
  point-triangle distances, signed by the generalized winding number
  (robust on open meshes); same grid layout and truncation as the JAX
  package, so either package may read the other's bake;
* :class:`GridStack` / :func:`stack_grids` — M grids padded to one shape;
* :func:`grid_query` — trilinear lookup of every point in every part's
  grid; :func:`scene_sdf` / :func:`scene_tsdf` — the (truncated) SDF of a
  scene of posed parts plus the ground (no code path of either package
  calls these three: the ``mesh_tsdf`` observation queries the analytic
  primitives, ``raymarch.scene_sdf``);
* :func:`grid_query_grad` — trilinear value and analytic gradient with a
  per-query grid id, in the JAX package's operation order (the gradient's
  cell choice must match): the plain version of the grid narrowphase that
  kernel B1c (``csrc/fused_inner_step_obj.cu`` with ``FIS_K > 0``) runs on
  the GPU.

Every function works on the device of its tensors.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .tsdf import fma_f32


def _dot(a, b):
    """Dot product over the last axis of size 3 as the fused multiply-add
    chain fma(a₂, b₂, fma(a₁, b₁, a₀·b₀)) that XLA computes for the JAX
    package's einsums on the CPU.  Separately rounded products can cancel
    to an exact 0 where the chain does not, and the reference's region
    classification then takes an edge's point for the face's: a point far
    off the mesh got a distance of 0 (ROADMAP Queue C)."""
    a, b = torch.broadcast_tensors(a, b)
    d = a[..., 0] * b[..., 0]
    d = fma_f32(a[..., 1], b[..., 1], d)
    return fma_f32(a[..., 2], b[..., 2], d)


def _point_triangle_dist_sq(p, a, b, c):
    """Squared distance from points p [P, 3] to triangles (a, b, c) [T, 3],
    over the [P, T] grid: the standard region classification of the closest
    point (face / edge / vertex), branch-free."""
    ab = b - a            # [T, 3]
    ac = c - a
    ap = p[:, None, :] - a[None]     # [P, T, 3]

    d1 = _dot(ab[None], ap)
    d2 = _dot(ac[None], ap)
    bp = p[:, None, :] - b[None]
    d3 = _dot(ab[None], bp)
    d4 = _dot(ac[None], bp)
    cp = p[:, None, :] - c[None]
    d5 = _dot(ab[None], cp)
    d6 = _dot(ac[None], cp)

    # barycentric candidates
    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2

    # region masks
    in_a = (d1 < 0) & (d2 < 0)
    in_b = (d3 > 0) & (d4 <= d3)
    in_c = (d6 > 0) & (d5 <= d6)
    on_ab = (vc < 0) & (d1 > 0) & (d3 < 0)
    on_ac = (vb < 0) & (d2 > 0) & (d6 < 0)
    on_bc = (va < 0) & ((d4 - d3) > 0) & ((d5 - d6) > 0)

    # closest points per region
    t_ab = torch.clamp(d1 / (d1 - d3 + 1e-30), 0, 1)
    t_ac = torch.clamp(d2 / (d2 - d6 + 1e-30), 0, 1)
    t_bc = torch.clamp((d4 - d3) / ((d4 - d3) + (d5 - d6) + 1e-30), 0, 1)

    denom = va + vb + vc
    v = vb / (denom + 1e-30)
    w = vc / (denom + 1e-30)

    q_face = a[None] + v[..., None] * ab[None] + w[..., None] * ac[None]
    q_ab = a[None] + t_ab[..., None] * ab[None]
    q_ac = a[None] + t_ac[..., None] * ac[None]
    q_bc = b[None] + t_bc[..., None] * (c - b)[None]

    q = q_face
    q = torch.where(on_bc[..., None], q_bc, q)
    q = torch.where(on_ac[..., None], q_ac, q)
    q = torch.where(on_ab[..., None], q_ab, q)
    q = torch.where(in_c[..., None], c[None].expand_as(q), q)
    q = torch.where(in_b[..., None], b[None].expand_as(q), q)
    q = torch.where(in_a[..., None], a[None].expand_as(q), q)

    d = p[:, None, :] - q
    return _dot(d, d)


def _winding_number(p, a, b, c):
    """Generalized winding number of points w.r.t. the triangle soup
    (van Oosterom–Strackee solid angles): ≈1 inside, ≈0 outside."""
    ra = a[None] - p[:, None, :]
    rb = b[None] - p[:, None, :]
    rc = c[None] - p[:, None, :]
    la = torch.linalg.norm(ra, dim=-1)
    lb = torch.linalg.norm(rb, dim=-1)
    lc = torch.linalg.norm(rc, dim=-1)
    num = _dot(ra, torch.linalg.cross(rb, rc, dim=-1))
    den = (la * lb * lc + _dot(ra, rb) * lc + _dot(rb, rc) * la
           + _dot(rc, ra) * lb)
    omega = 2.0 * torch.atan2(num, den)
    return torch.sum(omega, dim=-1) / (4.0 * math.pi)


def bake_mesh_sdf(vertices: np.ndarray, faces: np.ndarray,
                  voxel_size: float = 0.002, trunc: float = None,
                  chunk: int = 65536, device="cpu") -> dict:
    """Bake a truncated SDF grid for a triangle mesh on ``device``.

    The grid covers the mesh AABB + 2·trunc margin at ``voxel_size``.
    Returns {'sdf': [X, Y, Z] f32, 'bbox_min': [3] f32, 'voxel_size': float}
    (numpy), the JAX package's layout.
    """
    vertices = np.asarray(vertices, np.float32)
    faces = np.asarray(faces, np.int32)
    # drop degenerate faces
    ok = ((faces[:, 0] != faces[:, 1]) & (faces[:, 0] != faces[:, 2])
          & (faces[:, 1] != faces[:, 2]))
    faces = faces[ok]

    if trunc is None:
        trunc = 4.0 * voxel_size * 10  # generous default margin
    vmin = vertices.min(0) - 2 * trunc
    vmax = vertices.max(0) + 2 * trunc
    shape = np.ceil((vmax - vmin) / voxel_size).astype(int)
    xs = vmin[0] + voxel_size * np.arange(shape[0])
    ys = vmin[1] + voxel_size * np.arange(shape[1])
    zs = vmin[2] + voxel_size * np.arange(shape[2])
    grid = np.stack(np.meshgrid(xs, ys, zs, indexing="ij"), -1).reshape(-1, 3)

    t = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)
    a, b, c = (t(vertices[faces[:, i]]) for i in range(3))
    pts = t(grid)
    out = torch.empty(pts.shape[0], dtype=torch.float32, device=device)
    for i in range(0, pts.shape[0], chunk):
        p = pts[i:i + chunk]
        dist = torch.sqrt(torch.min(_point_triangle_dist_sq(p, a, b, c), dim=-1).values)
        sign = torch.where(_winding_number(p, a, b, c) > 0.5, -1.0, 1.0)
        out[i:i + chunk] = sign * dist
    sdf = np.clip(out.cpu().numpy(), -trunc, trunc).reshape(tuple(shape))
    return {"sdf": sdf, "bbox_min": vmin.astype(np.float32),
            "voxel_size": float(voxel_size)}


class GridStack(NamedTuple):
    """M SDF grids padded to a common shape for batched queries."""

    sdf: torch.Tensor         # f32 [M, X, Y, Z] padded with +trunc
    bbox_min: torch.Tensor    # f32 [M, 3]
    voxel_size: torch.Tensor  # f32 [M]


def stack_grids(grids: list, pad_value: float, device="cpu") -> GridStack:
    shapes = np.array([g["sdf"].shape for g in grids])
    tgt = shapes.max(0)
    sdfs = []
    for g in grids:
        s = g["sdf"]
        pad = [(0, int(tgt[i] - s.shape[i])) for i in range(3)]
        sdfs.append(np.pad(s, pad, constant_values=pad_value))
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)
    return GridStack(
        sdf=f32(np.stack(sdfs)),
        bbox_min=f32(np.stack([g["bbox_min"] for g in grids])),
        voxel_size=f32(np.array([g["voxel_size"] for g in grids], np.float32)))


def grid_query(stack: GridStack, points: torch.Tensor,
               outside_value: float) -> torch.Tensor:
    """Trilinear SDF lookup: points [..., M, N, 3], each row m in part m's
    local frame → values [..., M, N] (``outside_value`` outside the grid's
    interior cells)."""
    M, X, Y, Z = stack.sdf.shape
    idx = (points - stack.bbox_min[:, None, :]) / stack.voxel_size[:, None, None]
    hi = torch.tensor([X - 2, Y - 2, Z - 2], dtype=points.dtype, device=points.device)
    valid = torch.all((idx >= 1.0) & (idx <= hi), dim=-1)
    idx = torch.minimum(torch.clamp(idx, min=0.0), hi)
    i0 = idx.to(torch.int64)
    f = idx - i0
    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
    sy, sz = Y * Z, Z
    part = torch.arange(M, device=points.device)[:, None] * (X * Y * Z)
    base = part + i0[..., 0] * sy + i0[..., 1] * sz + i0[..., 2]
    flat = stack.sdf.reshape(-1)

    def g(d):
        return flat[base + d]

    val = (((g(0) * (1 - fz) + g(1) * fz) * (1 - fy)
            + (g(sz) * (1 - fz) + g(sz + 1) * fz) * fy) * (1 - fx)
           + ((g(sy) * (1 - fz) + g(sy + 1) * fz) * (1 - fy)
              + (g(sy + sz) * (1 - fz) + g(sy + sz + 1) * fz) * fy) * fx)
    return torch.where(valid, val, torch.full_like(val, outside_value))


def _parts_min(stack: GridStack, part_rot, part_pos, points, outside_value: float,
               ground: bool):
    """min over posed parts (+ the ground plane z) of the grid SDF at world
    points [N, 3] (shared by the envs) or [E, N, 3] → [E, N]."""
    if points.dim() == 2:
        x = points[None, None] - part_pos[:, :, None, :]
    else:
        x = points[:, None] - part_pos[:, :, None, :]
    local = torch.einsum("emba,emnb->emna", part_rot, x)     # Rᵀ(x − t)
    d = grid_query(stack, local, outside_value).amin(dim=-2)
    if ground:
        d = torch.minimum(d, points[..., 2] if points.dim() == 3 else points[None, :, 2])
    return d


def scene_sdf(stack: GridStack, part_rot: torch.Tensor, part_pos: torch.Tensor,
              points: torch.Tensor, ground: bool = True) -> torch.Tensor:
    """Scene SDF [E, N] = min over the parts posed by part_rot [E, M, 3, 3]
    (world from part) and part_pos [E, M, 3] (+ the z = 0 ground), at world
    points [N, 3] or [E, N, 3]; a part contributes +inf outside its grid."""
    return _parts_min(stack, part_rot, part_pos, points, math.inf, ground)


def scene_tsdf(stack: GridStack, part_rot, part_pos, points, sdf_trunc: float,
               ground: bool = True) -> torch.Tensor:
    """Truncated scene SDF in [-1, 1]: as :func:`scene_sdf`, but a part
    contributes ``sdf_trunc`` outside its grid, and the minimum is divided
    by ``sdf_trunc`` and clipped."""
    d = _parts_min(stack, part_rot, part_pos, points, sdf_trunc, ground)
    return torch.clamp(d / sdf_trunc, -1.0, 1.0)


def grid_query_grad(stack: GridStack, gid: torch.Tensor, points: torch.Tensor,
                    outside_value: float):
    """Trilinear SDF value + gradient with a per-query grid index.

    Args:
        gid: int [...] grid index into the stack per query point.
        points: f32 [..., 3] in the grid's local frame.
    Returns:
        (value [...], grad [..., 3]): the analytic gradient of the trilinear
        interpolant; ``outside_value`` and a zero gradient where the query
        lies outside its grid's interior cells.
    """
    X, Y, Z = stack.sdf.shape[1:]
    gid = gid.long()
    bbox = stack.bbox_min[gid]                      # [..., 3]
    vs = stack.voxel_size[gid]                      # [...]
    idx = (points - bbox) / vs[..., None]
    hi = torch.tensor([X - 2, Y - 2, Z - 2], dtype=points.dtype,
                      device=points.device)
    valid = torch.all((idx >= 1.0) & (idx <= hi), dim=-1)
    idx = torch.minimum(torch.clamp(idx, min=0.0), hi)
    i0 = idx.to(torch.int64)
    f = idx - i0
    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]

    flat = stack.sdf.reshape(-1)
    sy, sz = Y * Z, Z
    base = gid * (X * Y * Z) + i0[..., 0] * sy + i0[..., 1] * sz + i0[..., 2]

    def g(d):
        return flat[(base + d).reshape(-1)].reshape(base.shape)

    c000, c001 = g(0), g(1)
    c010, c011 = g(sz), g(sz + 1)
    c100, c101 = g(sy), g(sy + 1)
    c110, c111 = g(sy + sz), g(sy + sz + 1)

    # interpolate down the axes, keeping the partials
    c00 = c000 * (1 - fz) + c001 * fz
    c01 = c010 * (1 - fz) + c011 * fz
    c10 = c100 * (1 - fz) + c101 * fz
    c11 = c110 * (1 - fz) + c111 * fz
    c0 = c00 * (1 - fy) + c01 * fy
    c1 = c10 * (1 - fy) + c11 * fy
    val = c0 * (1 - fx) + c1 * fx

    dval_dx = (c1 - c0)
    dval_dy = ((c01 - c00) * (1 - fx) + (c11 - c10) * fx)
    dval_dz = (((c001 - c000) * (1 - fy) + (c011 - c010) * fy) * (1 - fx)
               + ((c101 - c100) * (1 - fy) + (c111 - c110) * fy) * fx)
    grad = torch.stack([dval_dx, dval_dy, dval_dz], dim=-1) / vs[..., None]
    val = torch.where(valid, val, torch.full_like(val, outside_value))
    grad = torch.where(valid[..., None], grad, torch.zeros_like(grad))
    return val, grad
