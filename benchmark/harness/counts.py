"""The yardstick's arithmetic: the published H100 peaks, the least time of
counted work, and the operations of the port's kernels and networks,
counted from the cell's own shapes and contact states.

``inner_step_flops`` and the B3 count are frozen copies of the counting
functions of ``chip_smoke.py`` (a hand count of ``csrc/fused_inner_step*.cu``,
good to about 20 %, and FPS's 8 operations per distance over the rows'
compacted points); they take the reference copy's env, so a later change
to the program does not move them.
"""

from __future__ import annotations

from typing import Dict, Sequence

# NVIDIA H100 SXM data sheet, dense, at the 700 W power limit
H100_BF16_FLOPS = 989e12
H100_F32_FLOPS = 67e12          # f32 outside the tensor cores
H100_BYTES_PER_S = 3.35e12      # HBM3


def bound_s(ops: float, nbytes: float, peak_flops: float = H100_F32_FLOPS) -> Dict[str, float]:
    """The least time of ``ops`` operations and ``nbytes`` bytes moved, and
    which of the two bounds it."""
    o, b = ops / peak_flops, nbytes / H100_BYTES_PER_S
    return {"s": max(o, b), "by": "operations" if o >= b else "bytes"}


def dense_flops(dims: Sequence[int], rows: float) -> float:
    """Forward multiply-add operations (2 per MAC) of a stack of dense
    layers ``dims[0] → dims[1] → …`` over ``rows`` rows."""
    return 2.0 * rows * sum(a * b for a, b in zip(dims[:-1], dims[1:]))


def pointnet_flops(channels: int, points: int, pooled_extra: int, out: int, rows: float) -> float:
    """Forward operations of the PointNet student (``models/networks.PointNet``):
    the shared per-point 128-256-512 stack over ``points`` points, then
    ``512 (+ proprio) → 128 → 32 → out`` per row."""
    return (dense_flops([channels, 128, 256, 512], rows * points)
            + dense_flops([512 + pooled_extra, 128, 32, out], rows))


def inner_step_flops(env, touching: dict) -> float:
    """f32 operations of ONE inner physics step of one env (kernels B1b /
    B1c, a multiply-add counting 2), with the contact counts ``touching``
    of ``contact_states.touching_counts`` over all envs: the force, anchor
    and JᵀNJ work runs only for touching spheres and (sphere, box / grid)
    pairs.  ``env`` is the reference copy's env of the cell."""
    scene = env.scene
    E = env.num_envs
    ROT, QMUL, JCOL, SDF = 30, 28, 26, 40
    tri = lambda n: n * (n + 1) / 2

    def fk_mass(L, D, tri_sum):
        return (L * (2 * ROT + 2 * QMUL + 40) + D * ROT
                + L * (ROT + 3 + 30 + 90) + L * D * (JCOL + 3 + 15) + tri_sum * 22)

    def tree(D):
        return 2 * (D ** 3 / 3 + 2 * D ** 2) * 2 + D * 60 + 2 * D * D

    def bias(L, D):
        if not scene.params.coriolis:
            return L * 3 + L * D * 8
        return (L * D * 12 + D * D * (JCOL + 6) + D * 9
                + L * D * 45 + L * 60 + L * D * 12)

    trees = [scene.robot] + ([] if scene.obj_tree is None else [scene.obj_tree])
    needs_bias = scene.params.coriolis or any(
        float(t.gravity_scale.abs().max()) != 0.0 for t in trees)
    L, D = scene.robot.num_links, scene.robot.num_dofs
    S = env.spheres.link_idx.shape[0]
    n_anc = scene.robot.ancestor[0].cpu().numpy().sum(1)
    sph_anc = n_anc[env.spheres.link_idx.cpu().numpy()]
    robot = (fk_mass(L, D, float(tri(n_anc).sum())) + tree(D)
             + S * (ROT + 3) + float(sph_anc.sum()) * (JCOL + 6))
    if needs_bias:
        robot += bias(L, D)
    spheres = (touching["ground"] + touching.get("cube", 0) + touching.get("boxes", 0)
               + touching.get("grids", 0)) / E
    if scene.obj_tree is None:
        raise ValueError("inner_step_flops counts the cabinet scenes (B1b / B1c) only")
    Lo, Do = scene.obj_tree.num_links, scene.obj_tree.num_dofs
    o_anc = scene.obj_tree.ancestor.cpu().numpy().sum(-1)
    g_act = float(scene.obj_boxes.geom_mask.sum(-1).float().mean())
    boxes = scene.obj_boxes.link_idx.shape[-1] * (ROT + QMUL + 3)
    per_pair = ((2 * ROT + SDF + 3) + Do * (JCOL + 12) + Do * 12 + 12 + 70 + 27
                + Do * 24 + 9 + (Do * (Do + 1) // 2) * 3)
    partners = 1
    rest = (fk_mass(Lo, Do, float(tri(o_anc).sum(-1).mean())) + tree(Do) + boxes
            + g_act * S * (ROT + 3 + SDF) + touching["box_pairs"] / E * per_pair
            + (bias(Lo, Do) if needs_bias else 0))
    if scene.obj_grids is not None:
        QUERY_IN, QUERY_OUT = 78, 12
        K = scene.obj_grids.link_idx.shape[-1]
        k_act = float(scene.obj_grids.geom_mask.sum(-1).float().mean())
        inside = touching["grid_queries_inside"] / E
        per_grid_pair = per_pair - SDF + QUERY_IN + ROT + 10
        rest += (K * (ROT + QMUL + 3) + k_act * S * (ROT + 3) + inside * QUERY_IN
                 + (k_act * S - inside) * QUERY_OUT
                 + touching["grid_pairs"] / E * per_grid_pair)
    per_touch = (partners * 70 + 120 + 45 + D * (JCOL + 15)
                 + float(tri(sph_anc).mean()) * 6 + float(sph_anc.mean()) * 6)
    return robot + spheres * per_touch + rest


def physics_launch_bytes(env, touching: dict) -> float:
    """Bytes one physics launch must move at least: the scene state read and
    written once (both trees' qpos, qvel, root poses, the anchors) and, with
    mesh-SDF geoms, the 8 cells of every grid query inside a grid."""
    E = env.num_envs
    S = env.spheres.link_idx.shape[0]
    D, Do = env.scene.robot.num_dofs, env.scene.obj_tree.num_dofs
    state = E * (2 * D + 7 + 2 * Do + 7 + S * 4)
    grid = touching.get("grid_queries_inside", 0) * 8 * 4
    return 2.0 * state * 4 + grid


def fps_operations(k: int, compacted_points: float) -> float:
    """Operations of one farthest-point sampling over rows whose live
    (compacted) points number ``compacted_points`` in all: 8 per distance,
    ``k`` rounds."""
    return 8.0 * k * compacted_points


def fps_bytes(rows: int, points: int, k: int) -> float:
    return rows * points * 12.0 + rows * k * 4.0
