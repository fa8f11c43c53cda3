"""Kernels B1b / B1c give each env a warp (``csrc/fused_inner_step_obj.cu``);
what of that design can be checked on a CPU, without nvcc.  The kernel
itself runs only on the card, where ``chip_smoke.py``'s ``kernel_check``
holds it against the plain version; here its lane mapping, partner choice
and solve are plain models, each tied to the source by the lines of the
kernel it models (asserted verbatim, in order), so that a change to those
lines fails here until the model follows it:

* the launch: envs (warps) per block, blocks, and the dynamic shared memory
  of a block (the robot's ``Spec`` once, then per env its ``Work``,
  ``ObjSpec`` and ``GridSpec``) as ``sim/fused.launch_config`` computes
  them from the dims equal the constants and structs read out of the
  source; a block stays within 227 KB and four blocks (16 warps) fit on an
  SM, so 2048 envs run in one wave on 132 SMs;
* the lane mapping of narrowphase pass A covers every (sphere, active box)
  and (sphere, active grid) pair exactly once, in its own depth slot;
* a plain model of the warp's best-partner reduction (masked depths per
  pair, a per-sphere scan in geom order with a strict <, the ground ->
  boxes -> grids order) picks what ``engine._inner_step``'s masked
  ``torch.argmin`` and ``consider`` pick, on exact ties, on -0.0 against
  0.0 and on spheres with no partner, and its ballot counts equal the
  impulse budgets' sums;
* a plain model of the warp Cholesky solve (row per lane, back substitution
  from the last row up) solves what ``ops/linalg`` solves;
* ``csrc/fused_geom.cuh``'s rounding of the contact geometry (each
  operation rounded on its own, ``cross`` as ``fma(a1, b2, -(a2 b1))``)
  equals the plain version's rotations, frame composition and trilinear
  lookup bit for bit (PyTorch rounds them so on the CPU as on the card);
* the C entry points the wrapper binds, the phases of the ``FIS_PHASES``
  build as ``scripts/prof_torch_fused_phases.py`` names them, and no float
  atomics in the source."""

import importlib.util
import math
import os
import re

import numpy as np
import pytest
import torch

import _torch_cu

from partmanip_tpu_torch.ops import linalg
from partmanip_tpu_torch.ops import rotations as rot
from partmanip_tpu_torch.ops import sdf as sdf_ops
from partmanip_tpu_torch.ops.fps import fma_f32
from partmanip_tpu_torch.sim import fused

B1B = (16, 12, 18, 9, 4, 25)                  # open_drawer, box handles
B1C = (16, 12, 18, 9, 4, 21, 4, 29, 73, 73)   # mesh handles, the grid stack's shape
SM_BYTES = 233_472                            # shared memory of an H100 SM (228 KB)
BLOCK_RESERVED = 1024                         # the runtime's share of it per block


def _source(name="fused_inner_step_obj.cu"):
    return _torch_cu.read(os.path.join(os.path.dirname(fused.KERNEL_SOURCE_OBJ), name))


def _assert_lines_in_order(src, lines):
    """Each of ``lines`` is a line of ``src`` (leading and trailing blanks
    aside), each after the one before."""
    text = [ln.strip() for ln in src.splitlines()]
    at = 0
    for line in lines:
        assert line in text[at:], f"not found (in this order) in the source: {line}"
        at += text[at:].index(line) + 1


def _constants(src, dims):
    """The source's compile-time names at these dims: the macros, the state
    row enum and the constexpr sizes (evaluated as the source writes them)."""
    L, D, S, Lo, Do, G = dims[:6]
    K = dims[6] if len(dims) > 6 else 0
    env = {"L": L, "D": D, "S": S, "LO": Lo, "DO": Do, "G": G, "K": K, "FIS_K": K,
           "cmax": max}
    for name, expr in re.findall(r"^\s*(R_\w+|FIS_NF)\s*=\s*([^,\n]+),?$",
                                 re.search(r"enum \{(.*?)\};", src, re.S).group(1), re.M):
        env[name] = eval(expr, {}, env)
    for name in ("TRI", "TRIO", "KG", "SCRATCH"):
        expr = re.search(rf"constexpr int {name} = (.*?);", src, re.S).group(1)
        expr = re.sub(r"(\w+) > 0 \? (\w+) : 1", r"(\2 if \1 > 0 else 1)", expr)
        env[name] = eval(expr.replace("/", "//"), {}, env)
    return env


def _words(src, name, env):
    body = re.search(r"struct %s \{(.*?)\n\};" % name, src, re.S).group(1)
    words = 0
    for _, _, extents in re.findall(r"^\s*(int|float)\s+(\w+)((?:\[\w+\])*);", body, re.M):
        words += math.prod(env[x] if x in env else int(x) for x in re.findall(r"\[(\w+)\]", extents))
    return words


@pytest.mark.parametrize("dims", [B1B, B1C], ids=["b1b", "b1c"])
def test_launch_configuration_matches_the_source(dims):
    src = _source()
    env = _constants(src, dims)
    warps = int(re.search(r"#define FIS_WARPS (\d+)", src).group(1))
    words = {"spec": _words(src, "Spec", env), "obj": _words(src, "ObjSpec", env),
             "grid": _words(src, "GridSpec", env) if len(dims) > 6 else 0,
             "work": _words(src, "Work", env)}
    assert fused.struct_words(dims) == words
    assert "constexpr int SMEM_BYTES = 4 * (SPEC_WORDS + FIS_WARPS * (WORK_WORDS + OBJ_WORDS + GRID_WORDS));" in src
    smem = 4 * (words["spec"] + warps * (words["work"] + words["obj"] + words["grid"]))
    for E in (1, 45, 2048, 16384):
        cfg = fused.launch_config(E, dims)
        assert cfg == {"warps_per_block": warps, "threads": 32 * warps,
                       "blocks": -(-E // warps), "dynamic_smem_bytes": smem,
                       "work_bytes": 4 * words["work"]}
    assert "const int e = blockIdx.x * FIS_WARPS + warp;" in src
    assert src.count("const int blocks = (E + FIS_WARPS - 1) / FIS_WARPS;") == 2
    # within a block's 227 KB, and 16 warps an SM: 2048 envs in one wave of 132 SMs
    assert smem <= fused.SMEM_LIMIT
    blocks_per_sm = SM_BYTES // (smem + BLOCK_RESERVED)
    assert blocks_per_sm * warps >= 16 and blocks_per_sm * warps * 132 >= 2048
    assert f"__launch_bounds__(FIS_THREADS, 16 / FIS_WARPS)" in src


# the kernel's pass A over (sphere, active box) and (sphere, active grid)
# pairs, which _pass_a models; then pass B's scan and partner choice, which
# _warp_partners models
PASS_A_LINES = (
    "const int nb = __popc(bmask);",
    "if (lane < G && ((bmask >> lane) & 1u)) w.gact[__popc(bmask & ((1u << lane) - 1u))] = lane;",
    "float* dsg = jp + S * D * 3;              // [S][G] masked (sphere, box) depths",
    "float* dsk = dsg + S * G;                 // [S][K] masked (sphere, grid) depths",
    "for (int base = 0; base < S * nb; base += 32) {",
    "const int p = base + lane;",
    "if (p < S * nb) {",
    "const int s = p / nb, j = p - s * nb, g = w.gact[j];",
    "touch = depth < 0.0f;",
    "dsg[s * G + j] = touch ? depth : 1e9f;",
    "n_touch += warp_count(touch);",
    "const float n_act_o = fmaxf(1.0f, (float)n_touch);",
    "for (int base = 0; base < S * nk; base += 32) {",
    "const int p = base + lane;",
    "if (p < S * nk) {",
    "const int s = p / nk, j = p - s * nk, k = w.kact[j];",
    "touch = norm_t(grad) > 1e-6f && depth < 0.0f;",
    "dsk[s * K + j] = touch ? depth : 1e9f;",
    "n_touch += warp_count(touch);",
    "const float n_act_k = fmaxf(1.0f, (float)n_touch);",
)
PASS_B_LINES = (
    "for (int j = 0; j < nb; ++j) {",
    "const float dd = dsg[s * G + j];",
    "if (dd < 0.0f) {",
    "const int g = w.gact[j];",
    "if (dd < best_bd) {",
    "best_bd = dd;",
    "best_g = g;",
    "for (int j = 0; j < nk; ++j) {",
    "const float dd = dsk[s * K + j];",
    "if (dd < 0.0f) {",
    "const int k = w.kact[j];",
    "if (dd < best_kd) {",
    "best_kd = dd;",
    "best_k = k;",
    "int id = -1;",
    "float bd = 1e9f;",
    "if (dg < 0.0f && dg < bd) { id = 0; bd = dg; }",
    "if (best_g >= 0 && best_bd < bd) { id = 2 + best_g; bd = best_bd; }",
    "if (best_k >= 0 && best_kd < bd) { id = KOFF + best_k; bd = best_kd; }",
)


def _pass_a(S, active):
    """Pass A's lanes: (iteration, lane) -> (sphere, geom, depth slot) for
    the env's active geoms, as the kernel's loop walks them
    (``PASS_A_LINES``)."""
    act = [g for g, a in enumerate(active) if a]
    nb, G = len(act), len(active)
    pairs = []
    for base in range(0, S * nb, 32):
        for lane in range(32):
            p = base + lane
            if p < S * nb:
                s, j = divmod(p, nb)
                pairs.append((s, act[j], s * G + j))
    return pairs


@pytest.mark.parametrize("S,G", [(18, 25), (18, 21), (18, 4)], ids=["G25", "G21", "K4"])
def test_pass_a_lanes_cover_every_pair_once(S, G):
    _assert_lines_in_order(_source(), PASS_A_LINES)
    rs = np.random.RandomState(G)
    for active in ([True] * G, list(rs.rand(G) < 0.6), [False] * G):
        pairs = _pass_a(S, active)
        want = sorted((s, g) for s in range(S) for g in range(G) if active[g])
        assert sorted((s, g) for s, g, _ in pairs) == want
        assert len({slot for _, _, slot in pairs}) == len(pairs)
        assert all(slot < S * G for _, _, slot in pairs)


def _warp_partners(dg, d_box, box_on, d_grid, grid_on):
    """Plain model of the kernel's partner choice for one env: pass A's
    masked depths in their slots and ballot counts, then per sphere the
    scan in geom order (first minimum, strict <) and ground -> boxes ->
    grids with a strict < (``PASS_A_LINES``, ``PASS_B_LINES``).  Returns
    (partner ids, box count, grid count)."""
    S, G = d_box.shape
    K = d_grid.shape[1]
    big = np.float32(1e9)
    slot_b = np.full(S * G, np.nan, np.float32)
    n_box = 0
    for s, g, slot in _pass_a(S, box_on):
        touch = d_box[s, g] < 0
        slot_b[slot] = d_box[s, g] if touch else big
        n_box += int(touch)
    slot_k = np.full(S * K, np.nan, np.float32)
    n_grid = 0
    for s, k, slot in _pass_a(S, [True] * K):
        touch = bool(grid_on[s, k]) and d_grid[s, k] < 0
        slot_k[slot] = d_grid[s, k] if touch else big
        n_grid += int(touch)
    act_b = [g for g in range(G) if box_on[g]]
    ids = []
    for s in range(S):
        best_b, gb = big, -1
        for j, g in enumerate(act_b):
            if slot_b[s * G + j] < 0 and slot_b[s * G + j] < best_b:
                best_b, gb = slot_b[s * G + j], g
        best_k, kb = big, -1
        for k in range(K):
            if slot_k[s * K + k] < 0 and slot_k[s * K + k] < best_k:
                best_k, kb = slot_k[s * K + k], k
        pid, bd = -1, big
        if dg[s] < 0 and dg[s] < bd:
            pid, bd = 0, dg[s]
        if gb >= 0 and best_b < bd:
            pid, bd = 2 + gb, best_b
        if kb >= 0 and best_k < bd:
            pid, bd = 2 + G + kb, best_k
        ids.append(pid)
    return ids, n_box, n_grid


def _engine_partners(dg, d_box, box_on, d_grid, grid_on):
    """What engine._inner_step picks: masked argmin per contact set and
    ``consider`` in the order ground, boxes, grids."""
    dg, d_box, d_grid = (torch.as_tensor(x)[None] for x in (dg, d_box, d_grid))
    S, G = d_box.shape[1:]
    best_depth = torch.full((1, S), 1e9)
    best_id = torch.full((1, S), -1, dtype=torch.int32)

    def consider(depth, pid, touch):
        nonlocal best_depth, best_id
        better = (depth < best_depth) & (touch > 0)
        best_depth = torch.where(better, depth, best_depth)
        best_id = torch.where(better, pid, best_id)

    consider(dg, torch.zeros((1, S), dtype=torch.int32), (dg < 0).float())
    t_box = (d_box < 0).float() * torch.as_tensor(box_on, dtype=torch.float32)
    t_grid = (d_grid < 0).float() * torch.as_tensor(grid_on, dtype=torch.float32)[None]
    for d, t, off in ((d_box, t_box, 2), (d_grid, t_grid, 2 + G)):
        masked = torch.where(t > 0, d, 1e9)
        best = torch.argmin(masked, dim=-1)
        take = lambda a: torch.gather(a, 2, best[..., None])[..., 0]
        consider(take(d), (off + best).to(torch.int32), (take(masked) < 0).float())
    return best_id[0].tolist(), int(t_box.sum()), int(t_grid.sum())


def test_best_partner_model_matches_the_engine_argmin():
    src = _source()
    _assert_lines_in_order(src, PASS_A_LINES)
    _assert_lines_in_order(src, PASS_B_LINES)
    assert "const int KOFF = 2 + G;" in src
    rs = np.random.RandomState(7)
    S, G, K = 18, 25, 4
    # depths on a coarse grid, so that exact ties are common
    d_box = (rs.randint(-4, 3, (S, G)) * 0.005).astype(np.float32)
    d_grid = (rs.randint(-4, 3, (S, K)) * 0.005).astype(np.float32)
    dg = (rs.randint(-4, 3, S) * 0.005).astype(np.float32)
    box_on = rs.rand(G) < 0.7
    grid_on = rs.rand(S, K) < 0.8            # gradient norm above 1e-6
    box_on[[3, 7, 9]] = [True, True, False]
    d_box[0], d_box[0, [3, 7]] = 0.01, -0.01         # two boxes tie: the first
    d_box[1], dg[1], d_box[1, 7] = 0.01, -0.02, -0.02  # box ties ground: ground
    d_box[2], dg[2], d_box[2, 3] = 0.01, 0.01, -0.015  # box ties grid: the box
    d_grid[2], d_grid[2, 1], grid_on[2] = 0.01, -0.015, True
    d_box[3], d_grid[3], dg[3] = 0.01, 0.01, np.float32(-0.0)  # -0.0 and 0.0 touch nothing
    d_box[3, 3], d_box[3, 7], d_grid[3, 0] = np.float32(-0.0), 0.0, np.float32(-0.0)
    d_box[4], d_grid[4], dg[4] = 0.01, 0.01, 0.01     # no partner
    d_box[5], d_box[5, 9], d_box[5, 3] = 0.01, -0.05, -0.01  # the deepest box is off
    d_grid[6], grid_on[6], dg[6], d_box[6] = -0.03, [False, True, True, False], 0.01, 0.01
    d_grid[6, 2] = -0.04
    want = _engine_partners(dg, d_box, box_on, d_grid, grid_on)
    got = _warp_partners(dg, d_box, box_on, d_grid, grid_on)
    assert got == want
    ids = got[0]
    assert ids[:7] == [5, 0, 5, -1, -1, 5, 2 + G + 2]
    assert len(set(ids)) > 5 and ids.count(-1) < S


# fused_warp.cuh's spd_solve_warp, which _warp_spd_solve models: the
# factor's columns, the forward and the back substitution
SOLVE_LINES = (
    "for (int j = 0; j < N; ++j) {",
    "float r = row[j];",
    "for (int k = 0; k < j; ++k) r -= __shfl_sync(FIS_FULL_MASK, row[k], base + j) * row[k];",
    "const float ljj = sqrtf(fmaxf(__shfl_sync(FIS_FULL_MASK, r, base + j), 1e-12f));",
    "const float q = div_pos(r, ljj, ri > j);",
    "row[j] = ri == j ? ljj : q;",
    "for (int i = 0; i < N; ++i) {",
    "const float yi = __shfl_sync(FIS_FULL_MASK, div_pos(s, row[i], ri == i), base + i);",
    "y = ri == i ? yi : y;",
    "s = ri > i ? s - row[i] * yi : s;",
    "if (k <= ri) Lsh[ri * N + k] = row[k];",
    "for (int i = N - 1; i >= 0; --i) {",
    "const float xi = __shfl_sync(FIS_FULL_MASK, div_pos(t, row[i], ri == i), base + i);",
    "x = ri == i ? xi : x;",
    "t = ri < i ? t - Lsh[i * N + (ri < i ? ri : 0)] * xi : t;",
)


def _warp_spd_solve(A, b):
    """Plain model of fused_warp.cuh's spd_solve_warp in f32 (``SOLVE_LINES``):
    the factor column by column (each lane's sum in k order), forward
    substitution in k order, back substitution from the last row up."""
    N = A.shape[0]
    f = np.float32
    Lm = np.tril(A).astype(f)
    for j in range(N):
        r = Lm[:, j].copy()
        for k in range(j):
            r[j:] = r[j:] - Lm[j, k] * Lm[j:, k]
        ljj = f(np.sqrt(max(r[j], f(1e-12))))
        Lm[j, j] = ljj
        Lm[j + 1:, j] = r[j + 1:] / ljj
    s, y = b.astype(f).copy(), np.zeros(N, f)
    for i in range(N):
        y[i] = s[i] / Lm[i, i]
        s[i + 1:] = s[i + 1:] - Lm[i + 1:, i] * y[i]
    t, x = y.copy(), np.zeros(N, f)
    for i in range(N - 1, -1, -1):
        x[i] = t[i] / Lm[i, i]
        t[:i] = t[:i] - Lm[i, :i] * x[i]
    return x


@pytest.mark.parametrize("N", [12, 4])
def test_warp_cholesky_model_solves_what_linalg_solves(N):
    _assert_lines_in_order(_source("fused_warp.cuh"), SOLVE_LINES)
    rs = np.random.RandomState(N)
    B = rs.randn(N, N)
    A = (B @ B.T + N * np.eye(N)).astype(np.float32)
    b = rs.randn(N).astype(np.float32)
    got = _warp_spd_solve(A, b)
    L = linalg.cholesky_factor(torch.as_tensor(A)[None])
    want = linalg.cholesky_solve(L, torch.as_tensor(b)[None])[0].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, np.linalg.solve(A.astype(np.float64), b), rtol=1e-4, atol=1e-5)


def _cross_t(a, b):
    """fused_geom.cuh cross_t."""
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([fma_f32(a1, b2, -(a2 * b1)), fma_f32(a2, b0, -(a0 * b2)),
                        fma_f32(a0, b1, -(a1 * b0))], -1)


def _quat_rotate_t(q, v):
    """fused_geom.cuh quat_rotate_t: (v + t w) + qv x t, t = (qv x v) 2."""
    qv, w = q[..., :3], q[..., 3:]
    t = _cross_t(qv, v) * 2.0
    return (v + t * w) + _cross_t(qv, t)


def _quat_mul_t(a, b):
    """fused_geom.cuh quat_mul_t, left to right."""
    ax, ay, az, aw = a.unbind(-1)
    bx, by, bz, bw = b.unbind(-1)
    return torch.stack([((aw * bx + ax * bw) + ay * bz) - az * by,
                        ((aw * by - ax * bz) + ay * bw) + az * bx,
                        ((aw * bz + ax * by) - ay * bx) + az * bw,
                        ((aw * bw - ax * bx) - ay * by) - az * bz], -1)


def _grid_lookup_t(stack, gid, p):
    """The kernel's grid_query_grad inside the interior cells: the index,
    the fractions and a * (1 - f) + b * f, each operation rounded."""
    X, Y, Z = stack.sdf.shape[1:]
    idx = (p - stack.bbox_min[gid]) / stack.voxel_size[gid][:, None]
    i0 = idx.to(torch.int64)
    f = idx - i0.to(idx.dtype)
    g = 1.0 - f
    c = lambda dx, dy, dz: stack.sdf[gid, i0[:, 0] + dx, i0[:, 1] + dy, i0[:, 2] + dz]
    lerp = lambda a, b, k: a * g[:, k] + b * f[:, k]
    c00, c01 = lerp(c(0, 0, 0), c(0, 0, 1), 2), lerp(c(0, 1, 0), c(0, 1, 1), 2)
    c10, c11 = lerp(c(1, 0, 0), c(1, 0, 1), 2), lerp(c(1, 1, 0), c(1, 1, 1), 2)
    c0, c1 = lerp(c00, c01, 1), lerp(c10, c11, 1)
    val = lerp(c0, c1, 0)
    dz = lerp(lerp(c(0, 0, 1) - c(0, 0, 0), c(0, 1, 1) - c(0, 1, 0), 1),
              lerp(c(1, 0, 1) - c(1, 0, 0), c(1, 1, 1) - c(1, 1, 0), 1), 0)
    grad = torch.stack([c1 - c0, lerp(c01 - c00, c11 - c10, 0), dz], -1)
    return val, grad / stack.voxel_size[gid][:, None]


def test_contact_geometry_rounds_as_the_plain_version():
    rs = np.random.RandomState(5)
    n = 4096
    q, q2 = (torch.as_tensor(rs.randn(n, 4).astype(np.float32)) for _ in range(2))
    q, q2 = rot.quat_unit(q), rot.quat_unit(q2)
    v, p = (torch.as_tensor(rs.randn(n, 3).astype(np.float32)) for _ in range(2))
    assert torch.equal(_quat_rotate_t(q, v), rot.quat_rotate(q, v))
    assert torch.equal(_quat_rotate_t(rot.quat_conjugate(q), v), rot.quat_rotate_inverse(q, v))
    assert torch.equal(_quat_mul_t(q, q2), rot.quat_mul(q, q2))
    pos, quat = rot.transform_compose(p, q, v, q2)      # compose_t
    assert torch.equal(pos, _quat_rotate_t(q, v) + p) and torch.equal(quat, _quat_mul_t(q, q2))
    # the trilinear lookup at points inside the interior cells of 3 grids
    M, X, Y, Z = 3, 7, 6, 5
    stack = sdf_ops.GridStack(
        sdf=torch.as_tensor(rs.randn(M, X, Y, Z).astype(np.float32)),
        bbox_min=torch.as_tensor(rs.randn(M, 3).astype(np.float32)),
        voxel_size=torch.as_tensor(rs.uniform(0.003, 0.006, M).astype(np.float32)))
    gid = torch.as_tensor(rs.randint(0, M, n))
    cells = torch.as_tensor(rs.uniform(1.0, np.array([X, Y, Z]) - 2.0, (n, 3)).astype(np.float32))
    pts = stack.bbox_min[gid] + cells * stack.voxel_size[gid][:, None]
    val, grad = sdf_ops.grid_query_grad(stack, gid, pts, outside_value=1.0)
    want_val, want_grad = _grid_lookup_t(stack, gid, pts)
    inside = val != 1.0
    assert int(inside.sum()) > n // 2
    assert torch.equal(val[inside], want_val[inside]) and torch.equal(grad[inside], want_grad[inside])


def test_c_entry_points_and_no_float_atomics():
    src, header = _source(), _source("fused_warp.cuh")
    for text in (src, header):
        assert "atomic" not in text.replace("No float atomics", "").replace("no atomics", "")
    assert all(f'#include "{h}"' in src for h in ("fused_warp.cuh", "fused_geom.cuh"))
    assert "spd_solve_warp<D>" in src
    with open(fused.KERNEL_SOURCE) as f:
        assert "fused_warp.cuh" in f.read()          # B1a splits an env over a half-warp
    # the FIS_PHASES build's phases, as scripts/prof_torch_fused_phases.py names them
    script = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "scripts", "prof_torch_fused_phases.py")
    spec = importlib.util.spec_from_file_location("prof_torch_fused_phases", script)
    prof = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(prof)
    nphase = len(prof.PHASE_NAMES)
    assert f"#define FIS_NPHASE {nphase}" in src
    assert sorted(map(int, re.findall(r"PHASE\((\d)\)\n", src))) == list(range(nphase))
    assert "ph_out[FIS_NPHASE + 2] = fis_globaltimer();" in _source("fused_phases.cuh")
    assert '#include "fused_phases.cuh"' in src
    for variant, dims in (("b1b", B1B), ("b1c", B1C)):
        sigs = fused.library(variant, dims).signatures
        for name in ("fis_launch_config", "fis_occupancy", "fis_obj_bytes", "fis_launch"):
            params = re.search(rf"int {name}\((.*?)\)", src, re.S).group(1)
            n = 0 if not params.strip() else len(params.split(","))
            if name == "fis_launch":               # the B1b and B1c overloads
                n = len(re.findall(rf"int {name}\((.*?)\)", src, re.S)[
                    0 if variant == "b1c" else 1].split(","))
            assert len(sigs[name][0]) == n, (variant, name)
