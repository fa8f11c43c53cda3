"""Kernel B1a gives each env a half-warp, two envs a warp
(``csrc/fused_inner_step.cu``); what of that design can be checked on a
CPU, without nvcc.  The kernel itself runs only on the card, where
``chip_smoke.py``'s ``kernel_check`` holds it against the plain version;
here its launch, lane mapping, ballots, solve and free-body split are plain
models, each tied to the source by the lines of the kernel it models
(asserted verbatim, in order), so that a change to those lines fails here
until the model follows it:

* the launch: envs per warp and per block, blocks, and the dynamic shared
  memory of a block (the robot's ``Spec`` once, then a ``Work`` per env) as
  ``sim/fused.launch_config`` computes them from the dims equal the
  constants and structs read out of the source; at least 16 envs fit on an
  SM, so 2048 envs run in one wave on 132 SMs;
* the lane mapping: two envs a warp, every link, (link, dof) column, mass
  entry, sphere, touching (sphere, dof) pair, corner, axis, quaternion
  component and J^T N J entry owned by exactly one lane of its env's half,
  and the ragged edge at odd E (the half-warp past E reruns env E - 1 and
  stores nothing);
* the half-warp ballots and butterfly sums keep the two envs apart, and
  pass A's budgets, partners and touching list equal what
  ``engine._inner_step`` counts and picks (ties, -0.0, no partner);
* the warp Cholesky solve with two systems in a warp (base 0 and 16, N = 9)
  solves what ``ops/linalg`` solves;
* the box distance, the sphere's point in the box frame and the corners, as
  ``csrc/fused_geom.cuh`` rounds them, equal ``sim/contact``'s plain
  functions bit for bit, on points on the box's faces too;
* the free body's integration split over lanes (a row of the cofactor
  inverse per axis, a quaternion component per lane) computes what
  ``contact.integrate_free_body`` computes;
* the C entry points the wrapper binds, the phases of the ``FIS_PHASES``
  build as ``scripts/prof_torch_fused_phases.py`` names them, no
  ``__constant__`` memory and no float atomics."""

import importlib.util
import math
import os
import re

import numpy as np
import torch

import _torch_cu

from partmanip_tpu_torch.ops import linalg
from partmanip_tpu_torch.ops import rotations as rot
from partmanip_tpu_torch.sim import contact, fused
from partmanip_tpu_torch.sim.types import FreeBodySpec, FreeBodyState
from test_torch_fused_warp import _assert_lines_in_order, _quat_rotate_t

DIMS = (13, 9, 18)                            # grasp_cube: L, D, S
SM_BYTES = 233_472                            # shared memory of an H100 SM (228 KB)
BLOCK_RESERVED = 1024                         # the runtime's share of it per block


def _source(name="fused_inner_step.cu"):
    return _torch_cu.read(os.path.join(os.path.dirname(fused.KERNEL_SOURCE), name))


def _constants(src, dims):
    """The source's compile-time names at these dims: the state row enum
    and the constexpr sizes (evaluated as the source writes them)."""
    L, D, S = dims
    env = {"L": L, "D": D, "S": S, "cmax": lambda *a: max(a)}
    for name, expr in re.findall(r"^\s*(R_\w+|FIS_NF)\s*=\s*([^,\n]+),?$",
                                 re.search(r"enum \{(.*?)\};", src, re.S).group(1), re.M):
        env[name] = eval(expr, {}, env)
    env["FIS_WARPS"] = int(re.search(r"#define FIS_WARPS (\d+)", src).group(1))
    for name in ("TRI", "SROUND", "SCRATCH", "FIS_ENVS", "FIS_THREADS"):
        expr = re.search(rf"constexpr int {name} = (.*?);", src, re.S).group(1)
        env[name] = eval(expr.replace("/", "//"), {}, env)
    return env


def _words(src, name, env):
    body = re.search(r"struct %s \{(.*?)\n\};" % name, src, re.S).group(1)
    words = 0
    for _, _, extents in re.findall(r"^\s*(int|float)\s+(\w+)((?:\[\w+\])*);", body, re.M):
        words += math.prod(env[x] if x in env else int(x) for x in re.findall(r"\[(\w+)\]", extents))
    return words


def test_launch_configuration_matches_the_source():
    src = _source()
    env = _constants(src, DIMS)
    words = {"spec": _words(src, "Spec", env), "work": _words(src, "Work", env)}
    assert fused.struct_words(DIMS) == words
    assert "constexpr int SMEM_BYTES = 4 * (SPEC_WORDS + FIS_ENVS * WORK_WORDS);" in src
    envs, threads = env["FIS_ENVS"], env["FIS_THREADS"]
    assert (envs, threads) == (2 * env["FIS_WARPS"], 32 * env["FIS_WARPS"])
    smem = 4 * (words["spec"] + envs * words["work"])
    for E in (1, 45, 2048, 16384):
        assert fused.launch_config(E, DIMS) == {
            "envs_per_warp": 2, "warps_per_block": env["FIS_WARPS"], "envs_per_block": envs,
            "threads": threads, "blocks": -(-E // envs), "dynamic_smem_bytes": smem,
            "work_bytes": 4 * words["work"]}
    assert "const int blocks = (E + FIS_ENVS - 1) / FIS_ENVS;" in src
    assert "const int cfg[4] = {FIS_ENVS, FIS_THREADS, SMEM_BYTES, 2};" in src
    # blocks an SM: the launch bounds' minimum (128 registers a thread) and
    # what fits in 228 KB; at least 16 envs an SM, 2048 envs in one wave
    assert "__launch_bounds__(FIS_THREADS, 16 / FIS_WARPS)" in src
    assert smem <= fused.SMEM_LIMIT
    blocks_per_sm = min(16 // env["FIS_WARPS"], SM_BYTES // (smem + BLOCK_RESERVED))
    assert blocks_per_sm * envs >= 16 and blocks_per_sm * envs * 132 >= 2048
    assert 65536 // (blocks_per_sm * threads) >= 96          # registers a thread at that occupancy


# which lanes own what, phase by phase (the phases' functions, then the
# kernel: the env of each half-warp, the sphere rounds, the touching spheres)
LANE_LINES = (
    "if (hl >= 1 && hl < L) {                  // the joint of link hl",
    "if (hl == 0) {                            // the chain, root first",
    "if (hl < D) {",
    "if (hl < L) {",
    "for (int i = hl; i < L * D; i += 16) {",
    "const int i = hl + 16 * k < TRI ? hl + 16 * k : TRI - 1;",
    "if (hl + 16 * k < TRI) w.M[hl + 16 * k] = m[k];",
    "if (hl < 8)",
    "const int ax = hl < 3 ? hl : 0;",
    "const int k = hl < 4 ? hl : 0;",
    "if (hl < 3) {",
    "if (hl < 4) w.st[R_BQUAT + k] = qk;",
    "const int i = hl + 16 * k < NT ? hl + 16 * k : NT - 1;",
    "if (i < TRI) w.Ac[i] = acc[k];",
    "else if (i < NT) w.tau[i - TRI] = acc[k];",
    "const bool real = hl < D;",
    "const int hl = lane & 15, base = lane & 16;   // lane in the env's half-warp, the half's first lane",
    "const int slot = 2 * warp + (lane >> 4);       // the env's slot in the block",
    "const int e = blockIdx.x * FIS_ENVS + slot;",
    "if (blockIdx.x * FIS_ENVS + 2 * warp >= E) return;   // neither env of the warp exists",
    "const bool live = e < E;",
    "const int ee = live ? e : E - 1;",
    "for (int r = hl; r < R_ANCP; r += 16) w.st[r] = in[(size_t)r * E + ee];",
    "const int s = hl + 16 * k;",
    "if (s < S && ((touching >> s) & 1u)) w.tl[__popc(touching & ((1u << s) - 1u))] = s;",
    "for (int i = hl; i < nt * D; i += 16) {",
    "for (int j = hl; j < nt; j += 16)",
    "if (live) {",
    "for (int r = hl; r < R_ANCP; r += 16) out[(size_t)r * E + e] = w.st[r];",
)


def _owners(n_items, lanes_of):
    """{item: [lanes]} of one env's half, lanes_of(hl) -> the items lane hl
    takes."""
    own = {}
    for hl in range(16):
        for item in lanes_of(hl):
            own.setdefault(item, []).append(hl)
    return own


def test_lane_mapping_two_envs_a_warp_each_item_once():
    src = _source()
    _assert_lines_in_order(src, LANE_LINES)
    env = _constants(src, DIMS)
    L, D, S, TRI, SROUND = DIMS + (env["TRI"], env["SROUND"])
    ENVS, W = env["FIS_ENVS"], env["FIS_WARPS"]
    NT = TRI + D
    # the envs: each owned by exactly one live half-warp; a half past E
    # reruns env E - 1 and stores nothing; a warp past E returns whole
    for E in (1, 2, 45, 2048):
        stored, ran_in_warps = {}, []
        for b in range(-(-E // ENVS)):
            for warp in range(W):
                if b * ENVS + 2 * warp >= E:
                    continue                                  # returns
                halves = []
                for lane in range(32):
                    e = b * ENVS + 2 * warp + (lane >> 4)
                    live = e < E
                    ee = e if live else E - 1
                    halves.append((ee, live))
                    if live:
                        stored.setdefault(e, set()).add(lane & 16)
                ran_in_warps.append({ee for ee, _ in halves})
        assert sorted(stored) == list(range(E)) and all(len(v) == 1 for v in stored.values())
        assert all(len(envs) >= 1 and max(envs) < E for envs in ran_in_warps)
        assert len(ran_in_warps) == -(-E // 2)                 # warps that run
    # within a half: every item of every phase owned by exactly one lane
    phases = {
        "joints": (range(1, L), lambda hl: [hl] if 1 <= hl < L else []),
        "links": (range(L), lambda hl: [hl] if hl < L else []),
        "dofs": (range(D), lambda hl: [hl] if hl < D else []),
        "link_dof": (range(L * D), lambda hl: range(hl, L * D, 16)),
        "mass_entries": (range(TRI), lambda hl: [hl + 16 * k for k in range(-(-TRI // 16))
                                                 if hl + 16 * k < TRI]),
        "spheres": (range(S), lambda hl: [hl + 16 * k for k in range(SROUND) if hl + 16 * k < S]),
        "corners": (range(8), lambda hl: [hl] if hl < 8 else []),
        "axes": (range(3), lambda hl: [hl] if hl < 3 else []),
        "quat": (range(4), lambda hl: [hl] if hl < 4 else []),
        "jt_entries": (range(NT), lambda hl: [hl + 16 * k for k in range(-(-NT // 16))
                                              if hl + 16 * k < NT]),
    }
    for nt in (0, 1, 16, S):                    # touching spheres
        phases[f"touching_{nt}"] = (range(nt), lambda hl, nt=nt: range(hl, nt, 16))
        phases[f"touching_dofs_{nt}"] = (range(nt * D), lambda hl, nt=nt: range(hl, nt * D, 16))
    for name, (items, lanes_of) in phases.items():
        own = _owners(len(items), lanes_of)
        assert sorted(own) == list(items), name
        assert all(len(v) == 1 for v in own.values()), name
    # the touching list: the k-th touching sphere in slot k, ascending
    rs = np.random.RandomState(1)
    for _ in range(20):
        touching = int(rs.randint(0, 1 << S))
        tl = {}
        for hl in range(16):
            for k in range(SROUND):
                s = hl + 16 * k
                if s < S and (touching >> s) & 1:
                    tl[bin(touching & ((1 << s) - 1)).count("1")] = s
        assert [tl[j] for j in range(len(tl))] == [s for s in range(S) if (touching >> s) & 1]


# fused_warp.cuh's half-warp helpers
HALF_LINES = (
    "return (__ballot_sync(FIS_FULL_MASK, pred) >> base) & 0xffffu;",
    "return __popc(half_ballot(pred, base));",
    "for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(FIS_FULL_MASK, v, off);",
)


def _half_ballot(pred, base):
    """pred: bool [32] (a warp's lanes) -> the 16-bit mask of base's half."""
    m = sum(1 << i for i in range(32) if pred[i])
    return (m >> base) & 0xFFFF


def _half_sum(v):
    """v: f32 [32] -> the butterfly over xor 8, 4, 2, 1, every lane."""
    v = np.asarray(v, np.float32).copy()
    for off in (8, 4, 2, 1):
        v = (v + v[np.arange(32) ^ off]).astype(np.float32)
    return v


# pass A's lines, which _pass_a models
PASS_A_LINES = (
    "const int s = hl + 16 * k;",
    "if (s < S) {",
    "const float dg = c.z - r;",
    "tg = dg < 0.0f;",
    "tb = db < 0.0f;",
    "float bd = 1e9f;",
    "if (tg && dg < bd) { id = 0; bd = dg; }",
    "if (tb && db < bd) { id = 1; bd = db; }",
    "if (id < 0) w.anc_b[s] = -1;      // touches nothing: the anchor is released",
    "n_g += half_count(tg, base);",
    "n_b += half_count(tb, base);",
    "n_c += half_count(id == 1, base);",
    "touching |= half_ballot(id >= 0, base) << (16 * k);",
    "const float n_act_g = fmaxf(1.0f, (float)n_g);",
    "const float n_act_b = fmaxf(1.0f, (float)n_b);",
    "const float n_touch_box = fmaxf(1.0f, (float)n_c);",
)


def _pass_a(dg, db):
    """Plain model of a warp's pass A for two envs (dg, db: f32 [2, S], env
    h on half h): per env the partner ids and the ballot counts (ground,
    box, partner box) and the touching mask."""
    S = dg.shape[1]
    ids = np.full((2, S), -1)
    counts = np.zeros((2, 3), int)
    touching = [0, 0]
    for k in range(-(-S // 16)):
        tg, tb, pid = np.zeros(32, bool), np.zeros(32, bool), np.full(32, -1)
        for lane in range(32):
            h, s = lane >> 4, (lane & 15) + 16 * k
            if s < S:
                tg[lane], tb[lane] = dg[h, s] < 0, db[h, s] < 0
                bd = np.float32(1e9)
                if tg[lane] and dg[h, s] < bd:
                    pid[lane], bd = 0, dg[h, s]
                if tb[lane] and db[h, s] < bd:
                    pid[lane], bd = 1, db[h, s]
                ids[h, s] = pid[lane]
        for h in range(2):
            base = 16 * h
            counts[h] += [bin(_half_ballot(x, base)).count("1") for x in (tg, tb, pid == 1)]
            touching[h] |= _half_ballot(pid >= 0, base) << (16 * k)
    return ids, counts, touching


def test_half_warp_ballots_and_pass_a_match_the_engine():
    _assert_lines_in_order(_source("fused_warp.cuh"), HALF_LINES)
    _assert_lines_in_order(_source(), PASS_A_LINES)
    # the butterfly: each half its own sum on all its lanes, the same bits
    rs = np.random.RandomState(3)
    v = rs.randn(32).astype(np.float32)
    got = _half_sum(v)
    for h in range(2):
        half = got[16 * h:16 * h + 16]
        assert np.all(half.view(np.int32) == half[0].view(np.int32))
        np.testing.assert_allclose(half[0], v[16 * h:16 * h + 16].astype(np.float64).sum(),
                                   rtol=1e-6)
    # pass A of two envs in one warp against engine._inner_step's counts
    # and partner choice (consider: ground, then the box, strict <)
    S = 18
    dg = (rs.randint(-3, 3, (2, S)) * 0.005).astype(np.float32)
    db = (rs.randint(-3, 3, (2, S)) * 0.005).astype(np.float32)
    dg[0, 0], db[0, 0] = -0.01, -0.01            # tie: the ground
    dg[0, 1], db[0, 1] = np.float32(-0.0), 0.0   # -0.0 touches nothing
    dg[0, 17], db[0, 17] = 0.01, -0.02           # the second round: the box
    dg[1], db[1] = 0.01, 0.01                    # the other env touches nothing ...
    dg[1, 16] = -0.03                            # ... but one sphere of round 2
    ids, counts, touching = _pass_a(dg, db)
    for h in range(2):
        t_g, t_b = torch.as_tensor(dg[h] < 0), torch.as_tensor(db[h] < 0)
        best_depth = torch.full((S,), 1e9)
        best_id = torch.full((S,), -1)
        for depth, pid, t in ((torch.as_tensor(dg[h]), 0, t_g), (torch.as_tensor(db[h]), 1, t_b)):
            better = (depth < best_depth) & t
            best_depth = torch.where(better, depth, best_depth)
            best_id = torch.where(better, pid, best_id)
        assert ids[h].tolist() == best_id.tolist()
        assert counts[h].tolist() == [int(t_g.sum()), int(t_b.sum()), int((best_id == 1).sum())]
        assert touching[h] == sum(1 << s for s in range(S) if best_id[s] >= 0)
    assert ids[0, :2].tolist() == [0, -1] and ids[0, 17] == 1
    assert touching[1] == 1 << 16


# fused_warp.cuh's spd_solve_warp, which _warp_solve_lanes models lane by lane
SOLVE_LINES = (
    "for (int k = 0; k < j; ++k) r -= __shfl_sync(FIS_FULL_MASK, row[k], base + j) * row[k];",
    "const float ljj = sqrtf(fmaxf(__shfl_sync(FIS_FULL_MASK, r, base + j), 1e-12f));",
    "const float q = div_pos(r, ljj, ri > j);",
    "row[j] = ri == j ? ljj : q;",
    "const float yi = __shfl_sync(FIS_FULL_MASK, div_pos(s, row[i], ri == i), base + i);",
    "y = ri == i ? yi : y;",
    "s = ri > i ? s - row[i] * yi : s;",
    "if (k <= ri) Lsh[ri * N + k] = row[k];",
    "const float xi = __shfl_sync(FIS_FULL_MASK, div_pos(t, row[i], ri == i), base + i);",
    "x = ri == i ? xi : x;",
    "t = ri < i ? t - Lsh[i * N + (ri < i ? ri : 0)] * xi : t;",
    "row[f] = real ? a : (f == ri ? 1.0f : 0.0f);",
)
# and B1a's call: a lane per dof, the lanes past D with zero rows
B1A_SOLVE_LINES = (
    "const bool real = hl < D;",
    "float qacc = spd_solve_warp<D>(row, real ? (tau_d0 + tau_fric + te) * mask : 0.0f, w.scratch,",
)


def _warp_solve_lanes(systems, N):
    """Plain model of spd_solve_warp<N> on the 32 lanes of a warp in f32,
    two systems (A, b) on the halves (ri = lane & 15, base = lane & 16),
    lanes with ri >= N on zero rows; returns x of every lane."""
    f32 = np.float32
    lanes = np.arange(32)
    ri, base = lanes & 15, lanes & 16
    row, b = np.zeros((32, N), f32), np.zeros(32, f32)
    for lane in range(32):
        A, bb = systems[lane >> 4]
        if ri[lane] < N:
            row[lane, :ri[lane] + 1] = A[ri[lane], :ri[lane] + 1]
            b[lane] = bb[ri[lane]]

    def div_pos(a, d, use):
        go = use & (a != 0)
        return np.where(go, a / np.where(go, d, f32(1)), a).astype(f32)

    for j in range(N):
        r = row[:, j].copy()
        for k in range(j):
            r = (r - row[base + j, k] * row[:, k]).astype(f32)
        ljj = np.sqrt(np.maximum(r[base + j], f32(1e-12))).astype(f32)
        row[:, j] = np.where(ri == j, ljj, div_pos(r, ljj, ri > j))
    s, y = b.copy(), np.zeros(32, f32)
    for i in range(N):
        yi = div_pos(s, row[:, i], ri == i)[base + i]
        y = np.where(ri == i, yi, y)
        s = np.where(ri > i, s - row[:, i] * yi, s).astype(f32)
    Lsh = {h: np.zeros((N, N), f32) for h in (0, 16)}
    for lane in range(32):
        if ri[lane] < N:
            Lsh[base[lane]][ri[lane], :ri[lane] + 1] = row[lane, :ri[lane] + 1]
    t, x = y.copy(), np.zeros(32, f32)
    for i in range(N - 1, -1, -1):
        xi = div_pos(t, row[:, i], ri == i)[base + i]
        x = np.where(ri == i, xi, x)
        lij = np.array([Lsh[base[lane]][i, ri[lane] if ri[lane] < i else 0] for lane in range(32)])
        t = np.where(ri < i, t - lij * xi, t).astype(f32)
    assert np.all(np.isfinite(row)) and np.all(np.isfinite(t))
    return x


def test_warp_cholesky_two_systems_in_a_warp_solve_what_linalg_solves():
    _assert_lines_in_order(_source("fused_warp.cuh"), SOLVE_LINES)
    _assert_lines_in_order(_source(), B1A_SOLVE_LINES)
    N = DIMS[1]
    rs = np.random.RandomState(9)
    systems = []
    for _ in range(2):
        B = rs.randn(N, N)
        systems.append(((B @ B.T + N * np.eye(N)).astype(np.float32), rs.randn(N).astype(np.float32)))
    x = _warp_solve_lanes(systems, N)
    for h, (A, b) in enumerate(systems):
        want = linalg.cholesky_solve(linalg.cholesky_factor(torch.as_tensor(A)[None]),
                                     torch.as_tensor(b)[None])[0].numpy()
        np.testing.assert_allclose(x[16 * h:16 * h + N], want, rtol=1e-5, atol=1e-6)
        assert np.all(x[16 * h + N:16 * h + 16] == 0.0)       # the lanes without a dof


# the box's geometry in the source: pass A's centre, local point and
# distance, the corners (fused_geom.cuh rounds each operation on its own)
GEOM_LINES = (
    "cw = add_r(bpos, quat_rotate_t(bquat, v3((hl & 4) ? half.x : -half.x,",
    "(hl & 2) ? half.y : -half.y,",
    "(hl & 1) ? half.z : -half.z)));",
    "const bool on_ground = hl < 8 && cw.z < 0.0f;",
    "const V3 c = add_r(ld3(w.lp[li]), quat_rotate_t(ld4(w.lq[li]), ld3(sp.sph_off[s])));",
    "box_sdf_t(quat_rotate_inv_t(bquat, sub_r(c, bpos)), half, &n_local), r);",
)
BOX_SDF_LINES = (
    "const V3 q = v3(__fsub_rn(fabsf(p.x), half.x), __fsub_rn(fabsf(p.y), half.y),",
    "const float d_out = norm_t(q_out);",
    "const float q_max = fmaxf(q.x, fmaxf(q.y, q.z));",
    "*normal = v3(__fdiv_rn(__fmul_rn(sgn.x, q_out.x), inv),",
    "const float inv = fmaxf(norm_t(n_in), 1e-9f);",
    "return __fadd_rn(d_out, d_in);",
)


def _norm_t(v):
    """fused_geom.cuh norm_t: sqrt((x^2 + z^2) + y^2)."""
    return torch.sqrt((v[..., 0] * v[..., 0] + v[..., 2] * v[..., 2]) + v[..., 1] * v[..., 1])


def _box_sdf_t(p, half):
    """fused_geom.cuh box_sdf_t, each operation rounded on its own."""
    q = p.abs() - half
    q_out = q.clamp(min=0.0)
    d_out = _norm_t(q_out)
    q_max = torch.maximum(q[..., 0], torch.maximum(q[..., 1], q[..., 2]))
    sgn = torch.where(p >= 0, 1.0, -1.0)
    n_out = (sgn * q_out) / d_out.clamp(min=1e-9)[..., None]
    n_in = sgn * (q == q_max[..., None]).to(p.dtype)
    n_in = n_in / _norm_t(n_in).clamp(min=1e-9)[..., None]
    return d_out + q_max.clamp(max=0.0), torch.where((d_out > 0)[..., None], n_out, n_in)


def test_box_geometry_rounds_as_the_plain_version():
    _assert_lines_in_order(_source(), GEOM_LINES)
    _assert_lines_in_order(_source("fused_geom.cuh"), BOX_SDF_LINES)
    rs = np.random.RandomState(11)
    n = 4096
    half = torch.tensor([0.025, 0.025, 0.025])
    # local points: inside, on a face, an edge or a corner (|p_i| = half_i
    # exactly: the distance is 0, the touching test's threshold), and
    # outside one face.  Outside an edge or a corner the plain version's
    # norm of two or three non-zero terms is PyTorch's CPU reduction, which
    # rounds otherwise than the card's (x^2 + z^2) + y^2 that norm_t copies
    # (chip_smoke.py's rounding_shares reads the card's).
    u = rs.uniform(-1.0, 1.0, (n, 3)).astype(np.float32)
    on = rs.rand(n, 3) < np.array([[0.5, 0.3, 0.2]])
    out = np.zeros((n, 3), bool)
    out[np.arange(n), rs.randint(0, 3, n)] = rs.rand(n) < 0.4   # at most one coordinate out
    scale = np.where(out, rs.uniform(1.0, 3.0, (n, 3)), 1.0).astype(np.float32)
    p = torch.as_tensor(np.where(on, np.sign(u) * 0.025, u * 0.025 * scale).astype(np.float32))
    dist, normal = contact.box_sdf(p, half.expand(n, 3))
    got_d, got_n = _box_sdf_t(p, half)
    assert torch.equal(dist, got_d) and torch.equal(normal, got_n)
    assert int((dist == 0).sum()) > n // 10 and int((dist > 0).sum()) > n // 10
    # a sphere's point in the box frame and its depth (spheres_vs_boxes),
    # away from the edge and corner regions as above
    qb = rot.quat_unit(torch.as_tensor(rs.randn(n, 4).astype(np.float32)))
    pos = torch.as_tensor(rs.uniform(-0.2, 0.2, (n, 3)).astype(np.float32))
    c = pos + rot.quat_rotate(qb, torch.as_tensor(rs.uniform(-0.05, 0.05, (n, 3)).astype(np.float32)))
    r = torch.full((1,), 0.012)
    cs, _ = contact.spheres_vs_boxes(c[:, None], r, torch.full((1,), 0.5), pos[:, None],
                                     qb[:, None], half.expand(n, 1, 3), torch.ones(n, 1),
                                     torch.full((n, 1), 0.5), lambda pts: torch.zeros_like(pts))
    p_local = _quat_rotate_t(rot.quat_conjugate(qb), c - pos)
    assert torch.equal(p_local, rot.quat_rotate_inverse(qb, c - pos))
    d_t, n_t = _box_sdf_t(p_local, half)
    keep = ((p_local.abs() - half) > 0).sum(-1) <= 1
    assert int(keep.sum()) > n // 4 and int((cs.depth[keep, 0] < 0).sum()) > n // 20
    assert torch.equal((d_t - r)[keep], cs.depth[keep, 0])
    assert torch.equal(_quat_rotate_t(qb, n_t)[keep], cs.normal[keep, 0])
    # the corners, corner k at (k & 4, k & 2, k & 1) as contact.box_corners
    k = torch.arange(8)
    cl = torch.stack([torch.where((k & m) > 0, half[a], -half[a]) for a, m in enumerate((4, 2, 1))], -1)
    assert torch.equal(cl, contact.box_corners(half, 1)[0])
    want = pos[:, None] + rot.quat_rotate(qb[:, None], contact.box_corners(half, n))
    assert torch.equal(pos[:, None] + _quat_rotate_t(qb[:, None].expand(n, 8, 4), cl.expand(n, 8, 3)), want)


# box_step's integration: a lane per axis, a lane per quaternion component
INTEGRATION_LINES = (
    "const float det = a * co00 + b * co10 + c * co20;",
    "const V3 tg = t - cross(bang, matvec(Iw, bang));      // torque - gyro",
    "const int ax = hl < 3 ? hl : 0;",
    "const float r0 = div_pos(ax == 0 ? co00 : (ax == 1 ? co10 : co20), det);",
    "const float r1 = div_pos(ax == 0 ? co01 : (ax == 1 ? co11 : co21), det);",
    "const float r2 = div_pos(ax == 0 ? co02 : (ax == 1 ? co12 : co22), det);",
    "const float angacc = r0 * tg.x + r1 * tg.y + r2 * tg.z;",
    "const float linacc = div_pos(comp(f, ax), sp.cube_mass)",
    "+ (ax == 2 ? sp.gravity : 0.0f) * sp.cube_gscale;",
    "const float lin = clampf(comp(blin, ax) + h * linacc, -20.0f, 20.0f);",
    "const float ang = clampf(comp(bang, ax) + h * angacc, -50.0f, 50.0f);",
    "const float pos = comp(bpos, ax) + h * lin;",
    "const V3 wn = v3(__shfl_sync(FIS_FULL_MASK, ang, base), __shfl_sync(FIS_FULL_MASK, ang, base + 1),",
    "const Q4 dq = {0.5f * h * wn.x, 0.5f * h * wn.y, 0.5f * h * wn.z, 0.0f};",
    "const Q4 dqq = quat_mul(dq, bquat);",
    "const float nrm = sqrtf(qn.x * qn.x + qn.y * qn.y + qn.z * qn.z + qn.w * qn.w) + 1e-9f;",
    "const float qk = div_pos(k == 0 ? qn.x : (k == 1 ? qn.y : (k == 2 ? qn.z : qn.w)), nrm);",
    "w.st[R_BPOS + ax] = pos;",
    "w.st[R_BLIN + ax] = lin;",
    "w.st[R_BANG + ax] = ang;",
)


def _integrate_lanes(spec, st, f, t, h, g):
    """Plain model of box_step's integration for a batch of bodies: every
    lane the world inertia's cofactors, lane a < 3 its row of the inverse
    and axis a, the new angular velocity shuffled to every lane, lane k < 4
    quaternion component k."""
    R = rot.quat_to_mat(st.quat)
    Iw = torch.einsum("eab,bc,edc->ead", R, spec.inertia[0], R)
    a, b, c = Iw[:, 0, 0], Iw[:, 0, 1], Iw[:, 0, 2]
    d, e, ff = Iw[:, 1, 0], Iw[:, 1, 1], Iw[:, 1, 2]
    gg, hh, i = Iw[:, 2, 0], Iw[:, 2, 1], Iw[:, 2, 2]
    co = [[e * i - ff * hh, c * hh - b * i, b * ff - c * e],
          [ff * gg - d * i, a * i - c * gg, c * d - a * ff],
          [d * hh - e * gg, b * gg - a * hh, a * e - b * d]]
    det = a * co[0][0] + b * co[1][0] + c * co[2][0]
    tg = t - torch.linalg.cross(st.angvel, torch.einsum("eab,eb->ea", Iw, st.angvel))
    m, gs = spec.mass[0], spec.gravity_scale[0]
    lin, ang, pos = [], [], []
    for ax in range(3):
        row = [co[ax][k] / det for k in range(3)]
        angacc = row[0] * tg[:, 0] + row[1] * tg[:, 1] + row[2] * tg[:, 2]
        linacc = f[:, ax] / m + (g if ax == 2 else 0.0) * gs
        lin.append(torch.clamp(st.linvel[:, ax] + h * linacc, -20.0, 20.0))
        ang.append(torch.clamp(st.angvel[:, ax] + h * angacc, -50.0, 50.0))
        pos.append(st.pos[:, ax] + h * lin[ax])
    wn = torch.stack(ang, -1)
    dq = torch.cat([0.5 * h * wn, torch.zeros_like(wn[:, :1])], -1)
    qn = st.quat + rot.quat_mul(dq, st.quat)
    nrm = torch.sqrt((qn * qn).sum(-1)) + 1e-9
    quat = torch.stack([qn[:, k] / nrm for k in range(4)], -1)
    return FreeBodyState(pos=torch.stack(pos, -1), quat=quat, linvel=torch.stack(lin, -1), angvel=wn)


def test_free_body_integration_split_matches_integrate_free_body():
    _assert_lines_in_order(_source(), INTEGRATION_LINES)
    rs = np.random.RandomState(13)
    E, h, g = 256, 1.0 / 480.0, -9.81
    T = lambda *s, lo=-1.0, hi=1.0: torch.as_tensor(rs.uniform(lo, hi, s).astype(np.float32))
    inertia = torch.diag(torch.tensor([2.6e-5, 2.6e-5, 2.6e-5]))
    inertia[0, 1] = inertia[1, 0] = 3e-6
    spec = FreeBodySpec(mass=torch.tensor([0.125]), inertia=inertia[None],
                        half_extents=torch.tensor([[0.025, 0.025, 0.025]]),
                        gravity_scale=torch.tensor([1.0]), friction=torch.tensor([0.5]))
    st = FreeBodyState(pos=T(E, 3, lo=-0.2, hi=0.2), quat=rot.quat_unit(T(E, 4)),
                       linvel=T(E, 3), angvel=T(E, 3, lo=-5.0, hi=5.0))
    f, t = T(E, 3, lo=-3.0, hi=3.0), T(E, 3, lo=-0.01, hi=0.01)
    want = contact.integrate_free_body(spec, st, f, t, h, torch.tensor([0.0, 0.0, g]))
    got = _integrate_lanes(spec, st, f, t, h, g)
    for x, y in zip(got, want):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-5, atol=1e-6)
    # the velocity clamps bind on some bodies
    fast = _integrate_lanes(spec, st._replace(angvel=st.angvel * 12.0), f, t, h, g)
    assert float(fast.angvel.abs().max()) == 50.0


def test_c_entry_points_phases_and_no_constant_memory():
    src = _source()
    assert "__constant__" not in src and "atomic" not in src.replace("No float atomics", "")
    assert all(f'#include "{h}"' in src for h in ("fused_warp.cuh", "fused_geom.cuh"))
    assert "__device__ Spec g_spec;" in src and "spd_solve_warp<D>" in src
    # the FIS_PHASES build's phases, as scripts/prof_torch_fused_phases.py names them
    script = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "scripts", "prof_torch_fused_phases.py")
    spec = importlib.util.spec_from_file_location("prof_torch_fused_phases", script)
    prof = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(prof)
    nphase = len(prof.PHASE_NAMES_B1A)
    assert f"#define FIS_NPHASE {nphase}" in src
    assert sorted(map(int, re.findall(r"PHASE\((\d)\)\n", src))) == list(range(nphase))
    assert "ph_out[FIS_NPHASE + 2] = fis_globaltimer();" in _source("fused_phases.cuh")
    assert '#include "fused_phases.cuh"' in src and "PHASES_END(hl == 0 && live)" in src
    sigs = fused.library("b1a", DIMS).signatures
    for name, (args, _) in sigs.items():
        params = re.search(rf"int {name}\((.*?)\)", src, re.S).group(1)
        assert len(args) == (0 if not params.strip() else len(params.split(","))), name
    assert set(sigs) >= {"fis_launch", "fis_launch_config", "fis_occupancy", "fis_set_spec"}
