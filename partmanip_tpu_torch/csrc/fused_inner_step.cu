// Fused physics inner step for a scene of robot + ground + one free box
// (variant B1a: grasp_cube's cube) and, compiled with FIS_BODY=0, of the
// robot and the ground alone (variant B1d: the scene tools/tune_pid.py
// calibrates the controller on), CUDA C++ for sm_90a.
//
// Replaces the TPU Pallas kernel of partmanip_tpu/sim/fused.py (pallas_call
// :1398 in _make_step_call -> kernel, body _inner_step_tiled :744 with
// has_body=True, has_obj=False, n_grid=0; the cube's branches at :793, :998
// and :1066) and computes exactly what partmanip_tpu_torch/sim/engine.py
// :_inner_step computes for such a scene, which is its plain PyTorch
// version: forward kinematics -> mass matrix -> narrowphase of the S robot
// spheres against the ground and the free box -> penalty forces with impulse
// budgets, recede damping and the per-body delta-v cap -> best-partner
// choice (ground id 0, box id 1) -> stick-slip anchor update -> J^T N J ->
// two-pass effort-clamped implicit PD solve (Cholesky) -> free-body
// integration.
//
// Design: two envs a warp, a half-warp (16 lanes) per env.  The TPU kernel
// runs each env serially on one lane of an (8, 128) tile.  Carried over
// literally, one thread per env left 64 warps for 132 SMs at 2048 envs, each
// thread a long dependent chain with 255 registers and its working set
// spilled to local memory, every lane reading the robot description from
// constant memory at an address of its own (which serialises), and a time
// that did not grow with the envs (flat from 256 to 16384): the chain bound
// it.  B1a has one tree, and its serial phases fit in 16 lanes (13 links, 9
// dofs, 8 box corners), so each half of a warp holds an env and its lanes
// split every phase of the inner step:
//   - forward kinematics: lanes over links form each joint's rotation and
//     translation (the sines and cosines), one lane composes the chain,
//     lanes over dofs read the world axes;
//   - mass matrix: lanes over links rotate the inertias, lanes over
//     (link, dof) form the Jacobian columns, lanes over the lower-triangle
//     entries sum over links in link order;
//   - lanes over spheres (two rounds for 18) place them and test the ground
//     and the box; the impulse budgets and the touching spheres are counted
//     by ballot, masked to the env's half (exact integers);
//   - only spheres that touch a partner get Jacobians and forces (the
//     others contribute exact zeros): lanes over (touching sphere, dof) form
//     the Jacobian columns, then a lane per touching sphere computes its
//     forces, its stick-slip anchor and its part of the box's force and
//     torque;
//   - the box: lanes over its 8 corners against the ground; the corners'
//     and the spheres' parts of the box's force and torque are summed over
//     the half by a butterfly of fixed order; the delta-v cap, then the
//     integration with a lane per axis (its row of the cofactor inverse)
//     and a lane per quaternion component;
//   - J^T F and J^T N J: lanes over the entries, each summing over the
//     touching spheres in sphere order;
//   - the two-pass effort-clamped solve, a lane per dof, the Cholesky factor
//     and the substitutions across the half's lanes by shuffles
//     (fused_warp.cuh spd_solve_warp at base 0 and base 16).
// No float atomics: every sum has one order, so k inner steps in one launch
// equal k launches of one step bit for bit.  With an odd E, or a partial
// last block, a half-warp without an env runs env E - 1 again on a copy of
// its own (every shuffle and ballot sees finite data) and stores nothing; a
// warp without any env returns once its block has copied the Spec.
//
// The contact geometry (link poses, sphere centres, a sphere's point in the
// box frame, the box distance, the corners, the anchors' frames) is rounded
// as the plain version rounds it on the card (fused_geom.cuh): a contact
// whose depth sits at 0 falls on the same side of the test in both.
//
// The working set lives in shared memory, not in spilled registers: the
// robot description (struct Spec, 2.8 KB) once per block, copied from device
// memory, and per env struct Work (state, link poses, world axes and
// anchors, M, A_c, the sphere records and anchors, a scratch area reused
// phase by phase), 5.6 KB.  A block of FIS_WARPS = 2 warps holds 4 envs in
// 24.7 KB, so 8 blocks (16 warps, 32 envs) share an SM (fis_occupancy) and
// 4224 envs run in one wave on 132 SMs.  The n_steps loop stays inside the
// launch with the state on chip.
//
// What bounds it on an H100: not device memory (about 120 floats of state
// in and out per env and launch) but the latency of one env's chain: the
// serial parts of each inner step (the link chain, the Cholesky factor's
// columns and the substitutions, each a shuffle and an IEEE square root or
// division) run on few lanes, and 16 warps an SM hide only part of it.  The
// FIS_PHASES build counts each phase's clock cycles
// (scripts/prof_torch_fused_phases.py --kernel b1a).
//
// B1d (FIS_BODY=0) replaces the same Pallas kernel with has_body=False and
// has_obj=False (both flags of partmanip_tpu/sim/fused.py:1234-1235 off):
// this source with the box's narrowphase, its reactions and its integration
// compiled out, and the box's rows dropped from the state and its fields
// from the Spec.  The spheres meet the ground only (partner id 0).
//
// Built with FIS_BIAS=1, the right-hand sides of both solves also subtract
// the robot's tree bias (dynamics.bias_forces: gravity times the Spec's
// gscale and, when the Spec's coriolis is set, the velocity-product term),
// computed once per inner step from the state at its start at the end of
// the mass-matrix phase (fused_bias.cuh).  The TPU kernel has no such build:
// its fused_supported (partmanip_tpu/sim/fused.py:1189, :1202-1207) hands
// coriolis and gravity to XLA.  The default build (FIS_BIAS=0) is the code
// it was before the bias existed.
//
// Numerics follow the plain version literally (see fused_common.cuh); what
// differs, outside the contact geometry, is fma contraction and the order
// of sums.

#include <cuda_runtime.h>

#include "fused_common.cuh"
#include "fused_geom.cuh"
#include "fused_warp.cuh"

#ifndef FIS_L
#define FIS_L 13
#endif
#ifndef FIS_D
#define FIS_D 9
#endif
#ifndef FIS_S
#define FIS_S 18
#endif
// warps per block, two envs a warp; 16 / FIS_WARPS blocks are meant to share an SM
#ifndef FIS_WARPS
#define FIS_WARPS 2
#endif
// 1: the free box (B1a); 0: the robot and the ground alone (B1d)
#ifndef FIS_BODY
#define FIS_BODY 1
#endif
// 1: the solves subtract the robot's tree bias (gravity, coriolis)
#ifndef FIS_BIAS
#define FIS_BIAS 0
#endif
#if FIS_BIAS
#include "fused_bias.cuh"
#endif

#define L FIS_L
#define D FIS_D
#define S FIS_S

static_assert(L <= 16 && D <= 16, "a half-warp per env: one lane per link and per dof");
static_assert(S <= 32, "an env's touching spheres are kept as one 32-bit mask");

// Mirrored field by field by partmanip_tpu_torch/sim/fused.py:pack_spec;
// every member is 4 bytes wide, so the struct has no padding.
struct Spec {
    int parent[L];
    int joint_type[L];
    int dof_idx[L];
    int dof_child[D];
    int sph_link[S];
    float origin_pos[L][3];
    float origin_quat[L][4];
    float axis[L][3];
    float mass[L];            // mass * link_mask
    float com[L][3];
    float inertia[L][9];
    float ancestor[L][D];
    float dof_mask[D];
    float lower[D];
    float upper[D];
    float vel_limit[D];
    float effort[D];
    float armature[D];
    float damping[D];
    float friction[D];
    float kp[D];
    float kd[D];
    float sph_off[S][3];
    float sph_radius[S];
    float sph_mu[S];
    float sph_sticky[S];
#if FIS_BODY
    float cube_mass;
    float cube_inertia[9];
    float cube_half[3];
    float cube_gscale;
    float cube_mu;
#endif
    float h;
    float gravity;
    float kn;
    float kt;
    float max_depen;
    float ground_mu;
    // derived on the host with the plain version's formulas
    float cd_ground;          // 2 zeta sqrt(kn * 0.5)
#if FIS_BODY
    float cd_cube;            // 2 zeta sqrt(kn * m_cube)
    float cd_corner;          // 2 zeta sqrt(kn * m_cube / 4)
#endif
    float coef_ground;        // h cd_ground + h^2 kn
#if FIS_BODY
    float coef_cube;          // h cd_cube + h^2 kn
#endif
    float anchor_ks;
    float anchor_cdt;         // 2 zeta_a sqrt(ks * 0.1)
    float coef_anchor;        // h cdt + h^2 ks
#if FIS_BODY
    float hold_vel;
#endif
    float friction_veps;
    float brake_beta;
    float sat_veps;
#if FIS_BIAS
    float gscale;             // the robot's gravity_scale
    float coriolis;           // 1: the velocity-product term too
#endif
};

// Row offsets of the env-minor state buffer [FIS_NF, E].
enum {
    R_QPOS = 0,
    R_QVEL = R_QPOS + D,
    R_ROOTP = R_QVEL + D,
    R_ROOTQ = R_ROOTP + 3,
#if FIS_BODY
    R_BPOS = R_ROOTQ + 4,
    R_BQUAT = R_BPOS + 3,
    R_BLIN = R_BQUAT + 4,
    R_BANG = R_BLIN + 3,
    R_ANCP = R_BANG + 3,
#else
    R_ANCP = R_ROOTQ + 4,
#endif
    R_TGT = R_ANCP + 3 * S,
    FIS_NF = R_TGT + D
};

// The scene's Spec, uploaded once per scene; each block copies it to shared
// memory.
__device__ Spec g_spec;

__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

constexpr int TRI = D * (D + 1) / 2;        // lower triangle of the D x D
constexpr int SROUND = (S + 15) / 16;       // rounds of the lanes over spheres
// The scratch area, reused phase by phase: the chain's local joint
// transforms (7 L); the mass matrix's COMs, inertias and Jacobian columns
// (L x 12 + L x D x 6); the touching spheres' Jacobians, forces and normal
// operators (S x D x 3 + S x 12); the Cholesky factor (D x D).  The bias
// build keeps its per-link and per-dof terms after the mass matrix's.
#if FIS_BIAS
constexpr int SCRATCH = cmax(cmax(7 * L, D * D), cmax(L * 12 + L * D * 6 + FIS_BIAS_SCRATCH(L, D),
                                                      S * D * 3 + S * 12));
#else
constexpr int SCRATCH = cmax(cmax(7 * L, D * D), cmax(L * 12 + L * D * 6, S * D * 3 + S * 12));
#endif

// One env's working set in shared memory (a half-warp's).  4-byte members
// only; tests/test_torch_fused_warp_b1a.py reads the layout out of this
// source.
struct Work {
    float st[R_ANCP];         // state rows R_QPOS .. R_BANG + 2
    float tgt[D];
    float lp[L][3];           // link poses
    float lq[L][4];
    float axw[D][3];          // per-dof world axes and anchors
    float anw[D][3];
    float rev[D];
    float pris[D];
    float M[TRI];
    float Ac[TRI];
    float tau[D];
    float cen[S][3];          // sphere centres
#if FIS_BODY
    float nb[S][3];           // the box contact's world normal
    float db[S];              // and depth
#endif
    int pid[S];               // partner: -1 none, 0 ground, 1 box
    float anc_p[S][3];        // stick-slip anchors, in the partner's frame
    int anc_b[S];
    int tl[S];                // the touching spheres, ascending
    float scratch[SCRATCH];
#if FIS_BIAS
    float bias[D];            // the robot's tree bias of this inner step
#endif
};

constexpr int SPEC_WORDS = (int)(sizeof(Spec) / 4);
constexpr int WORK_WORDS = (int)(sizeof(Work) / 4);
constexpr int FIS_ENVS = 2 * FIS_WARPS;     // envs per block
constexpr int FIS_THREADS = 32 * FIS_WARPS;
// dynamic shared memory of a block: [Spec][Work x FIS_ENVS]
constexpr int SMEM_BYTES = 4 * (SPEC_WORDS + FIS_ENVS * WORK_WORDS);
static_assert(SMEM_BYTES <= 232448, "a block's shared memory exceeds the H100's 227 KB");

// The phases the FIS_PHASES build times (fused_phases.cuh).
#define FIS_NPHASE 7
#include "fused_phases.cuh"

// component a (0, 1, 2) of v, by selects (no indexing into local memory)
__device__ __forceinline__ float comp(V3 v, int a) { return a == 0 ? v.x : (a == 1 ? v.y : v.z); }

// Linear Jacobian column of dof d for a world point attached to a link with
// ancestor flag a (kinematics._columns).
__device__ __forceinline__ V3 jac_col(float a, int d, V3 point, const Work& w) {
    const V3 ax = ld3(w.axw[d]);
    V3 col = cross(ax, point - ld3(w.anw[d])) * w.rev[d] + ax * w.pris[d];
    return col * a;
}

// ---------------------------------------------------------------------------
// The phases of the inner step.  Every lane of the warp calls each one, hl
// being its lane in the env's half-warp and base (0 or 16) the half's first
// lane.
// ---------------------------------------------------------------------------

// Forward kinematics (kinematics.forward_kinematics): link poses, per-dof
// world axes and anchors, revolute / prismatic indicators.  Lanes over
// links form each joint's local rotation and translation (the sines and
// cosines), the half's first lane composes the chain, lanes over dofs read
// the world axes.  Uses 7 L scratch floats.
__device__ __forceinline__ void robot_fk(const Spec& sp, Work& w, int hl) {
    float* jl = w.scratch;                    // [L][7]: joint rotation, translation
    const float* q = w.st + R_QPOS;
    if (hl >= 1 && hl < L) {                  // the joint of link hl
        const float ql = q[sp.dof_idx[hl]];
        const float is_rev = sp.joint_type[hl] == 1 ? 1.0f : 0.0f;
        const float is_pris = sp.joint_type[hl] == 2 ? 1.0f : 0.0f;
        const V3 ax = ld3(sp.axis[hl]);
        const float half_ang = __fmul_rn(0.5f, __fmul_rn(ql, is_rev));
        const float sn = sinf(half_ang), cs = cosf(half_ang);
        const V3 axs = mul_r(ax, sn);
        const Q4 jq = {axs.x, axs.y, axs.z, cs};
        st4(jl + 7 * hl, jq);
        st3(jl + 7 * hl + 4, mul_r(ax, __fmul_rn(ql, is_pris)));
    }
    __syncwarp();
    if (hl == 0) {                            // the chain, root first
        V3 p;
        Q4 r;
        compose_t(ld3(w.st + R_ROOTP), ld4(w.st + R_ROOTQ), ld3(sp.origin_pos[0]),
                  ld4(sp.origin_quat[0]), &p, &r);
        st3(w.lp[0], p);
        st4(w.lq[0], r);
#pragma unroll 1
        for (int k = 1; k < L; ++k) {
            const int pi = sp.parent[k] > 0 ? sp.parent[k] : 0;
            // a chain link's parent is the link before: kept in registers
            const Q4 pq = pi == k - 1 ? r : ld4(w.lq[pi]);
            const V3 pp = pi == k - 1 ? p : ld3(w.lp[pi]);
            V3 jp;
            Q4 jqw;
            compose_t(pp, pq, ld3(sp.origin_pos[k]), ld4(sp.origin_quat[k]), &jp, &jqw);
            p = add_r(jp, quat_rotate_t(jqw, ld3(jl + 7 * k + 4)));
            r = quat_mul_t(jqw, ld4(jl + 7 * k));
            st3(w.lp[k], p);
            st4(w.lq[k], r);
        }
    }
    __syncwarp();
    if (hl < D) {
        const int c = sp.dof_child[hl];
        const float mask = sp.dof_mask[hl];
        st3(w.axw[hl], quat_rotate_t(ld4(w.lq[c]), ld3(sp.axis[c])));
        st3(w.anw[hl], ld3(w.lp[c]));
        const int kind = sp.joint_type[c];
        w.rev[hl] = (kind == 1 ? 1.0f : 0.0f) * mask;
        w.pris[hl] = (kind == 2 ? 1.0f : 0.0f) * mask;
    }
    __syncwarp();
}

// Joint-space inertia, row-major lower triangle M (dynamics.mass_matrix),
// and in the bias build the tree bias after it.  Uses L x 12 + L x D x 6
// scratch floats (+ FIS_BIAS_SCRATCH).
__device__ __forceinline__ void robot_mass(const Spec& sp, Work& w, int hl) {
    float* com_w = w.scratch;                 // [L][3]
    float* Iw = com_w + L * 3;                // [L][9]
    float* jv = Iw + L * 9;                   // [L][D][3]
    float* Ijw = jv + L * D * 3;              // [L][D][3]
    if (hl < L) {
        const Q4 q = ld4(w.lq[hl]);
        st3(com_w + 3 * hl, ld3(w.lp[hl]) + quat_rotate(q, ld3(sp.com[hl])));
        float R[9], I[9], Il[9];
#pragma unroll
        for (int k = 0; k < 9; ++k) I[k] = sp.inertia[hl][k];
        quat_to_mat(q, R);
        rotate_inertia(R, I, Il);
#pragma unroll
        for (int k = 0; k < 9; ++k) Iw[9 * hl + k] = Il[k];
    }
    __syncwarp();
    for (int i = hl; i < L * D; i += 16) {
        const int l = i / D, d = i - l * D;
        const float a = sp.ancestor[l][d];
        st3(jv + 3 * i, jac_col(a, d, ld3(com_w + 3 * l), w));
        st3(Ijw + 3 * i, matvec(Iw + 9 * l, ld3(w.axw[d]) * (w.rev[d] * a)));
    }
    __syncwarp();
    // lane hl sums entries hl, hl + 16, ... side by side, each over the
    // links in link order
    constexpr int PER = (TRI + 15) / 16;
    int dd[PER], ff[PER];
    float m[PER];
#pragma unroll
    for (int k = 0; k < PER; ++k) {
        const int i = hl + 16 * k < TRI ? hl + 16 * k : TRI - 1;
        dd[k] = tri_row(i);
        ff[k] = i - dd[k] * (dd[k] + 1) / 2;
        m[k] = 0.0f;
    }
    for (int l = 0; l < L; ++l) {
        const float ml = sp.mass[l];
#pragma unroll
        for (int k = 0; k < PER; ++k) {
            const int d = dd[k], f = ff[k];
            const float ad = sp.ancestor[l][d];
            const V3 jwd = ld3(w.axw[d]) * (w.rev[d] * ad);
            const float term = ml * dot(ld3(jv + 3 * (l * D + d)), ld3(jv + 3 * (l * D + f)))
                             + dot(jwd, ld3(Ijw + 3 * (l * D + f)));
            // a link off the entry's dofs adds an exact +0 (the sum starts
            // at +0 and never turns -0): the serial sum's bits, no branch
            m[k] += ad != 0.0f && sp.ancestor[l][f] != 0.0f ? term : 0.0f;
        }
    }
#pragma unroll
    for (int k = 0; k < PER; ++k) {
        const int d = dd[k];
        if (d == ff[k]) m[k] += sp.armature[d] * sp.dof_mask[d] + (1.0f - sp.dof_mask[d]);
        if (hl + 16 * k < TRI) w.M[hl + 16 * k] = m[k];
    }
    __syncwarp();
#if FIS_BIAS
    tree_bias<L, D>(sp, w.lp, w.axw, w.anw, w.rev, w.pris, w.st + R_QVEL, com_w, Iw, jv,
                    Ijw + L * D * 3, w.bias, sp.gravity, sp.gscale, sp.coriolis != 0.0f, hl);
#endif
}

// One touching sphere of pass B (the j-th, on its own lane): its velocity
// from its Jacobian jp, its ground and box penalty forces, the stick-slip
// anchor of its selected contact, its force F and normal operator N (into
// the j-th slots of Fs / Ns), and its part of the box's force and torque
// (normal reaction and the capped friction reaction), added to fw / tw.
__device__ __forceinline__ void sphere_forces(const Spec& sp, Work& w, int j, const float* jp,
                                              float* Fs, float* Ns, V3 bpos, Q4 bquat, V3 blin,
                                              V3 bang, float n_act_g, float n_act_b,
                                              float n_touch_box, V3* fw, V3* tw) {
    const float h = sp.h;
    const int s = w.tl[j];
    const int li = sp.sph_link[s];
    const V3 c = ld3(w.cen[s]);
    const float* qv = w.st + R_QVEL;
    V3 v = v3(0.0f, 0.0f, 0.0f);
    for (int d = 0; d < D; ++d) {
        if (sp.ancestor[li][d] == 0.0f) continue;
        v = v + ld3(jp + 3 * (j * D + d)) * qv[d];
    }
    const float r = sp.sph_radius[s];
#if FIS_BODY
    const float dg = c.z - r, db = w.db[s];
    const int id = w.pid[s];
    const V3 nb = ld3(w.nb[s]);
    const V3 rc = c - bpos;
    const V3 v_box = blin + cross(bang, rc);
#else
    const float dg = c.z - r;
    const int id = w.pid[s];
#endif
    V3 F = v3(0.0f, 0.0f, 0.0f);
    float N[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) N[k] = 0.0f;
#if FIS_BODY
    float fn_g = 0.0f, fn_b = 0.0f;
    const float mu_g = 0.5f * (sp.sph_mu[s] + sp.ground_mu);
    const float mu_b = 0.5f * (sp.sph_mu[s] + sp.cube_mu);
#else
    float fn_g = 0.0f;
    const float mu_g = 0.5f * (sp.sph_mu[s] + sp.ground_mu);
#endif
    if (dg < 0.0f) {
        F = F + penalty_force(dg, v3(0.0f, 0.0f, 1.0f), v, mu_g, 0.5f, sp.cd_ground, n_act_g,
                              0.0f, h, sp.kn, sp.kt, sp.max_depen, &fn_g);
        N[8] += sp.coef_ground;
    }
#if FIS_BODY
    if (db < 0.0f) {
        const V3 fb = penalty_force(db, nb, v - v_box, mu_b, sp.cube_mass, sp.cd_cube, n_act_b,
                                    1.0f, h, sp.kn, sp.kt, sp.max_depen, &fn_b);
        F = F + fb;
        const float nn[3] = {nb.x, nb.y, nb.z};
#pragma unroll
        for (int a = 0; a < 3; ++a)
#pragma unroll
            for (int b = 0; b < 3; ++b) N[a * 3 + b] += sp.coef_cube * nn[a] * nn[b];
        *fw = *fw - fb;
        *tw = *tw - cross(rc, fb);
    }
    // the selected contact
    const bool on_box = id == 1;
    const V3 n = on_box ? nb : v3(0.0f, 0.0f, 1.0f);
    const float fn = on_box ? fn_b : fn_g;
    const float mu = on_box ? mu_b : mu_g;
    const V3 pvel = on_box ? v_box : v3(0.0f, 0.0f, 0.0f);
#else
    // the selected contact: the ground (B1d has no other partner)
    const V3 n = v3(0.0f, 0.0f, 1.0f);
    const float fn = fn_g;
    const float mu = mu_g;
    const V3 pvel = v3(0.0f, 0.0f, 0.0f);
#endif
    const V3 v_rel = v - pvel;
    const V3 vt = v_rel - dot(v_rel, n) * n;

    // stick-slip anchor (contact.anchor_friction), sticky spheres only
    V3 ft = v3(0.0f, 0.0f, 0.0f);
    const float sticky = sp.sph_sticky[s];
    if (sticky > 0.0f) {
        const int anc_b = w.anc_b[s];
        const V3 anc_p = ld3(w.anc_p[s]);
        const bool same = anc_b == id;
#if FIS_BODY
        const V3 aw = anc_b == 1 ? add_r(quat_rotate_t(bquat, anc_p), bpos) : anc_p;
#else
        const V3 aw = anc_p;                  // ground / none: world frame
#endif
        const V3 delta = c - aw;
        const V3 delta_t = delta - dot(delta, n) * n;
        const V3 ft_raw = same ? (-sp.anchor_ks) * delta_t - sp.anchor_cdt * vt
                               : (-sp.anchor_cdt) * vt;
        const float ft_mag = norm(ft_raw);
        const float limit = mu * fn;
        const bool stick = (ft_mag <= limit) && same;
        const float scale =
            ft_mag > 1e-9f ? fminf(div_pos(limit, fmaxf(ft_mag, 1e-9f)), 1.0f) : 0.0f;
        ft = ft_raw * scale;
        const V3 new_w = stick ? aw
                               : c + v3(div_pos(ft.x, sp.anchor_ks), div_pos(ft.y, sp.anchor_ks),
                                        div_pos(ft.z, sp.anchor_ks));
#if FIS_BODY
        st3(w.anc_p[s], on_box ? quat_rotate_inv_t(bquat, sub_r(new_w, bpos)) : new_w);
#else
        st3(w.anc_p[s], new_w);
#endif
        w.anc_b[s] = id;
        ft = ft * sticky;
    } else {
        w.anc_b[s] = -1;
    }
    F = F + ft;
    // implicit tangential operator (I - n n^T) of the selected contact
    {
        const float nn[3] = {n.x, n.y, n.z};
#pragma unroll
        for (int a = 0; a < 3; ++a)
#pragma unroll
            for (int b = 0; b < 3; ++b)
                N[a * 3 + b] += sp.coef_anchor * ((a == b ? 1.0f : 0.0f) - nn[a] * nn[b]);
    }
#if FIS_BODY
    // friction reaction on the box, capped to velocity matching
    if (on_box) {
        const float cap = (sp.cube_mass / n_touch_box) * (norm(vt) + sp.hold_vel) / h;
        const float mag = norm(ft);
        const V3 ftc = ft * div_pos(fminf(mag, cap), fmaxf(mag, 1e-9f));
        *fw = *fw - ftc;
        *tw = *tw - cross(rc, ftc);
    }
#endif
    st3(Fs + 3 * j, F);
#pragma unroll
    for (int k = 0; k < 9; ++k) Ns[9 * j + k] = N[k];
}

#if FIS_BODY
// The free box (engine._inner_step's corner contacts and delta-v cap, then
// contact.integrate_free_body): lanes over the 8 corners against the
// ground; the corners' force and torque and this lane's part of the
// spheres' reaction (f, t) summed over the half; then a lane per axis
// integrates its velocities and position (its row of the cofactor inverse)
// and a lane per component the quaternion, into the state rows.
__device__ __forceinline__ void box_step(const Spec& sp, Work& w, int hl, int base, V3 f, V3 t,
                                         V3 bpos, Q4 bquat, V3 blin, V3 bang) {
    const float h = sp.h;
    const V3 half = ld3(sp.cube_half);
    V3 cw = v3(0.0f, 0.0f, 0.0f);
    if (hl < 8)
        cw = add_r(bpos, quat_rotate_t(bquat, v3((hl & 4) ? half.x : -half.x,
                                                 (hl & 2) ? half.y : -half.y,
                                                 (hl & 1) ? half.z : -half.z)));
    const bool on_ground = hl < 8 && cw.z < 0.0f;
    const float n_act_c = fmaxf(1.0f, (float)half_count(on_ground, base));
    if (on_ground) {
        const V3 rck = cw - bpos;
        const V3 vck = blin + cross(bang, rck);
        float fn_unused;
        const V3 fc = penalty_force(cw.z, v3(0.0f, 0.0f, 1.0f), vck, 0.5f * (sp.cube_mu + sp.ground_mu),
                                    sp.cube_mass / 4.0f, sp.cd_corner, n_act_c, 1.0f, h, sp.kn,
                                    sp.kt, sp.max_depen, &fn_unused);
        f = f + fc;
        t = t + cross(rck, fc);
    }
    f = v3(half_sum(f.x), half_sum(f.y), half_sum(f.z));
    t = v3(half_sum(t.x), half_sum(t.y), half_sum(t.z));
    // the net delta-v cap of the body
    const float dv = div_pos(norm(f) * h, sp.cube_mass);
    const float dv_scale = fminf(1.0f, sp.max_depen / fmaxf(dv, 1e-9f));
    f = f * dv_scale;
    t = t * dv_scale;

    // world inertia and its cofactors (every lane)
    float R[9], Iw[9];
    quat_to_mat(bquat, R);
    rotate_inertia(R, sp.cube_inertia, Iw);
    const float a = Iw[0], b = Iw[1], c = Iw[2], d = Iw[3], ee = Iw[4], ff = Iw[5],
                g = Iw[6], hh = Iw[7], i = Iw[8];
    const float co00 = ee * i - ff * hh, co01 = c * hh - b * i, co02 = b * ff - c * ee;
    const float co10 = ff * g - d * i, co11 = a * i - c * g, co12 = c * d - a * ff;
    const float co20 = d * hh - ee * g, co21 = b * g - a * hh, co22 = a * ee - b * d;
    const float det = a * co00 + b * co10 + c * co20;
    const V3 tg = t - cross(bang, matvec(Iw, bang));      // torque - gyro
    // lane ax < 3: axis ax, with row ax of the inverse co / det
    const int ax = hl < 3 ? hl : 0;
    const float r0 = div_pos(ax == 0 ? co00 : (ax == 1 ? co10 : co20), det);
    const float r1 = div_pos(ax == 0 ? co01 : (ax == 1 ? co11 : co21), det);
    const float r2 = div_pos(ax == 0 ? co02 : (ax == 1 ? co12 : co22), det);
    const float angacc = r0 * tg.x + r1 * tg.y + r2 * tg.z;
    const float linacc = div_pos(comp(f, ax), sp.cube_mass)
                       + (ax == 2 ? sp.gravity : 0.0f) * sp.cube_gscale;
    const float lin = clampf(comp(blin, ax) + h * linacc, -20.0f, 20.0f);
    const float ang = clampf(comp(bang, ax) + h * angacc, -50.0f, 50.0f);
    const float pos = comp(bpos, ax) + h * lin;
    // the new angular velocity on every lane; lane k < 4: quaternion component k
    const V3 wn = v3(__shfl_sync(FIS_FULL_MASK, ang, base), __shfl_sync(FIS_FULL_MASK, ang, base + 1),
                     __shfl_sync(FIS_FULL_MASK, ang, base + 2));
    const Q4 dq = {0.5f * h * wn.x, 0.5f * h * wn.y, 0.5f * h * wn.z, 0.0f};
    const Q4 dqq = quat_mul(dq, bquat);
    const Q4 qn = {bquat.x + dqq.x, bquat.y + dqq.y, bquat.z + dqq.z, bquat.w + dqq.w};
    const float nrm = sqrtf(qn.x * qn.x + qn.y * qn.y + qn.z * qn.z + qn.w * qn.w) + 1e-9f;
    const int k = hl < 4 ? hl : 0;
    const float qk = div_pos(k == 0 ? qn.x : (k == 1 ? qn.y : (k == 2 ? qn.z : qn.w)), nrm);
    if (hl < 3) {
        w.st[R_BPOS + ax] = pos;
        w.st[R_BLIN + ax] = lin;
        w.st[R_BANG + ax] = ang;
    }
    if (hl < 4) w.st[R_BQUAT + k] = qk;
    __syncwarp();
}

#endif

// tau = J^T F and Ac = J^T N J (lower triangle) over the nt touching
// spheres: lanes over the (d, f) entries and the d of tau, each summing over
// the touching spheres in sphere order.
__device__ __forceinline__ void robot_jt(const Spec& sp, Work& w, int hl, int nt, const float* jp,
                                         const float* Fs, const float* Ns) {
    constexpr int NT = TRI + D, PER = (NT + 15) / 16;
    int dd[PER], ff[PER];
    float acc[PER];
#pragma unroll
    for (int k = 0; k < PER; ++k) {
        const int i = hl + 16 * k < NT ? hl + 16 * k : NT - 1;
        dd[k] = i >= TRI ? i - TRI : tri_row(i);
        ff[k] = i >= TRI ? -1 : i - dd[k] * (dd[k] + 1) / 2;   // -1: tau
        acc[k] = 0.0f;
    }
    for (int j = 0; j < nt; ++j) {
        const int li = sp.sph_link[w.tl[j]];
#pragma unroll
        for (int k = 0; k < PER; ++k) {
            const int d = dd[k], f = ff[k];
            const V3 jd = ld3(jp + 3 * (j * D + d));
            const V3 x = f < 0 ? ld3(Fs + 3 * j)
                               : matvec(Ns + 9 * j, ld3(jp + 3 * (j * D + (f < 0 ? 0 : f))));
            acc[k] += sp.ancestor[li][d] != 0.0f && (f < 0 || sp.ancestor[li][f] != 0.0f)
                      ? dot(jd, x) : 0.0f;
        }
    }
#pragma unroll
    for (int k = 0; k < PER; ++k) {
        const int i = hl + 16 * k;
        if (i < TRI) w.Ac[i] = acc[k];
        else if (i < NT) w.tau[i - TRI] = acc[k];
    }
    __syncwarp();
}

// Two-pass effort-clamped implicit PD step (dynamics.step_tree), a lane per
// dof: (M + h D + h^2 K + Ac) qacc = tau_drive + tau_fric + tau_ext (- the
// tree bias in the FIS_BIAS build), then
// the clipped velocity / position update with joint limits.  The lanes
// hl >= D hold zero rows and a zero right-hand side, which change none of
// the solve's operations.  Updates q and qv in place; uses D x D scratch
// floats.
__device__ __forceinline__ void robot_solve(const Spec& sp, Work& w, int hl, int base) {
    const float h = sp.h;
    const bool real = hl < D;
    const int d = real ? hl : D - 1;          // lanes without a dof read a real one, then drop it
    float* q = w.st + R_QPOS;
    float* qv = w.st + R_QVEL;
#if FIS_BIAS
    const float qd = q[d], qvd = qv[d], tg = w.tgt[d], te = w.tau[d] - w.bias[d];
#else
    const float qd = q[d], qvd = qv[d], tg = w.tgt[d], te = w.tau[d];
#endif
    const float kp = sp.kp[d], kd = sp.kd[d], mask = sp.dof_mask[d], effort = sp.effort[d];
    const float fric = sp.friction[d], damping = sp.damping[d], vel_limit = sp.vel_limit[d];
    const float Mdd = w.M[d * (d + 1) / 2 + d];
    const float tau_d0 = kp * (tg - qd - h * qvd) - kd * qvd;
    const float tau_fric = -fric * clampf(div_pos(qvd, sp.friction_veps), -1.0f, 1.0f);
    const float d_fric = div_pos(fric, sp.friction_veps)
                       * (fabsf(qvd) < sp.friction_veps ? 1.0f : 0.0f);
    float row[D];
    // pass 1: fully implicit, no effort limit
    system_row<D>(row, hl, w.M, w.Ac, d, (h * (kd + 0.0f + damping + d_fric) + (h * h) * kp) * mask,
                  real);
    float qacc = spd_solve_warp<D>(row, real ? (tau_d0 + tau_fric + te) * mask : 0.0f, w.scratch,
                                   hl, base);
    // pass 2: saturated dofs become effort-limited velocity servos
    {
        const float qa = qacc * mask;
        const float tau_imp = tau_d0 - (h * h * kp + h * kd) * qa;
        const float sat = fabsf(tau_imp) > effort ? 1.0f : 0.0f;
        const float unsat = 1.0f - sat;
        const float a_max = div_pos(effort, fmaxf(Mdd, 1e-9f));
        const float err = tg - qd;
        const float aerr = fabsf(err);
        const float sgn = err > 0.0f ? 1.0f : (err < 0.0f ? -1.0f : 0.0f);
        const float v_opt = sgn * fminf(vel_limit, fminf(div_pos(aerr, h),
                                                         sqrt_nz(2.0f * sp.brake_beta * a_max * aerr)));
        const float dv = v_opt - qvd;
        const float b_imp = div_pos(sat * effort, fmaxf(fabsf(dv), sp.sat_veps));
        const float tau_drive = b_imp * dv + unsat * tau_d0;
        const float diag = h * (kd * unsat + b_imp + damping + d_fric) + (h * h) * (kp * unsat);
        system_row<D>(row, hl, w.M, w.Ac, d, diag * mask, real);
        qacc = spd_solve_warp<D>(row, real ? (tau_drive + tau_fric + te) * mask : 0.0f, w.scratch,
                                 hl, base);
    }
    const float qa = qacc * mask;
    const float v_new = clampf(qvd + h * qa, -vel_limit, vel_limit);
    const float q_new = qd + h * v_new;
    const bool at_lo = (q_new < sp.lower[d]) && (v_new < 0.0f);
    const bool at_hi = (q_new > sp.upper[d]) && (v_new > 0.0f);
    const float vel_new = ((at_lo || at_hi) ? 0.0f : v_new) * mask;
    const float pos_new = clampf(q_new, sp.lower[d], sp.upper[d]) * mask;
    __syncwarp();
    if (real) {
        q[d] = pos_new;
        qv[d] = vel_new;
    }
    __syncwarp();
}

__global__ void __launch_bounds__(FIS_THREADS, 16 / FIS_WARPS)
fused_inner_step_kernel(const float* __restrict__ in, const int* __restrict__ anc_b_in,
                        float* __restrict__ out, int* __restrict__ anc_b_out, int E, int n_steps) {
    extern __shared__ float smem[];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int hl = lane & 15, base = lane & 16;   // lane in the env's half-warp, the half's first lane
    const int slot = 2 * warp + (lane >> 4);       // the env's slot in the block
    const int e = blockIdx.x * FIS_ENVS + slot;
    Spec& sp = *reinterpret_cast<Spec*>(smem);
    Work& w = reinterpret_cast<Work*>(smem + SPEC_WORDS)[slot];
    // ---- the block's Spec ----
    for (int i = threadIdx.x; i < SPEC_WORDS; i += FIS_THREADS)
        smem[i] = reinterpret_cast<const float*>(&g_spec)[i];
    __syncthreads();
    if (blockIdx.x * FIS_ENVS + 2 * warp >= E) return;   // neither env of the warp exists
    // a half-warp past E runs env E - 1 again and stores nothing
    const bool live = e < E;
    const int ee = live ? e : E - 1;

    // ---- load state ----
    for (int r = hl; r < R_ANCP; r += 16) w.st[r] = in[(size_t)r * E + ee];
    for (int d = hl; d < D; d += 16) w.tgt[d] = in[(size_t)(R_TGT + d) * E + ee];
    for (int s = hl; s < S; s += 16) {
        const int r = R_ANCP + 3 * s;
        w.anc_p[s][0] = in[(size_t)r * E + ee];
        w.anc_p[s][1] = in[(size_t)(r + 1) * E + ee];
        w.anc_p[s][2] = in[(size_t)(r + 2) * E + ee];
        w.anc_b[s] = anc_b_in[(size_t)s * E + ee];
    }
    __syncwarp();
#if FIS_BODY
    const V3 half = ld3(sp.cube_half);
#endif
    float* jp = w.scratch;                    // [S][D][3] the touching spheres' Jacobians
    float* Fs = jp + S * D * 3;               // [S][3] their forces
    float* Ns = Fs + S * 3;                   // [S][9] and normal operators

    PHASES_BEGIN
    for (int step = 0; step < n_steps; ++step) {
        // ---- kinematics and inertia ----
        robot_fk(sp, w, hl);
        PHASE(0)
        robot_mass(sp, w, hl);
        PHASE(1)

        // ---- spheres, narrowphase pass A: lanes over spheres; the
        // budgets and the touching spheres by ballot over the env's half
#if FIS_BODY
        const V3 bpos = ld3(w.st + R_BPOS), blin = ld3(w.st + R_BLIN), bang = ld3(w.st + R_BANG);
        const Q4 bquat = ld4(w.st + R_BQUAT);
#else
        const V3 bpos = v3(0.0f, 0.0f, 0.0f), blin = bpos, bang = bpos;   // no box: unread
        const Q4 bquat = {0.0f, 0.0f, 0.0f, 1.0f};
#endif
        unsigned touching = 0u;
        int n_g = 0, n_b = 0, n_c = 0;
#pragma unroll
        for (int k = 0; k < SROUND; ++k) {
            const int s = hl + 16 * k;
            int id = -1;
            bool tg = false, tb = false;
            if (s < S) {
                const int li = sp.sph_link[s];
                const V3 c = add_r(ld3(w.lp[li]), quat_rotate_t(ld4(w.lq[li]), ld3(sp.sph_off[s])));
                st3(w.cen[s], c);
                const float r = sp.sph_radius[s];
                const float dg = c.z - r;
#if FIS_BODY
                V3 n_local;
                const float db = __fsub_rn(
                    box_sdf_t(quat_rotate_inv_t(bquat, sub_r(c, bpos)), half, &n_local), r);
                st3(w.nb[s], quat_rotate_t(bquat, n_local));
                w.db[s] = db;
                tg = dg < 0.0f;
                tb = db < 0.0f;
#else
                const float db = 1e9f;                // no box
                tg = dg < 0.0f;
#endif
                // partner choice in the order ground (0), box (1): a later
                // partner wins only with a strictly smaller depth
                float bd = 1e9f;
                if (tg && dg < bd) { id = 0; bd = dg; }
                if (tb && db < bd) { id = 1; bd = db; }
                w.pid[s] = id;
                if (id < 0) w.anc_b[s] = -1;      // touches nothing: the anchor is released
            }
            n_g += half_count(tg, base);
            n_b += half_count(tb, base);
            n_c += half_count(id == 1, base);
            touching |= half_ballot(id >= 0, base) << (16 * k);
        }
        const float n_act_g = fmaxf(1.0f, (float)n_g);
        const float n_act_b = fmaxf(1.0f, (float)n_b);
        const float n_touch_box = fmaxf(1.0f, (float)n_c);
        const int nt = __popc(touching);
#pragma unroll
        for (int k = 0; k < SROUND; ++k) {
            const int s = hl + 16 * k;
            if (s < S && ((touching >> s) & 1u)) w.tl[__popc(touching & ((1u << s) - 1u))] = s;
        }
        __syncwarp();
        PHASE(2)

        // ---- pass B: lanes over (touching sphere, dof) for the Jacobians,
        // then a lane per touching sphere
        for (int i = hl; i < nt * D; i += 16) {
            const int j = i / D, d = i - j * D, s = w.tl[j];
            st3(jp + 3 * i, jac_col(sp.ancestor[sp.sph_link[s]][d], d, ld3(w.cen[s]), w));
        }
        __syncwarp();
        V3 fw = v3(0.0f, 0.0f, 0.0f), tw = v3(0.0f, 0.0f, 0.0f);   // this lane's part of the box's wrench
#pragma unroll 1
        for (int j = hl; j < nt; j += 16)
            sphere_forces(sp, w, j, jp, Fs, Ns, bpos, bquat, blin, bang, n_act_g, n_act_b,
                          n_touch_box, &fw, &tw);
        __syncwarp();
        PHASE(3)

#if FIS_BODY
        // ---- the free box ----
        box_step(sp, w, hl, base, fw, tw, bpos, bquat, blin, bang);
#endif
        PHASE(4)

        // ---- joint space, then the two-pass effort-clamped implicit PD ----
        robot_jt(sp, w, hl, nt, jp, Fs, Ns);
        PHASE(5)
        robot_solve(sp, w, hl, base);
        PHASE(6)
    }
    PHASES_END(hl == 0 && live)

    // ---- store state (root pose and targets pass through) ----
    if (live) {
        for (int r = hl; r < R_ANCP; r += 16) out[(size_t)r * E + e] = w.st[r];
        for (int d = hl; d < D; d += 16) out[(size_t)(R_TGT + d) * E + e] = w.tgt[d];
        for (int s = hl; s < S; s += 16) {
            const int r = R_ANCP + 3 * s;
            out[(size_t)r * E + e] = w.anc_p[s][0];
            out[(size_t)(r + 1) * E + e] = w.anc_p[s][1];
            out[(size_t)(r + 2) * E + e] = w.anc_p[s][2];
            anc_b_out[(size_t)s * E + e] = w.anc_b[s];
        }
    }
}

static int fis_prepare() {
    static bool done = false;
    if (done) return 0;
    const cudaError_t err = cudaFuncSetAttribute(
        fused_inner_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    done = true;
    return 0;
}

extern "C" {

// Size of the scene description the wrapper must upload, and of a state row
// set; the wrapper checks both against its own packing.
int fis_spec_bytes() { return (int)sizeof(Spec); }
int fis_state_rows() { return (int)FIS_NF; }
int fis_dims(int which) { return which == 0 ? L : (which == 1 ? D : S); }

// The launch configuration the wrapper checks against its own formula
// (sim/fused.launch_config): 0 envs per block, 1 threads per block,
// 2 dynamic shared-memory bytes per block, 3 envs per warp.
int fis_launch_config(int which) {
    const int cfg[4] = {FIS_ENVS, FIS_THREADS, SMEM_BYTES, 2};
    return (which >= 0 && which < 4) ? cfg[which] : -1;
}

// Blocks of this kernel resident on one SM at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
int fis_occupancy(int* blocks_per_sm) {
    const int err = fis_prepare();
    if (err != 0) return err;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, fused_inner_step_kernel, FIS_THREADS, SMEM_BYTES);
}

// Copy the scene description to the device, ordered on `stream`.
int fis_set_spec(const void* host_spec, int bytes, void* stream) {
    if (bytes != (int)sizeof(Spec)) return -1;
    cudaError_t err = cudaMemcpyToSymbolAsync(g_spec, host_spec, sizeof(Spec), 0,
                                              cudaMemcpyHostToDevice, (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

// Launch n_steps inner steps for E envs on `stream`; returns cudaGetLastError().
int fis_launch(const void* in, const void* anc_b_in, void* out, void* anc_b_out,
               int E, int n_steps, void* stream) {
    if (E < 1 || n_steps < 0) return -1;
    const int err = fis_prepare();
    if (err != 0) return err;
    const int blocks = (E + FIS_ENVS - 1) / FIS_ENVS;
    fused_inner_step_kernel<<<blocks, FIS_THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
        (const float*)in, (const int*)anc_b_in, (float*)out, (int*)anc_b_out, E, n_steps);
    return (int)cudaGetLastError();
}

}  // extern "C"
