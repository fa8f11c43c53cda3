// Fused physics inner step for a scene of robot + ground + one articulated
// object with box collision geoms (variant B1b: open_drawer's cabinet) and,
// compiled with FIS_K > 0, K baked mesh-SDF collision geoms on the object
// tree (variant B1c: the cabinet's mesh handles), CUDA C++ for sm_90a.
//
// Replaces the TPU Pallas kernel of partmanip_tpu/sim/fused.py
// (_make_step_call -> kernel, body _inner_step_tiled with has_obj=True,
// has_body=False, n_grid=0) and computes exactly what
// partmanip_tpu_torch/sim/engine.py:_inner_step computes for such a scene,
// which is its plain PyTorch version: robot forward kinematics, sphere
// Jacobians and mass matrix -> object forward kinematics and world box poses
// -> narrowphase of the S robot spheres against the ground and the G object
// boxes -> penalty forces with one impulse budget per contact set (ground:
// over S spheres; boxes: over all S x G pairs of the env) -> best partner
// per sphere (ground id 0, box g id 2 + g, first minimum) -> stick-slip
// anchors held in the partner's frame -> J^T N J for the robot, the box
// wrenches and J^T N J at the box centres for the object -> the two-pass
// effort-clamped implicit PD solve (Cholesky) for both trees.  The object
// is undriven: its drive target is its own qpos, so only its dof damping and
// dof friction (linearised inside friction_veps) and the contact reactions
// act on it.
//
// Design.  As B1a (fused_inner_step.cu): one thread owns one env, the loop
// of n_steps inner steps runs inside one launch with the state in
// registers / local memory, the state arrives env-minor ([feature, E]) and
// the robot's description lives in __constant__ memory (all threads read
// the same address).  The cabinet differs from env to env (env e holds
// object e % n_obj, so one warp touches every object): its description is
// one ObjSpec record per distinct object in global memory, read through the
// read-only path at the env's obj_id; constant memory would serialise those
// divergent reads.  Where the TPU kernel resolves box links, ancestors and
// anchor frames by masked sums over Lo and G, this kernel indexes.  The
// impulse budget of the box contacts counts the touching pairs of the whole
// env, so the narrowphase runs twice: pass A counts the touching pairs,
// keeps one bit per (sphere, box) pair and the best box per sphere; pass B
// recomputes the geometry of the touching pairs only and applies the
// forces.  Box Jacobian columns are recomputed per touching pair instead of
// holding Jv_box (3 x G x Do).
//
// What bounds it on an H100: as for B1a, not device memory (about 150
// floats of state in and out per env and launch, and one 2.6 KB object
// record read per env) but f32 latency and the launch: each thread runs a
// long dependent chain (12x12 and 4x4 Cholesky solves twice per inner step,
// 450 sphere-box distance tests) with its working set in local memory.
//
// B1c (FIS_K > 0) replaces the same Pallas kernel with n_grid > 0
// (partmanip_tpu/sim/fused.py:863-890) together with its narrowphase
// _grid_narrowphase (:1415), which the TPU build runs in XLA between one
// pallas_call per inner step because Mosaic cannot gather per lane.  Here
// the gather is a plain load, so the grid narrowphase runs inside the launch
// and all n_steps inner steps stay in one launch, as for B1b.  It follows
// engine._inner_step branch 3b: each (sphere, grid geom) pair queries the
// shared grid stack (M grids of GX x GY x GZ f32, uploaded once per scene,
// read through the read-only path with __ldg) for the trilinear value and
// gradient in f32, in ops/sdf.grid_query_grad's order -- no texture
// filtering, whose 8-bit interpolation weights are not that arithmetic; a
// query outside its grid's interior cells skips its 8 loads (the reference
// then returns exactly outside_value = 1 and a zero gradient).  The grid
// pairs have an impulse budget of their own (a second penalty_forces call
// in the plain version), the best grid per sphere (first minimum, partner id
// 2 + G + k) is considered after the boxes, anchors may live in grid frames,
// and the reactions reach the object through the grid-link Jacobians at the
// grid origin.  Like the box pairs, the grid pairs run in two passes (count
// and mask, then forces on the touching pairs only, with the query
// recomputed).  The geoms' records are a second table (GridSpec) indexed by
// the same obj_id.  What bounds it: as B1b, plus S x K trilinear queries of
// 8 loads per inner step from a 30.9 MB stack that stays in L2.
//
// Numerics follow the plain version literally (see fused_common.cuh); what
// differs is fma contraction and the order of sums.

#include <cuda_runtime.h>

#include "fused_common.cuh"

#ifndef FIS_L
#define FIS_L 16
#endif
#ifndef FIS_D
#define FIS_D 12
#endif
#ifndef FIS_S
#define FIS_S 18
#endif
#ifndef FIS_LO
#define FIS_LO 9
#endif
#ifndef FIS_DO
#define FIS_DO 4
#endif
#ifndef FIS_G
#define FIS_G 25
#endif
#ifndef FIS_K
#define FIS_K 0
#endif
#ifndef FIS_BLOCK
#define FIS_BLOCK 32
#endif

#define L FIS_L
#define D FIS_D
#define S FIS_S
#define LO FIS_LO
#define DO FIS_DO
#define G FIS_G

static_assert(G <= 32, "the touching pairs of a sphere are kept as one 32-bit mask");
#if FIS_K > 0
#define K FIS_K
#define GX FIS_GX
#define GY FIS_GY
#define GZ FIS_GZ
static_assert(K <= 32, "the touching grid pairs of a sphere are kept as one 32-bit mask");
#endif

// Robot, spheres and contact constants, in constant memory.  Mirrored field
// by field by partmanip_tpu_torch/sim/fused.py:pack_spec_obj; every member
// is 4 bytes wide, so the struct has no padding.
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
    float h;
    float gravity;
    float kn;
    float kt;
    float max_depen;
    float ground_mu;
    // derived on the host with the plain version's formulas
    float cd_ground;          // 2 zeta sqrt(kn * 0.5)
    float cd_obj;             // 2 zeta sqrt(kn * 0.3)
    float coef_ground;        // h cd_ground + h^2 kn
    float coef_obj;           // h cd_obj + h^2 kn
    float anchor_ks;
    float anchor_cdt;         // 2 zeta_a sqrt(ks * 0.1)
    float coef_anchor;        // h cdt + h^2 ks
    float friction_veps;
    float brake_beta;
    float sat_veps;
};

// One articulated object (tree + collision boxes), in global memory: a
// table of n_obj records, env e reads record obj_id[e].  Mirrored by
// partmanip_tpu_torch/sim/fused.py:pack_obj_table; no padding.
struct ObjSpec {
    int parent[LO];
    int joint_type[LO];
    int dof_idx[LO];
    int dof_child[DO];
    int b_link[G];
    float origin_pos[LO][3];
    float origin_quat[LO][4];
    float axis[LO][3];
    float mass[LO];           // mass * link_mask
    float com[LO][3];
    float inertia[LO][9];
    float ancestor[LO][DO];
    float dof_mask[DO];
    float lower[DO];
    float upper[DO];
    float vel_limit[DO];
    float effort[DO];
    float armature[DO];
    float damping[DO];
    float friction[DO];
    float kp[DO];
    float kd[DO];
    float b_pos[G][3];
    float b_quat[G][4];
    float b_half[G][3];
    float b_mask[G];
    float b_mu[G];
};

#if FIS_K > 0
// The K mesh-SDF geoms of one object, a second table beside the ObjSpec
// records (same obj_id).  Mirrored by
// partmanip_tpu_torch/sim/fused.py:pack_obj_table; no padding.
struct GridSpec {
    int g_link[K];
    int g_gid[K];             // grid index into the stack
    float g_pos[K][3];        // grid frame in the link frame
    float g_quat[K][4];
    float g_mask[K];
    float g_mu[K];
};

// The shared grid stack: sdf [M][GX][GY][GZ], bbox_min [M][3], voxel [M].
struct GridStack {
    const float* sdf;
    const float* bbox;
    const float* voxel;
};

// Trilinear SDF value and gradient of grid gid at local point p
// (ops/sdf.grid_query_grad, same operation order).  Outside the interior
// cells: value 1 (outside_value) and a zero gradient, without a load.
__device__ __forceinline__ float grid_query_grad(const GridStack& st, int gid, V3 p, V3* grad) {
    const float vs = __ldg(st.voxel + gid);
    const float ix = (p.x - __ldg(st.bbox + 3 * gid)) / vs;
    const float iy = (p.y - __ldg(st.bbox + 3 * gid + 1)) / vs;
    const float iz = (p.z - __ldg(st.bbox + 3 * gid + 2)) / vs;
    const bool valid = ix >= 1.0f && ix <= (float)(GX - 2) && iy >= 1.0f
                    && iy <= (float)(GY - 2) && iz >= 1.0f && iz <= (float)(GZ - 2);
    if (!valid) {
        *grad = v3(0.0f, 0.0f, 0.0f);
        return 1.0f;
    }
    // inside [1, hi] the reference's clip to [0, hi] changes nothing
    const int x0 = (int)ix, y0 = (int)iy, z0 = (int)iz;
    const float fx = ix - (float)x0, fy = iy - (float)y0, fz = iz - (float)z0;
    const float* c = st.sdf + (size_t)gid * (GX * GY * GZ) + (size_t)x0 * (GY * GZ) + y0 * GZ + z0;
    const float c000 = __ldg(c), c001 = __ldg(c + 1);
    const float c010 = __ldg(c + GZ), c011 = __ldg(c + GZ + 1);
    const float c100 = __ldg(c + GY * GZ), c101 = __ldg(c + GY * GZ + 1);
    const float c110 = __ldg(c + GY * GZ + GZ), c111 = __ldg(c + GY * GZ + GZ + 1);
    const float c00 = c000 * (1 - fz) + c001 * fz;
    const float c01 = c010 * (1 - fz) + c011 * fz;
    const float c10 = c100 * (1 - fz) + c101 * fz;
    const float c11 = c110 * (1 - fz) + c111 * fz;
    const float c0 = c00 * (1 - fy) + c01 * fy;
    const float c1 = c10 * (1 - fy) + c11 * fy;
    const float val = c0 * (1 - fx) + c1 * fx;
    const float dx = (c1 - c0);
    const float dy = ((c01 - c00) * (1 - fx) + (c11 - c10) * fx);
    const float dz = (((c001 - c000) * (1 - fy) + (c011 - c010) * fy) * (1 - fx)
                      + ((c101 - c100) * (1 - fy) + (c111 - c110) * fy) * fx);
    *grad = v3(dx / vs, dy / vs, dz / vs);
    return val;
}
#endif

__constant__ Spec c_spec;

// Row offsets of the env-minor state buffer [FIS_NF, E].
enum {
    R_QPOS = 0,
    R_QVEL = R_QPOS + D,
    R_ROOTP = R_QVEL + D,
    R_ROOTQ = R_ROOTP + 3,
    R_OQ = R_ROOTQ + 4,
    R_OV = R_OQ + DO,
    R_ORP = R_OV + DO,
    R_ORQ = R_ORP + 3,
    R_ANCP = R_ORQ + 4,
    R_TGT = R_ANCP + 3 * S,
    FIS_NF = R_TGT + D
};

__device__ __forceinline__ Q4 ld4(const float* p) { Q4 r = {p[0], p[1], p[2], p[3]}; return r; }

// ---------------------------------------------------------------------------
// Tree functions, shared by the robot (T = Spec, constant memory) and the
// object (T = ObjSpec, global memory): both name their tree fields alike.
// ---------------------------------------------------------------------------

// Forward kinematics (kinematics.forward_kinematics): link poses, per-dof
// world axes and anchors, revolute / prismatic indicators.
template <int NL, int ND, class T>
__device__ __forceinline__ void tree_fk(const T& t, const float* q, V3 root_p, Q4 root_q,
                                        V3* lp, Q4* lq, V3* axis_w, V3* anchor_w,
                                        float* rev, float* pris) {
    lp[0] = quat_rotate(root_q, ld3(t.origin_pos[0])) + root_p;
    lq[0] = quat_mul(root_q, ld4(t.origin_quat[0]));
    for (int l = 1; l < NL; ++l) {
        int pi = t.parent[l] > 0 ? t.parent[l] : 0;
        V3 jp = quat_rotate(lq[pi], ld3(t.origin_pos[l])) + lp[pi];
        Q4 jqw = quat_mul(lq[pi], ld4(t.origin_quat[l]));
        float ql = q[t.dof_idx[l]];
        float is_rev = t.joint_type[l] == 1 ? 1.0f : 0.0f;
        float is_pris = t.joint_type[l] == 2 ? 1.0f : 0.0f;
        V3 ax = ld3(t.axis[l]);
        float half_ang = 0.5f * (ql * is_rev);
        float sn = sinf(half_ang), cs = cosf(half_ang);
        Q4 jq = {ax.x * sn, ax.y * sn, ax.z * sn, cs};
        V3 jt = ax * (ql * is_pris);
        lp[l] = jp + quat_rotate(jqw, jt);
        lq[l] = quat_mul(jqw, jq);
    }
    for (int d = 0; d < ND; ++d) {
        int c = t.dof_child[d];
        axis_w[d] = quat_rotate(lq[c], ld3(t.axis[c]));
        anchor_w[d] = lp[c];
        int kind = t.joint_type[c];
        rev[d] = (kind == 1 ? 1.0f : 0.0f) * t.dof_mask[d];
        pris[d] = (kind == 2 ? 1.0f : 0.0f) * t.dof_mask[d];
    }
}

// Linear Jacobian column of dof d for a world point attached to a link with
// ancestor flag a (kinematics._columns).
__device__ __forceinline__ V3 jac_col(float a, int d, V3 point, const V3* axis_w,
                                      const V3* anchor_w, const float* rev, const float* pris) {
    V3 col = cross(axis_w[d], point - anchor_w[d]) * rev[d] + axis_w[d] * pris[d];
    return col * a;
}

// Joint-space inertia, lower triangle (dynamics.mass_matrix).
template <int NL, int ND, class T>
__device__ __forceinline__ void tree_mass(const T& t, const V3* lp, const Q4* lq,
                                          const V3* axis_w, const V3* anchor_w,
                                          const float* rev, const float* pris,
                                          float (*M)[ND]) {
    for (int d = 0; d < ND; ++d)
        for (int f = 0; f <= d; ++f) M[d][f] = 0.0f;
    for (int l = 0; l < NL; ++l) {
        V3 com_w = lp[l] + quat_rotate(lq[l], ld3(t.com[l]));
        float R[9], Iw[9], I[9];
#pragma unroll
        for (int k = 0; k < 9; ++k) I[k] = t.inertia[l][k];
        quat_to_mat(lq[l], R);
        rotate_inertia(R, I, Iw);
        V3 jv[ND], jw[ND], Ijw[ND];
        for (int d = 0; d < ND; ++d) {
            float a = t.ancestor[l][d];
            jv[d] = jac_col(a, d, com_w, axis_w, anchor_w, rev, pris);
            jw[d] = axis_w[d] * (rev[d] * a);
            Ijw[d] = matvec(Iw, jw[d]);
        }
        const float m = t.mass[l];
        for (int d = 0; d < ND; ++d) {
            if (t.ancestor[l][d] == 0.0f) continue;
            for (int f = 0; f <= d; ++f) {
                if (t.ancestor[l][f] == 0.0f) continue;
                M[d][f] += m * dot(jv[d], jv[f]) + dot(jw[d], Ijw[f]);
            }
        }
    }
    for (int d = 0; d < ND; ++d)
        M[d][d] += t.armature[d] * t.dof_mask[d] + (1.0f - t.dof_mask[d]);
}

// Two-pass effort-clamped implicit PD step (dynamics.step_tree) of one tree:
// (M + h D + h^2 K + Ac) qacc = tau_drive + tau_fric + tau_ext, then the
// clipped velocity / position update with joint limits.  q, qv updated in
// place; M, Ac lower triangles.
template <int ND, class T>
__device__ __forceinline__ void tree_step(const T& t, float (*M)[ND], float (*Ac)[ND],
                                          const float* tau_ext, const float* tgt,
                                          float* q, float* qv) {
    const float h = c_spec.h;
    float tau_d0[ND], tau_fric[ND], d_fric[ND], rhs[ND], qacc[ND];
    float A[ND][ND];
    for (int d = 0; d < ND; ++d) {
        tau_d0[d] = t.kp[d] * (tgt[d] - q[d] - h * qv[d]) - t.kd[d] * qv[d];
        tau_fric[d] = -t.friction[d] * clampf(qv[d] / c_spec.friction_veps, -1.0f, 1.0f);
        d_fric[d] = t.friction[d] / c_spec.friction_veps
                  * (fabsf(qv[d]) < c_spec.friction_veps ? 1.0f : 0.0f);
    }
    // pass 1: fully implicit, no effort limit
    for (int d = 0; d < ND; ++d) {
        for (int f = 0; f < d; ++f) A[d][f] = M[d][f] + Ac[d][f];
        float diag = h * (t.kd[d] + 0.0f + t.damping[d] + d_fric[d]) + (h * h) * t.kp[d];
        A[d][d] = M[d][d] + diag * t.dof_mask[d] + Ac[d][d];
        rhs[d] = (tau_d0[d] + tau_fric[d] + tau_ext[d]) * t.dof_mask[d];
    }
    spd_solve<ND>(A, rhs, qacc);
    // pass 2: saturated dofs become effort-limited velocity servos
    {
        float unsat[ND], b_imp[ND];
        for (int d = 0; d < ND; ++d) {
            float qa = qacc[d] * t.dof_mask[d];
            float tau_imp = tau_d0[d] - (h * h * t.kp[d] + h * t.kd[d]) * qa;
            float sat = fabsf(tau_imp) > t.effort[d] ? 1.0f : 0.0f;
            unsat[d] = 1.0f - sat;
            float a_max = t.effort[d] / fmaxf(M[d][d], 1e-9f);
            float err = tgt[d] - q[d];
            float aerr = fabsf(err);
            float sgn = err > 0.0f ? 1.0f : (err < 0.0f ? -1.0f : 0.0f);
            float v_opt = sgn * fminf(t.vel_limit[d],
                                      fminf(aerr / h, sqrtf(2.0f * c_spec.brake_beta * a_max * aerr)));
            float dv = v_opt - qv[d];
            b_imp[d] = sat * t.effort[d] / fmaxf(fabsf(dv), c_spec.sat_veps);
            float tau_drive = b_imp[d] * dv + unsat[d] * tau_d0[d];
            rhs[d] = (tau_drive + tau_fric[d] + tau_ext[d]) * t.dof_mask[d];
        }
        for (int d = 0; d < ND; ++d) {
            for (int f = 0; f < d; ++f) A[d][f] = M[d][f] + Ac[d][f];
            float diag = h * (t.kd[d] * unsat[d] + b_imp[d] + t.damping[d] + d_fric[d])
                       + (h * h) * (t.kp[d] * unsat[d]);
            A[d][d] = M[d][d] + diag * t.dof_mask[d] + Ac[d][d];
        }
        spd_solve<ND>(A, rhs, qacc);
    }
    float vel_new[ND];
    for (int d = 0; d < ND; ++d) {
        float qa = qacc[d] * t.dof_mask[d];
        float v_new = clampf(qv[d] + h * qa, -t.vel_limit[d], t.vel_limit[d]);
        float q_new = q[d] + h * v_new;
        bool at_lo = (q_new < t.lower[d]) && (v_new < 0.0f);
        bool at_hi = (q_new > t.upper[d]) && (v_new > 0.0f);
        vel_new[d] = ((at_lo || at_hi) ? 0.0f : v_new) * t.dof_mask[d];
        q[d] = clampf(q_new, t.lower[d], t.upper[d]) * t.dof_mask[d];
    }
    for (int d = 0; d < ND; ++d) qv[d] = vel_new[d];
}

// Linear and angular Jacobian columns of the object at the centre bp of a
// box on link li (engine: frame Jacobian at the link origin, shifted to the
// box centre by Jw x r).
__device__ __forceinline__ void box_jacobian(const ObjSpec& os, int li, V3 bp, const V3* olp,
                                             const V3* oaxis_w, const V3* oanchor_w,
                                             const float* orev, const float* opris,
                                             V3* jv, V3* jw) {
    const V3 r_box = bp - olp[li];
#pragma unroll
    for (int d = 0; d < DO; ++d) {
        float a = os.ancestor[li][d];
        V3 jv_link = jac_col(a, d, olp[li], oaxis_w, oanchor_w, orev, opris);
        jw[d] = oaxis_w[d] * (orev[d] * a);
        jv[d] = jv_link + cross(jw[d], r_box);
    }
}

__global__ void __launch_bounds__(FIS_BLOCK)
fused_inner_step_obj_kernel(const float* __restrict__ in, const int* __restrict__ anc_b_in,
                            float* __restrict__ out, int* __restrict__ anc_b_out,
                            const ObjSpec* __restrict__ obj_table,
#if FIS_K > 0
                            const GridSpec* __restrict__ grid_table, GridStack stack,
#endif
                            const int* __restrict__ obj_id, int E, int n_steps) {
    const int e = blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= E) return;
    const Spec& sp = c_spec;
    const ObjSpec& os = obj_table[obj_id[e]];
#if FIS_K > 0
    const GridSpec& gr = grid_table[obj_id[e]];
    const int KOFF = 2 + G;          // partner ids of the grid geoms start here
#endif
    const float h = sp.h;
#define IN(row) in[(size_t)(row) * E + e]
#define OUT(row) out[(size_t)(row) * E + e]

    // ---- load state ----
    float q[D], qv[D], tgt[D];
    for (int d = 0; d < D; ++d) {
        q[d] = IN(R_QPOS + d);
        qv[d] = IN(R_QVEL + d);
        tgt[d] = IN(R_TGT + d);
    }
    const V3 root_p = v3(IN(R_ROOTP), IN(R_ROOTP + 1), IN(R_ROOTP + 2));
    const Q4 root_q = {IN(R_ROOTQ), IN(R_ROOTQ + 1), IN(R_ROOTQ + 2), IN(R_ROOTQ + 3)};
    float oq[DO], ov[DO];
    for (int d = 0; d < DO; ++d) {
        oq[d] = IN(R_OQ + d);
        ov[d] = IN(R_OV + d);
    }
    const V3 oroot_p = v3(IN(R_ORP), IN(R_ORP + 1), IN(R_ORP + 2));
    const Q4 oroot_q = {IN(R_ORQ), IN(R_ORQ + 1), IN(R_ORQ + 2), IN(R_ORQ + 3)};
    V3 anc_p[S];
    int anc_b[S];
    for (int s = 0; s < S; ++s) {
        anc_p[s] = v3(IN(R_ANCP + 3 * s), IN(R_ANCP + 3 * s + 1), IN(R_ANCP + 3 * s + 2));
        anc_b[s] = anc_b_in[(size_t)s * E + e];
    }

    for (int step = 0; step < n_steps; ++step) {
        // ---- robot: kinematics and inertia ----
        V3 lp[L], axis_w[D], anchor_w[D];
        Q4 lq[L];
        float rev[D], pris[D];
        tree_fk<L, D>(sp, q, root_p, root_q, lp, lq, axis_w, anchor_w, rev, pris);
        float M[D][D];
        tree_mass<L, D>(sp, lp, lq, axis_w, anchor_w, rev, pris, M);

        // ---- object: kinematics, inertia, world box poses ----
        V3 olp[LO], oaxis_w[DO], oanchor_w[DO];
        Q4 olq[LO];
        float orev[DO], opris[DO];
        tree_fk<LO, DO>(os, oq, oroot_p, oroot_q, olp, olq, oaxis_w, oanchor_w, orev, opris);
        float Mo[DO][DO];
        tree_mass<LO, DO>(os, olp, olq, oaxis_w, oanchor_w, orev, opris, Mo);
        V3 bp[G];
        Q4 bq[G];
        for (int g = 0; g < G; ++g) {
            const int li = os.b_link[g];
            bp[g] = quat_rotate(olq[li], ld3(os.b_pos[g])) + olp[li];
            bq[g] = quat_mul(olq[li], ld4(os.b_quat[g]));
        }
#if FIS_K > 0
        V3 gp[K];
        Q4 gq[K];
        for (int k = 0; k < K; ++k) {
            const int li = gr.g_link[k];
            gp[k] = quat_rotate(olq[li], ld3(gr.g_pos[k])) + olp[li];
            gq[k] = quat_mul(olq[li], ld4(gr.g_quat[k]));
        }
#endif

        // ---- robot spheres: world centres and velocities ----
        V3 cen[S], vs[S];
        float n_act_g = 0.0f;
        for (int s = 0; s < S; ++s) {
            int li = sp.sph_link[s];
            V3 c = lp[li] + quat_rotate(lq[li], ld3(sp.sph_off[s]));
            V3 v = v3(0.0f, 0.0f, 0.0f);
            for (int d = 0; d < D; ++d) {
                float a = sp.ancestor[li][d];
                if (a == 0.0f) continue;
                v = v + jac_col(a, d, c, axis_w, anchor_w, rev, pris) * qv[d];
            }
            cen[s] = c;
            vs[s] = v;
            n_act_g += (c.z - sp.sph_radius[s]) < 0.0f ? 1.0f : 0.0f;
        }
        n_act_g = fmaxf(1.0f, n_act_g);

        // ---- narrowphase, pass A: touching sphere-box pairs, the budget
        // count over all of them, and the best (first deepest) box per sphere
        unsigned tmask[S];
        float best_bd[S];
        int best_g[S];
        for (int s = 0; s < S; ++s) {
            tmask[s] = 0u;
            best_bd[s] = 1e9f;
            best_g[s] = -1;
        }
        float n_act_o = 0.0f;
        for (int g = 0; g < G; ++g) {
            if (os.b_mask[g] == 0.0f) continue;       // inactive geom: never touches
            const V3 half = ld3(os.b_half[g]);
            for (int s = 0; s < S; ++s) {
                V3 n_local;
                float depth = box_sdf(quat_rotate_inv(bq[g], cen[s] - bp[g]), half, &n_local)
                            - sp.sph_radius[s];
                if (depth < 0.0f) {
                    tmask[s] |= 1u << g;
                    n_act_o += 1.0f;
                    if (depth < best_bd[s]) {
                        best_bd[s] = depth;
                        best_g[s] = g;
                    }
                }
            }
        }
        n_act_o = fmaxf(1.0f, n_act_o);
#if FIS_K > 0
        // the same for the grid geoms: touching = depth < 0 and an active
        // pair (unmasked geom, gradient norm > 1e-6); a budget of their own
        unsigned kmask[S];
        float best_kd[S];
        int best_k[S];
        for (int s = 0; s < S; ++s) {
            kmask[s] = 0u;
            best_kd[s] = 1e9f;
            best_k[s] = -1;
        }
        float n_act_k = 0.0f;
        for (int k = 0; k < K; ++k) {
            if (gr.g_mask[k] == 0.0f) continue;
            for (int s = 0; s < S; ++s) {
                V3 grad;
                const float val = grid_query_grad(stack, gr.g_gid[k],
                                                  quat_rotate_inv(gq[k], cen[s] - gp[k]), &grad);
                const float depth = val - sp.sph_radius[s];
                if (norm(grad) > 1e-6f && depth < 0.0f) {
                    kmask[s] |= 1u << k;
                    n_act_k += 1.0f;
                    if (depth < best_kd[s]) {
                        best_kd[s] = depth;
                        best_k[s] = k;
                    }
                }
            }
        }
        n_act_k = fmaxf(1.0f, n_act_k);
#endif

        // ---- pass B: forces, anchors, J^T F and J^T N J (robot), box
        // wrenches and J^T N J at the box centres (object) ----
        float tau[D], Ac[D][D], tau_o[DO], Ao[DO][DO];
        for (int d = 0; d < D; ++d) {
            tau[d] = 0.0f;
            for (int f = 0; f <= d; ++f) Ac[d][f] = 0.0f;
        }
        for (int d = 0; d < DO; ++d) {
            tau_o[d] = 0.0f;
            for (int f = 0; f <= d; ++f) Ao[d][f] = 0.0f;
        }
        for (int s = 0; s < S; ++s) {
            const V3 c = cen[s];
            const V3 v = vs[s];
            const float r = sp.sph_radius[s];
            const float dg = c.z - r;
            // partner choice in the order ground (0), boxes (2 + g): a later
            // partner wins only with a strictly smaller depth
            int id = -1;
            float bd = 1e9f;
            if (dg < 0.0f && dg < bd) { id = 0; bd = dg; }
            if (best_g[s] >= 0 && best_bd[s] < bd) { id = 2 + best_g[s]; bd = best_bd[s]; }
#if FIS_K > 0
            if (best_k[s] >= 0 && best_kd[s] < bd) { id = KOFF + best_k[s]; bd = best_kd[s]; }
#endif
            if (id < 0) {          // touches nothing: no force, anchor released
                anc_b[s] = -1;
                continue;
            }
            V3 F = v3(0.0f, 0.0f, 0.0f);
            float N[9];
#pragma unroll
            for (int k = 0; k < 9; ++k) N[k] = 0.0f;
            float fn_g = 0.0f;
            const float mu_g = 0.5f * (sp.sph_mu[s] + sp.ground_mu);
            if (dg < 0.0f) {
                F = F + penalty_force(dg, v3(0.0f, 0.0f, 1.0f), v, mu_g, 0.5f, sp.cd_ground,
                                      n_act_g, 0.0f, h, sp.kn, sp.kt, sp.max_depen, &fn_g);
                N[8] += sp.coef_ground;
            }
            // the touching boxes, in box order
            V3 sel_n = v3(0.0f, 0.0f, 1.0f), sel_vo = v3(0.0f, 0.0f, 0.0f);
            float sel_fn = 0.0f, sel_mu = 0.0f;
            V3 sel_jv[DO], sel_jw[DO];
            for (unsigned m = tmask[s]; m != 0u; m &= m - 1u) {
                const int g = __ffs(m) - 1;
                const V3 rel = c - bp[g];
                V3 n_local;
                const float depth = box_sdf(quat_rotate_inv(bq[g], rel), ld3(os.b_half[g]),
                                            &n_local) - r;
                const V3 n = quat_rotate(bq[g], n_local);
                V3 jv[DO], jw[DO];
                box_jacobian(os, os.b_link[g], bp[g], olp, oaxis_w, oanchor_w, orev, opris,
                             jv, jw);
                V3 vbc = v3(0.0f, 0.0f, 0.0f), wb = v3(0.0f, 0.0f, 0.0f);
#pragma unroll
                for (int d = 0; d < DO; ++d) {
                    vbc = vbc + jv[d] * ov[d];
                    wb = wb + jw[d] * ov[d];
                }
                const V3 vo = vbc + cross(wb, rel);
                const float mu_o = 0.5f * (sp.sph_mu[s] + os.b_mu[g]);
                float fn;
                const V3 f = penalty_force(depth, n, v - vo, mu_o, 0.3f, sp.cd_obj, n_act_o,
                                           0.0f, h, sp.kn, sp.kt, sp.max_depen, &fn);
                F = F + f;
                const float nn[3] = {n.x, n.y, n.z};
#pragma unroll
                for (int a = 0; a < 3; ++a)
#pragma unroll
                    for (int b = 0; b < 3; ++b) N[a * 3 + b] += sp.coef_obj * nn[a] * nn[b];
                // reaction on the object: the wrench (-f, -(rel x f)) about the
                // box centre through the box Jacobian, and coef J^T n n^T J
                const V3 tf = cross(rel, f);
                float jn[DO];
#pragma unroll
                for (int d = 0; d < DO; ++d) {
                    tau_o[d] -= dot(jv[d], f) + dot(jw[d], tf);
                    jn[d] = dot(jv[d], n);
                }
#pragma unroll
                for (int d = 0; d < DO; ++d)
#pragma unroll
                    for (int f2 = 0; f2 <= d; ++f2) Ao[d][f2] += sp.coef_obj * jn[d] * jn[f2];
                if (id == 2 + g) {
                    sel_n = n;
                    sel_fn = fn;
                    sel_mu = mu_o;
                    sel_vo = vo;
#pragma unroll
                    for (int d = 0; d < DO; ++d) {
                        sel_jv[d] = jv[d];
                        sel_jw[d] = jw[d];
                    }
                }
            }
#if FIS_K > 0
            // the touching grid geoms, in geom order
            for (unsigned m = kmask[s]; m != 0u; m &= m - 1u) {
                const int k = __ffs(m) - 1;
                const V3 rel = c - gp[k];
                V3 grad;
                const float depth = grid_query_grad(stack, gr.g_gid[k],
                                                    quat_rotate_inv(gq[k], rel), &grad) - r;
                const V3 n = quat_rotate(gq[k], grad / fmaxf(norm(grad), 1e-9f));
                V3 jv[DO], jw[DO];
                box_jacobian(os, gr.g_link[k], gp[k], olp, oaxis_w, oanchor_w, orev, opris,
                             jv, jw);
                V3 vgc = v3(0.0f, 0.0f, 0.0f), wg = v3(0.0f, 0.0f, 0.0f);
#pragma unroll
                for (int d = 0; d < DO; ++d) {
                    vgc = vgc + jv[d] * ov[d];
                    wg = wg + jw[d] * ov[d];
                }
                const V3 vo = vgc + cross(wg, rel);
                const float mu_k = 0.5f * (sp.sph_mu[s] + gr.g_mu[k]);
                float fn;
                const V3 f = penalty_force(depth, n, v - vo, mu_k, 0.3f, sp.cd_obj, n_act_k,
                                           0.0f, h, sp.kn, sp.kt, sp.max_depen, &fn);
                F = F + f;
                const float nn[3] = {n.x, n.y, n.z};
#pragma unroll
                for (int a = 0; a < 3; ++a)
#pragma unroll
                    for (int b = 0; b < 3; ++b) N[a * 3 + b] += sp.coef_obj * nn[a] * nn[b];
                // reaction on the object about the grid origin
                const V3 tf = cross(rel, f);
                float jn[DO];
#pragma unroll
                for (int d = 0; d < DO; ++d) {
                    tau_o[d] -= dot(jv[d], f) + dot(jw[d], tf);
                    jn[d] = dot(jv[d], n);
                }
#pragma unroll
                for (int d = 0; d < DO; ++d)
#pragma unroll
                    for (int f2 = 0; f2 <= d; ++f2) Ao[d][f2] += sp.coef_obj * jn[d] * jn[f2];
                if (id == KOFF + k) {
                    sel_n = n;
                    sel_fn = fn;
                    sel_mu = mu_k;
                    sel_vo = vo;
#pragma unroll
                    for (int d = 0; d < DO; ++d) {
                        sel_jv[d] = jv[d];
                        sel_jw[d] = jw[d];
                    }
                }
            }
            const bool on_grid = id >= KOFF;
            const int ks = on_grid ? id - KOFF : 0;
#else
            const bool on_grid = false;
            const int ks = 0;
#endif
            // the selected contact
            const bool on_box = id >= 2 && !on_grid;
            const bool on_obj = id >= 2;
            const int gs = on_box ? id - 2 : 0;
            const V3 n = on_obj ? sel_n : v3(0.0f, 0.0f, 1.0f);
            const float fn = on_obj ? sel_fn : fn_g;
            const float mu = on_obj ? sel_mu : mu_g;
            const V3 pvel = on_obj ? sel_vo : v3(0.0f, 0.0f, 0.0f);
            const V3 v_rel = v - pvel;
            const V3 vt = v_rel - dot(v_rel, n) * n;

            // stick-slip anchor (contact.anchor_friction), sticky spheres only
            V3 ft = v3(0.0f, 0.0f, 0.0f);
            const float sticky = sp.sph_sticky[s];
            if (sticky > 0.0f) {
                const bool same = anc_b[s] == id;
                V3 aw = anc_p[s];                       // ground / none: world frame
                if (anc_b[s] >= 2) {
                    const int ga = min(anc_b[s] - 2, G - 1);
                    aw = quat_rotate(bq[ga], anc_p[s]) + bp[ga];
                }
#if FIS_K > 0
                if (anc_b[s] >= KOFF) {
                    const int ka = min(anc_b[s] - KOFF, K - 1);
                    aw = quat_rotate(gq[ka], anc_p[s]) + gp[ka];
                }
#endif
                V3 delta = c - aw;
                V3 delta_t = delta - dot(delta, n) * n;
                V3 ft_raw = same ? (-sp.anchor_ks) * delta_t - sp.anchor_cdt * vt
                                 : (-sp.anchor_cdt) * vt;
                float ft_mag = norm(ft_raw);
                float limit = mu * fn;
                bool stick = (ft_mag <= limit) && same;
                float scale = ft_mag > 1e-9f ? fminf(limit / fmaxf(ft_mag, 1e-9f), 1.0f) : 0.0f;
                ft = ft_raw * scale;
                V3 new_w = stick ? aw : c + ft / sp.anchor_ks;
                anc_p[s] = on_box ? quat_rotate_inv(bq[gs], new_w - bp[gs]) : new_w;
#if FIS_K > 0
                if (on_grid) anc_p[s] = quat_rotate_inv(gq[ks], new_w - gp[ks]);
#endif
                anc_b[s] = id;
                ft = ft * sticky;
            } else {
                anc_b[s] = -1;
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
            // friction reaction on the object (no velocity cap: the cabinet
            // is an articulation, not a free body)
            if (on_box) {
                const V3 tf = cross(c - bp[gs], ft);
#pragma unroll
                for (int d = 0; d < DO; ++d) tau_o[d] -= dot(sel_jv[d], ft) + dot(sel_jw[d], tf);
            }
#if FIS_K > 0
            if (on_grid) {
                const V3 tf = cross(c - gp[ks], ft);
#pragma unroll
                for (int d = 0; d < DO; ++d) tau_o[d] -= dot(sel_jv[d], ft) + dot(sel_jw[d], tf);
            }
#endif
            // robot joint space: tau += Jp^T F,  Ac += Jp^T N Jp
            const int li = sp.sph_link[s];
            V3 jp[D], Njp[D];
            for (int d = 0; d < D; ++d) {
                jp[d] = jac_col(sp.ancestor[li][d], d, c, axis_w, anchor_w, rev, pris);
                Njp[d] = matvec(N, jp[d]);
            }
            for (int d = 0; d < D; ++d) {
                if (sp.ancestor[li][d] == 0.0f) continue;
                tau[d] += dot(jp[d], F);
                for (int f = 0; f <= d; ++f) {
                    if (sp.ancestor[li][f] == 0.0f) continue;
                    Ac[d][f] += dot(jp[d], Njp[f]);
                }
            }
        }

        // ---- both trees: two-pass effort-clamped implicit PD ----
        tree_step<D>(sp, M, Ac, tau, tgt, q, qv);
        float otgt[DO];
        for (int d = 0; d < DO; ++d) otgt[d] = oq[d];   // the object holds its own pose
        tree_step<DO>(os, Mo, Ao, tau_o, otgt, oq, ov);
    }

    // ---- store state (roots and targets pass through) ----
    for (int d = 0; d < D; ++d) {
        OUT(R_QPOS + d) = q[d];
        OUT(R_QVEL + d) = qv[d];
        OUT(R_TGT + d) = tgt[d];
    }
    OUT(R_ROOTP) = root_p.x; OUT(R_ROOTP + 1) = root_p.y; OUT(R_ROOTP + 2) = root_p.z;
    OUT(R_ROOTQ) = root_q.x; OUT(R_ROOTQ + 1) = root_q.y; OUT(R_ROOTQ + 2) = root_q.z;
    OUT(R_ROOTQ + 3) = root_q.w;
    for (int d = 0; d < DO; ++d) {
        OUT(R_OQ + d) = oq[d];
        OUT(R_OV + d) = ov[d];
    }
    OUT(R_ORP) = oroot_p.x; OUT(R_ORP + 1) = oroot_p.y; OUT(R_ORP + 2) = oroot_p.z;
    OUT(R_ORQ) = oroot_q.x; OUT(R_ORQ + 1) = oroot_q.y; OUT(R_ORQ + 2) = oroot_q.z;
    OUT(R_ORQ + 3) = oroot_q.w;
    for (int s = 0; s < S; ++s) {
        OUT(R_ANCP + 3 * s) = anc_p[s].x;
        OUT(R_ANCP + 3 * s + 1) = anc_p[s].y;
        OUT(R_ANCP + 3 * s + 2) = anc_p[s].z;
        anc_b_out[(size_t)s * E + e] = anc_b[s];
    }
#undef IN
#undef OUT
}

extern "C" {

// Sizes the wrapper checks against its own packing.
int fis_spec_bytes() { return (int)sizeof(Spec); }
int fis_obj_bytes() { return (int)sizeof(ObjSpec); }
int fis_state_rows() { return (int)FIS_NF; }
#if FIS_K > 0
int fis_grid_bytes() { return (int)sizeof(GridSpec); }
int fis_dims(int which) {
    const int dims[10] = {L, D, S, LO, DO, G, K, GX, GY, GZ};
    return (which >= 0 && which < 10) ? dims[which] : -1;
}
#else
int fis_dims(int which) {
    const int dims[6] = {L, D, S, LO, DO, G};
    return (which >= 0 && which < 6) ? dims[which] : -1;
}
#endif

// Copy the robot / contact description into constant memory, ordered on
// `stream`.
int fis_set_spec(const void* host_spec, int bytes, void* stream) {
    if (bytes != (int)sizeof(Spec)) return -1;
    cudaError_t err = cudaMemcpyToSymbolAsync(c_spec, host_spec, sizeof(Spec), 0,
                                              cudaMemcpyHostToDevice, (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

#if FIS_K > 0
// Launch n_steps inner steps for E envs on `stream`; obj_table and
// grid_table hold n_obj ObjSpec / GridSpec records on the device, obj_id[E]
// picks one of each per env; the grid stack holds n_grid grids.  Returns
// cudaGetLastError().
int fis_launch(const void* in, const void* anc_b_in, void* out, void* anc_b_out,
               const void* obj_table, const void* grid_table, const void* obj_id, int n_obj,
               const void* grid_sdf, const void* grid_bbox, const void* grid_voxel, int n_grid,
               int E, int n_steps, void* stream) {
    if (E < 1 || n_steps < 0 || n_obj < 1 || n_grid < 1) return -1;
    int blocks = (E + FIS_BLOCK - 1) / FIS_BLOCK;
    GridStack st = {(const float*)grid_sdf, (const float*)grid_bbox, (const float*)grid_voxel};
    fused_inner_step_obj_kernel<<<blocks, FIS_BLOCK, 0, (cudaStream_t)stream>>>(
        (const float*)in, (const int*)anc_b_in, (float*)out, (int*)anc_b_out,
        (const ObjSpec*)obj_table, (const GridSpec*)grid_table, st, (const int*)obj_id, E,
        n_steps);
    return (int)cudaGetLastError();
}
#else
// Launch n_steps inner steps for E envs on `stream`; obj_table holds n_obj
// ObjSpec records on the device, obj_id[E] picks one per env.  Returns
// cudaGetLastError().
int fis_launch(const void* in, const void* anc_b_in, void* out, void* anc_b_out,
               const void* obj_table, const void* obj_id, int n_obj, int E, int n_steps,
               void* stream) {
    if (E < 1 || n_steps < 0 || n_obj < 1) return -1;
    int blocks = (E + FIS_BLOCK - 1) / FIS_BLOCK;
    fused_inner_step_obj_kernel<<<blocks, FIS_BLOCK, 0, (cudaStream_t)stream>>>(
        (const float*)in, (const int*)anc_b_in, (float*)out, (int*)anc_b_out,
        (const ObjSpec*)obj_table, (const int*)obj_id, E, n_steps);
    return (int)cudaGetLastError();
}
#endif

}  // extern "C"
