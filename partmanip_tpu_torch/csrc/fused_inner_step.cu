// Fused physics inner step for a scene of robot + ground + one free box
// (variant B1a), CUDA C++ for sm_90a.
//
// Replaces the TPU Pallas kernel of partmanip_tpu/sim/fused.py
// (_make_step_call -> kernel, body _inner_step_tiled with has_body=True,
// has_obj=False, n_grid=0) and computes exactly what
// partmanip_tpu_torch/sim/engine.py:_inner_step computes, which is its plain
// PyTorch version: forward kinematics -> point Jacobians -> mass matrix ->
// narrowphase of the S robot spheres against the ground and the free box ->
// penalty forces with impulse budgets, recede damping and the per-body
// delta-v cap -> best-partner choice (ground id 0, box id 1) -> stick-slip
// anchor update -> J^T N J -> two-pass effort-clamped implicit PD solve
// (Cholesky) -> free-body integration.
//
// Design.  Environments are independent, so one thread owns one env and the
// whole loop of n_steps inner steps runs inside one launch with the state in
// registers / local memory: one launch per control step instead of one per
// inner step.  State arrives env-minor ([feature, E]) so that the loads and
// stores of a warp are contiguous.  The scene description (tree topology,
// joint origins, masses, gains, limits, sphere table, contact constants) is
// uploaded from the port's TreeSpec into __constant__ memory; all threads
// index it uniformly, so every read is a broadcast.  Only the array sizes
// (FIS_L links, FIS_D dofs, FIS_S spheres) are compile-time.
//
// What bounds it on an H100: not device memory (about 120 floats in and out
// per env and launch, < 1 KB; 2 MB at 2048 envs) but f32 arithmetic latency
// and the launch itself: at 2048 envs there are 64 warps for 132 SMs, each
// running a long dependent chain (two 9x9 Cholesky solves per inner step),
// and the per-thread working set (link poses, mass matrix, per-sphere
// contact records) lives in local memory (L1).  This version is written to
// be right first: blocks of one warp spread the envs over as many SMs as
// possible and Jacobian columns are recomputed per sphere instead of being
// held.  Splitting one env over several threads is later work.
//
// Numerics follow the plain version literally (sqrt(max(s, 1e-12)) and the
// divisions of the Cholesky, every max(x, eps) guard, the order of the
// clamps); build without -use_fast_math.  What differs is fma contraction
// and the order of sums.

#include <cuda_runtime.h>

#include "fused_common.cuh"

#ifndef FIS_L
#define FIS_L 13
#endif
#ifndef FIS_D
#define FIS_D 9
#endif
#ifndef FIS_S
#define FIS_S 18
#endif
#ifndef FIS_BLOCK
#define FIS_BLOCK 32
#endif

#define L FIS_L
#define D FIS_D
#define S FIS_S

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
    float cube_mass;
    float cube_inertia[9];
    float cube_half[3];
    float cube_gscale;
    float cube_mu;
    float h;
    float gravity;
    float kn;
    float kt;
    float max_depen;
    float ground_mu;
    // derived on the host with the plain version's formulas
    float cd_ground;          // 2 zeta sqrt(kn * 0.5)
    float cd_cube;            // 2 zeta sqrt(kn * m_cube)
    float cd_corner;          // 2 zeta sqrt(kn * m_cube / 4)
    float coef_ground;        // h cd_ground + h^2 kn
    float coef_cube;          // h cd_cube + h^2 kn
    float anchor_ks;
    float anchor_cdt;         // 2 zeta_a sqrt(ks * 0.1)
    float coef_anchor;        // h cdt + h^2 ks
    float hold_vel;
    float friction_veps;
    float brake_beta;
    float sat_veps;
};

__constant__ Spec c_spec;

// Row offsets of the env-minor state buffer [FIS_NF, E].
enum {
    R_QPOS = 0,
    R_QVEL = R_QPOS + D,
    R_ROOTP = R_QVEL + D,
    R_ROOTQ = R_ROOTP + 3,
    R_BPOS = R_ROOTQ + 4,
    R_BQUAT = R_BPOS + 3,
    R_BLIN = R_BQUAT + 4,
    R_BANG = R_BLIN + 3,
    R_ANCP = R_BANG + 3,
    R_TGT = R_ANCP + 3 * S,
    FIS_NF = R_TGT + D
};

// Regularized penalty force of one contact with this scene's constants.
__device__ __forceinline__ V3 penalty(float depth, V3 n, V3 v_rel, float mu, float m_eff,
                                      float cd, float n_act, float recede_damp, float* fn_out) {
    return penalty_force(depth, n, v_rel, mu, m_eff, cd, n_act, recede_damp, c_spec.h,
                         c_spec.kn, c_spec.kt, c_spec.max_depen, fn_out);
}

// Linear Jacobian column of dof d for a world point attached to link li.
__device__ __forceinline__ V3 jac_col(int li, int d, V3 point, const V3* axis_w,
                                      const V3* anchor_w, const float* rev, const float* pris) {
    V3 col = cross(axis_w[d], point - anchor_w[d]) * rev[d] + axis_w[d] * pris[d];
    return col * c_spec.ancestor[li][d];
}

__global__ void __launch_bounds__(FIS_BLOCK)
fused_inner_step_kernel(const float* __restrict__ in, const int* __restrict__ anc_b_in,
                        float* __restrict__ out, int* __restrict__ anc_b_out,
                        int E, int n_steps) {
    const int e = blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= E) return;
    const Spec& sp = c_spec;
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
    V3 bpos = v3(IN(R_BPOS), IN(R_BPOS + 1), IN(R_BPOS + 2));
    Q4 bquat = {IN(R_BQUAT), IN(R_BQUAT + 1), IN(R_BQUAT + 2), IN(R_BQUAT + 3)};
    V3 blin = v3(IN(R_BLIN), IN(R_BLIN + 1), IN(R_BLIN + 2));
    V3 bang = v3(IN(R_BANG), IN(R_BANG + 1), IN(R_BANG + 2));
    V3 anc_p[S];
    int anc_b[S];
    for (int s = 0; s < S; ++s) {
        anc_p[s] = v3(IN(R_ANCP + 3 * s), IN(R_ANCP + 3 * s + 1), IN(R_ANCP + 3 * s + 2));
        anc_b[s] = anc_b_in[(size_t)s * E + e];
    }

    // per-dof joint kind (static)
    float rev[D], pris[D];
    for (int d = 0; d < D; ++d) {
        int kind = sp.joint_type[sp.dof_child[d]];
        rev[d] = (kind == 1 ? 1.0f : 0.0f) * sp.dof_mask[d];
        pris[d] = (kind == 2 ? 1.0f : 0.0f) * sp.dof_mask[d];
    }
    const V3 half = v3(sp.cube_half[0], sp.cube_half[1], sp.cube_half[2]);

    for (int step = 0; step < n_steps; ++step) {
        // ---- forward kinematics ----
        V3 lp[L];
        Q4 lq[L];
        {
            Q4 oq = {sp.origin_quat[0][0], sp.origin_quat[0][1], sp.origin_quat[0][2],
                     sp.origin_quat[0][3]};
            lp[0] = quat_rotate(root_q, ld3(sp.origin_pos[0])) + root_p;
            lq[0] = quat_mul(root_q, oq);
        }
        for (int l = 1; l < L; ++l) {
            int pi = sp.parent[l] > 0 ? sp.parent[l] : 0;
            Q4 oq = {sp.origin_quat[l][0], sp.origin_quat[l][1], sp.origin_quat[l][2],
                     sp.origin_quat[l][3]};
            V3 jp = quat_rotate(lq[pi], ld3(sp.origin_pos[l])) + lp[pi];
            Q4 jqw = quat_mul(lq[pi], oq);
            float ql = q[sp.dof_idx[l]];
            float is_rev = sp.joint_type[l] == 1 ? 1.0f : 0.0f;
            float is_pris = sp.joint_type[l] == 2 ? 1.0f : 0.0f;
            V3 ax = ld3(sp.axis[l]);
            float half_ang = 0.5f * (ql * is_rev);
            float sn = sinf(half_ang), cs = cosf(half_ang);
            Q4 jq = {ax.x * sn, ax.y * sn, ax.z * sn, cs};
            V3 jt = ax * (ql * is_pris);
            lp[l] = jp + quat_rotate(jqw, jt);
            lq[l] = quat_mul(jqw, jq);
        }
        V3 axis_w[D], anchor_w[D];
        for (int d = 0; d < D; ++d) {
            int c = sp.dof_child[d];
            axis_w[d] = quat_rotate(lq[c], ld3(sp.axis[c]));
            anchor_w[d] = lp[c];
        }

        // ---- mass matrix (lower triangle) ----
        float M[D][D];
        for (int d = 0; d < D; ++d)
            for (int f = 0; f <= d; ++f) M[d][f] = 0.0f;
        for (int l = 0; l < L; ++l) {
            V3 com_w = lp[l] + quat_rotate(lq[l], ld3(sp.com[l]));
            float R[9], Iw[9];
            quat_to_mat(lq[l], R);
            rotate_inertia(R, sp.inertia[l], Iw);
            V3 jv[D], jw[D], Ijw[D];
            for (int d = 0; d < D; ++d) {
                float a = sp.ancestor[l][d];
                jv[d] = jac_col(l, d, com_w, axis_w, anchor_w, rev, pris);
                jw[d] = axis_w[d] * (rev[d] * a);
                Ijw[d] = matvec(Iw, jw[d]);
            }
            const float m = sp.mass[l];
            for (int d = 0; d < D; ++d) {
                if (sp.ancestor[l][d] == 0.0f) continue;
                for (int f = 0; f <= d; ++f) {
                    if (sp.ancestor[l][f] == 0.0f) continue;
                    M[d][f] += m * dot(jv[d], jv[f]) + dot(jw[d], Ijw[f]);
                }
            }
        }
        for (int d = 0; d < D; ++d)
            M[d][d] += sp.armature[d] * sp.dof_mask[d] + (1.0f - sp.dof_mask[d]);

        // ---- narrowphase, pass A: geometry, touch counts, best partner ----
        V3 cen[S], vs[S], nb[S];
        float depth_b[S];
        int best_id[S];
        float n_act_g = 0.0f, n_act_b = 0.0f, n_touch_cube = 0.0f;
        for (int s = 0; s < S; ++s) {
            int li = sp.sph_link[s];
            V3 c = lp[li] + quat_rotate(lq[li], ld3(sp.sph_off[s]));
            V3 v = v3(0.0f, 0.0f, 0.0f);
            for (int d = 0; d < D; ++d) {
                if (sp.ancestor[li][d] == 0.0f) continue;
                v = v + jac_col(li, d, c, axis_w, anchor_w, rev, pris) * qv[d];
            }
            cen[s] = c;
            vs[s] = v;
            float r = sp.sph_radius[s];
            float dg = c.z - r;
            V3 n_local;
            float dist = box_sdf(quat_rotate_inv(bquat, c - bpos), half, &n_local);
            nb[s] = quat_rotate(bquat, n_local);
            float db = dist - r;
            depth_b[s] = db;
            bool tg = dg < 0.0f, tb = db < 0.0f;
            n_act_g += tg ? 1.0f : 0.0f;
            n_act_b += tb ? 1.0f : 0.0f;
            // partner choice in the order ground (0), box (1): a later
            // partner wins only with a strictly smaller depth
            int id = -1;
            float bd = 1e9f;
            if (tg && dg < bd) { id = 0; bd = dg; }
            if (tb && db < bd) { id = 1; bd = db; }
            best_id[s] = id;
            n_touch_cube += id == 1 ? 1.0f : 0.0f;
        }
        n_act_g = fmaxf(1.0f, n_act_g);
        n_act_b = fmaxf(1.0f, n_act_b);
        n_touch_cube = fmaxf(1.0f, n_touch_cube);

        // ---- pass B: forces, anchors, J^T F and J^T N J ----
        float tau[D];
        float Ac[D][D];
        for (int d = 0; d < D; ++d) {
            tau[d] = 0.0f;
            for (int f = 0; f <= d; ++f) Ac[d][f] = 0.0f;
        }
        V3 f_cube = v3(0.0f, 0.0f, 0.0f), t_cube = v3(0.0f, 0.0f, 0.0f);
        for (int s = 0; s < S; ++s) {
            const int id = best_id[s];
            if (id < 0) {          // touches nothing: no force, anchor released
                anc_b[s] = -1;
                continue;
            }
            const V3 c = cen[s];
            const V3 v = vs[s];
            const float r = sp.sph_radius[s];
            const float dg = c.z - r, db = depth_b[s];
            const V3 rc = c - bpos;
            const V3 v_cube = blin + cross(bang, rc);
            V3 F = v3(0.0f, 0.0f, 0.0f);
            float N[9];
#pragma unroll
            for (int k = 0; k < 9; ++k) N[k] = 0.0f;
            float fn_g = 0.0f, fn_b = 0.0f;
            const float mu_g = 0.5f * (sp.sph_mu[s] + sp.ground_mu);
            const float mu_b = 0.5f * (sp.sph_mu[s] + sp.cube_mu);
            if (dg < 0.0f) {
                F = F + penalty(dg, v3(0.0f, 0.0f, 1.0f), v, mu_g, 0.5f, sp.cd_ground,
                                n_act_g, 0.0f, &fn_g);
                N[8] += sp.coef_ground;
            }
            if (db < 0.0f) {
                V3 n = nb[s];
                V3 fb = penalty(db, n, v - v_cube, mu_b, sp.cube_mass, sp.cd_cube,
                                n_act_b, 1.0f, &fn_b);
                F = F + fb;
                float nn[3] = {n.x, n.y, n.z};
#pragma unroll
                for (int a = 0; a < 3; ++a)
#pragma unroll
                    for (int b = 0; b < 3; ++b) N[a * 3 + b] += sp.coef_cube * nn[a] * nn[b];
                f_cube = f_cube - fb;
                t_cube = t_cube - cross(rc, fb);
            }
            // the selected contact
            const V3 n = id == 1 ? nb[s] : v3(0.0f, 0.0f, 1.0f);
            const float fn = id == 1 ? fn_b : fn_g;
            const float mu = id == 1 ? mu_b : mu_g;
            const V3 pvel = id == 1 ? v_cube : v3(0.0f, 0.0f, 0.0f);
            const V3 v_rel = v - pvel;
            const V3 vt = v_rel - dot(v_rel, n) * n;

            // stick-slip anchor (contact.anchor_friction), sticky spheres only
            V3 ft = v3(0.0f, 0.0f, 0.0f);
            const float sticky = sp.sph_sticky[s];
            if (sticky > 0.0f) {
                const bool same = anc_b[s] == id;
                V3 aw = anc_b[s] == 1 ? quat_rotate(bquat, anc_p[s]) + bpos : anc_p[s];
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
                anc_p[s] = id == 1 ? quat_rotate_inv(bquat, new_w - bpos) : new_w;
                anc_b[s] = id;
                ft = ft * sticky;
            } else {
                anc_b[s] = -1;
            }
            F = F + ft;
            // implicit tangential operator (I - n n^T) of the selected contact
            {
                float nn[3] = {n.x, n.y, n.z};
#pragma unroll
                for (int a = 0; a < 3; ++a)
#pragma unroll
                    for (int b = 0; b < 3; ++b)
                        N[a * 3 + b] += sp.coef_anchor * ((a == b ? 1.0f : 0.0f) - nn[a] * nn[b]);
            }
            // friction reaction on the box, capped to velocity matching
            if (id == 1) {
                float cap = (sp.cube_mass / n_touch_cube) * (norm(vt) + sp.hold_vel) / h;
                float mag = norm(ft);
                V3 ftc = ft * (fminf(mag, cap) / fmaxf(mag, 1e-9f));
                f_cube = f_cube - ftc;
                t_cube = t_cube - cross(rc, ftc);
            }
            // joint space: tau += Jp^T F,  Ac += Jp^T N Jp
            const int li = sp.sph_link[s];
            V3 jp[D], Njp[D];
            for (int d = 0; d < D; ++d) {
                jp[d] = jac_col(li, d, c, axis_w, anchor_w, rev, pris);
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

        // ---- robot: two-pass effort-clamped implicit PD (dynamics.step_tree) ----
        float tau_d0[D], tau_fric[D], d_fric[D], rhs[D], qacc[D];
        float A[D][D];
        for (int d = 0; d < D; ++d) {
            tau_d0[d] = sp.kp[d] * (tgt[d] - q[d] - h * qv[d]) - sp.kd[d] * qv[d];
            tau_fric[d] = -sp.friction[d] * clampf(qv[d] / sp.friction_veps, -1.0f, 1.0f);
            d_fric[d] = sp.friction[d] / sp.friction_veps
                      * (fabsf(qv[d]) < sp.friction_veps ? 1.0f : 0.0f);
        }
        // pass 1: fully implicit, no effort limit
        for (int d = 0; d < D; ++d) {
            for (int f = 0; f < d; ++f) A[d][f] = M[d][f] + Ac[d][f];
            float diag = h * (sp.kd[d] + 0.0f + sp.damping[d] + d_fric[d]) + (h * h) * sp.kp[d];
            A[d][d] = M[d][d] + diag * sp.dof_mask[d] + Ac[d][d];
            rhs[d] = (tau_d0[d] + tau_fric[d] + tau[d]) * sp.dof_mask[d];
        }
        spd_solve(A, rhs, qacc);
        // pass 2: saturated dofs become effort-limited velocity servos
        float vel_new[D];
        {
            float unsat[D], b_imp[D];
            for (int d = 0; d < D; ++d) {
                float qa = qacc[d] * sp.dof_mask[d];
                float tau_imp = tau_d0[d] - (h * h * sp.kp[d] + h * sp.kd[d]) * qa;
                float sat = fabsf(tau_imp) > sp.effort[d] ? 1.0f : 0.0f;
                unsat[d] = 1.0f - sat;
                float a_max = sp.effort[d] / fmaxf(M[d][d], 1e-9f);
                float err = tgt[d] - q[d];
                float aerr = fabsf(err);
                float sgn = err > 0.0f ? 1.0f : (err < 0.0f ? -1.0f : 0.0f);
                float v_opt = sgn * fminf(sp.vel_limit[d],
                                          fminf(aerr / h, sqrtf(2.0f * sp.brake_beta * a_max * aerr)));
                float dv = v_opt - qv[d];
                b_imp[d] = sat * sp.effort[d] / fmaxf(fabsf(dv), sp.sat_veps);
                float tau_drive = b_imp[d] * dv + unsat[d] * tau_d0[d];
                rhs[d] = (tau_drive + tau_fric[d] + tau[d]) * sp.dof_mask[d];
            }
            for (int d = 0; d < D; ++d) {
                for (int f = 0; f < d; ++f) A[d][f] = M[d][f] + Ac[d][f];
                float diag = h * (sp.kd[d] * unsat[d] + b_imp[d] + sp.damping[d] + d_fric[d])
                           + (h * h) * (sp.kp[d] * unsat[d]);
                A[d][d] = M[d][d] + diag * sp.dof_mask[d] + Ac[d][d];
            }
            spd_solve(A, rhs, qacc);
        }
        for (int d = 0; d < D; ++d) {
            float qa = qacc[d] * sp.dof_mask[d];
            float v_new = clampf(qv[d] + h * qa, -sp.vel_limit[d], sp.vel_limit[d]);
            float q_new = q[d] + h * v_new;
            bool at_lo = (q_new < sp.lower[d]) && (v_new < 0.0f);
            bool at_hi = (q_new > sp.upper[d]) && (v_new > 0.0f);
            vel_new[d] = ((at_lo || at_hi) ? 0.0f : v_new) * sp.dof_mask[d];
            q[d] = clampf(q_new, sp.lower[d], sp.upper[d]) * sp.dof_mask[d];
        }
        for (int d = 0; d < D; ++d) qv[d] = vel_new[d];

        // ---- free box: corners against the ground, delta-v cap, integrate ----
        {
            V3 cw[8];
            float n_act_c = 0.0f;
#pragma unroll
            for (int k = 0; k < 8; ++k) {
                V3 cl = v3((k & 4) ? half.x : -half.x, (k & 2) ? half.y : -half.y,
                           (k & 1) ? half.z : -half.z);
                cw[k] = bpos + quat_rotate(bquat, cl);
                n_act_c += cw[k].z < 0.0f ? 1.0f : 0.0f;
            }
            n_act_c = fmaxf(1.0f, n_act_c);
            const float mu_c = 0.5f * (sp.cube_mu + sp.ground_mu);
            const float m_corner = sp.cube_mass / 4.0f;
#pragma unroll
            for (int k = 0; k < 8; ++k) {
                if (!(cw[k].z < 0.0f)) continue;
                V3 rck = cw[k] - bpos;
                V3 vck = blin + cross(bang, rck);
                float fn_unused;
                V3 fc = penalty(cw[k].z, v3(0.0f, 0.0f, 1.0f), vck, mu_c, m_corner,
                                sp.cd_corner, n_act_c, 1.0f, &fn_unused);
                f_cube = f_cube + fc;
                t_cube = t_cube + cross(rck, fc);
            }
            float dv = norm(f_cube) * h / sp.cube_mass;
            float dv_scale = fminf(1.0f, sp.max_depen / fmaxf(dv, 1e-9f));
            f_cube = f_cube * dv_scale;
            t_cube = t_cube * dv_scale;

            // contact.integrate_free_body
            float R[9], Iw[9];
            quat_to_mat(bquat, R);
            rotate_inertia(R, sp.cube_inertia, Iw);
            float a = Iw[0], b = Iw[1], c = Iw[2], d = Iw[3], ee = Iw[4], f = Iw[5],
                  g = Iw[6], hh = Iw[7], i = Iw[8];
            float co00 = ee * i - f * hh, co01 = c * hh - b * i, co02 = b * f - c * ee;
            float co10 = f * g - d * i, co11 = a * i - c * g, co12 = c * d - a * f;
            float co20 = d * hh - ee * g, co21 = b * g - a * hh, co22 = a * ee - b * d;
            float det = a * co00 + b * co10 + c * co20;
            float Iinv[9] = {co00 / det, co01 / det, co02 / det, co10 / det, co11 / det,
                             co12 / det, co20 / det, co21 / det, co22 / det};
            V3 linacc = f_cube / sp.cube_mass + v3(0.0f, 0.0f, sp.gravity) * sp.cube_gscale;
            V3 gyro = cross(bang, matvec(Iw, bang));
            V3 angacc = matvec(Iinv, t_cube - gyro);
            blin = v3(clampf(blin.x + h * linacc.x, -20.0f, 20.0f),
                      clampf(blin.y + h * linacc.y, -20.0f, 20.0f),
                      clampf(blin.z + h * linacc.z, -20.0f, 20.0f));
            bang = v3(clampf(bang.x + h * angacc.x, -50.0f, 50.0f),
                      clampf(bang.y + h * angacc.y, -50.0f, 50.0f),
                      clampf(bang.z + h * angacc.z, -50.0f, 50.0f));
            bpos = bpos + h * blin;
            Q4 dq = {0.5f * h * bang.x, 0.5f * h * bang.y, 0.5f * h * bang.z, 0.0f};
            Q4 dqq = quat_mul(dq, bquat);
            Q4 qn = {bquat.x + dqq.x, bquat.y + dqq.y, bquat.z + dqq.z, bquat.w + dqq.w};
            float nrm = sqrtf(qn.x * qn.x + qn.y * qn.y + qn.z * qn.z + qn.w * qn.w) + 1e-9f;
            bquat.x = qn.x / nrm; bquat.y = qn.y / nrm; bquat.z = qn.z / nrm; bquat.w = qn.w / nrm;
        }
    }

    // ---- store state (root pose and targets pass through) ----
    for (int d = 0; d < D; ++d) {
        OUT(R_QPOS + d) = q[d];
        OUT(R_QVEL + d) = qv[d];
        OUT(R_TGT + d) = tgt[d];
    }
    OUT(R_ROOTP) = root_p.x; OUT(R_ROOTP + 1) = root_p.y; OUT(R_ROOTP + 2) = root_p.z;
    OUT(R_ROOTQ) = root_q.x; OUT(R_ROOTQ + 1) = root_q.y; OUT(R_ROOTQ + 2) = root_q.z;
    OUT(R_ROOTQ + 3) = root_q.w;
    OUT(R_BPOS) = bpos.x; OUT(R_BPOS + 1) = bpos.y; OUT(R_BPOS + 2) = bpos.z;
    OUT(R_BQUAT) = bquat.x; OUT(R_BQUAT + 1) = bquat.y; OUT(R_BQUAT + 2) = bquat.z;
    OUT(R_BQUAT + 3) = bquat.w;
    OUT(R_BLIN) = blin.x; OUT(R_BLIN + 1) = blin.y; OUT(R_BLIN + 2) = blin.z;
    OUT(R_BANG) = bang.x; OUT(R_BANG + 1) = bang.y; OUT(R_BANG + 2) = bang.z;
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

// Size of the scene description the wrapper must upload, and of a state row
// set; the wrapper checks both against its own packing.
int fis_spec_bytes() { return (int)sizeof(Spec); }
int fis_state_rows() { return (int)FIS_NF; }
int fis_dims(int which) { return which == 0 ? L : (which == 1 ? D : S); }

// Copy the scene description into constant memory, ordered on `stream`.
int fis_set_spec(const void* host_spec, int bytes, void* stream) {
    if (bytes != (int)sizeof(Spec)) return -1;
    cudaError_t err = cudaMemcpyToSymbolAsync(c_spec, host_spec, sizeof(Spec), 0,
                                              cudaMemcpyHostToDevice, (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

// Launch n_steps inner steps for E envs on `stream`; returns cudaGetLastError().
int fis_launch(const void* in, const void* anc_b_in, void* out, void* anc_b_out,
               int E, int n_steps, void* stream) {
    if (E < 1 || n_steps < 0) return -1;
    int blocks = (E + FIS_BLOCK - 1) / FIS_BLOCK;
    fused_inner_step_kernel<<<blocks, FIS_BLOCK, 0, (cudaStream_t)stream>>>(
        (const float*)in, (const int*)anc_b_in, (float*)out, (int*)anc_b_out, E, n_steps);
    return (int)cudaGetLastError();
}

}  // extern "C"
