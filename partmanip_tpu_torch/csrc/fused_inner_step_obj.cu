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
// pairs have an impulse budget of their own, the best grid per sphere
// (first minimum, partner id 2 + G + k) is considered after the boxes,
// anchors may live in grid frames, and the reactions reach the object
// through the grid-link Jacobians at the grid origin.
//
// Design: one warp per env.  The TPU kernel runs each env serially on one
// lane of an (8, 128) tile (fused.py:744).  Carried over literally, one
// thread per env left 64 warps for 132 SMs at 2048 envs, each thread a
// 37 k-operation dependent chain per inner step with 255 registers and its
// working set spilled to local memory, and every read of the cabinet record
// replayed over up to 16 records in a warp.  Here a warp owns an env and
// its 32 lanes split each phase of the inner step:
//   - forward kinematics of both trees at once, the robot on lanes 0..15,
//     the object on 16..31: lanes over links form each joint's rotation and
//     translation (the sines and cosines), lanes 0 and 16 compose the two
//     chains side by side, lanes over dofs read the world axes;
//   - mass matrix: lanes over links rotate the inertias, lanes over
//     (link, dof) form the Jacobian columns, lanes over the lower-triangle
//     entries sum over links in link order;
//   - lanes over spheres place them (the ground budget counted by ballot),
//     lanes over (sphere, dof) form the sphere Jacobians;
//   - narrowphase pass A: lanes over the (sphere, active box) pairs and, for
//     B1c, the (sphere, active grid) pairs; each writes its masked depth
//     (the depth if the pair touches, else 1e9) and the warp counts the
//     touching pairs by ballot (the impulse budgets are exact integers);
//   - pass B, a lane per sphere: the sphere scans its pairs in box order
//     for the touching mask and the first minimum (strict <, the ground ->
//     boxes -> grids order kept), then computes forces, anchors and its
//     part of the object's reaction as the serial version does; the parts
//     are summed over the lanes by a butterfly of fixed order;
//   - J^T F and J^T N J: lanes over (d, f) entries, each summing over the
//     touching spheres in sphere order;
//   - the two-pass effort-clamped solves of both trees at once, a lane per
//     dof (the object's 4 rows padded to the robot's 12 with identity
//     rows), the Cholesky factor and the substitutions across lanes by
//     shuffles (fused_warp.cuh).
// No float atomics: every sum has one order, so k inner steps in one launch
// equal k launches of one step bit for bit.
//
// The contact geometry (link poses, sphere centres, geom frames, a sphere's
// point in a geom's frame, box distances, the trilinear lookup) is rounded
// as the plain version rounds it on the card (fused_geom.cuh): a contact
// whose depth sits at 0 or whose grid query sits on a cell face (where the
// trilinear gradient jumps) falls on the same side of the test in both.
//
// The working set lives in shared memory, not in spilled registers: the
// robot description (struct Spec, 3.5 KB) once per block of FIS_WARPS envs,
// and per env its cabinet record (ObjSpec, and GridSpec for B1c), copied in
// once per launch, plus struct Work (state, link poses, M, A_c, box poses,
// sphere records, a scratch area reused phase by phase).  About 12 KB per
// env and 52 KB per block of 4 envs, so the runtime keeps 4 blocks (16
// warps) on an SM (fis_occupancy), 528 blocks on 132 SMs, against 512 blocks
// at 2048 envs.  The n_steps loop stays inside the launch with the state
// on chip.
//
// What bounds it on an H100: not device memory (about 150 floats of state
// in and out per env and launch, plus one 2.6 KB cabinet record per env)
// but the latency of one env's chain: the serial parts of each inner step
// (the link chains, the Cholesky factor's columns and the substitutions,
// each a shuffle, an IEEE square root or division and a select) run on few
// lanes, and 16 warps on an SM hide only part of it.  The FIS_PHASES build
// counts each phase's clock cycles (scripts/prof_torch_fused_phases.py).
// B1c adds S x K trilinear queries of 8 loads per inner step from a 30.9 MB
// stack that stays in L2.
//
// Built with FIS_BIAS=1, the right-hand sides of both trees' solves also
// subtract each tree's bias (dynamics.bias_forces: gravity times the tree's
// gscale, the robot's in the Spec and the object's in its ObjSpec record,
// and, when the Spec's coriolis is set, the velocity-product term), each
// computed once per inner step from the state at its start, right after
// that tree's mass matrix (fused_bias.cuh).  The TPU kernel has no such
// build: its fused_supported (partmanip_tpu/sim/fused.py:1189, :1202-1207)
// hands coriolis and gravity to XLA.  The default build (FIS_BIAS=0) is the
// code it was before the bias existed.
//
// Built with FIS_BODY=1 (variant B1e: open_drawer's cabinet, with boxes or,
// with FIS_K > 0, mesh geoms, beside grasp_cube's free cube), the scene
// also holds one free box, as kernel B1a has it: it replaces the same Pallas
// kernel with has_body and has_obj both set (partmanip_tpu/sim/fused.py
// :1234-1235; the cube's branches :793, :934-952, :998-1016, :1066).  Each
// sphere also meets the cube (partner id 1, between the ground and the
// object's geoms, first minimum); its anchor may live in the cube's frame;
// the cube takes the spheres' normal reactions and their friction reactions
// capped to velocity matching (each sphere's share kept by pass B in its row
// of pass A's depths, which pass B has read, so that no register carries it
// through pass B), its corners meet the ground, and it is integrated after
// pass B by the lanes of its warp (B1a's box_step with the warp in place of
// the half-warp).  The cube's fields follow the Spec's
// others, its 13 state rows the object's; Work grows by those rows only
// (the cube's depths are computed again in pass B rather than kept), so the
// bias build still fits four blocks an SM.  The default build (FIS_BODY=0)
// is the code it was before.
//
// Numerics follow the plain version literally (see fused_common.cuh); what
// differs, outside the contact geometry, is fma contraction and the order
// of sums.

#include <cuda_runtime.h>

#include "fused_common.cuh"
#include "fused_geom.cuh"
#include "fused_warp.cuh"

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
// envs (warps) per block; 16 / FIS_WARPS blocks are meant to share an SM
#ifndef FIS_WARPS
#define FIS_WARPS 4
#endif
// 1: a free box beside the object (B1e); 0: the object alone (B1b / B1c)
#ifndef FIS_BODY
#define FIS_BODY 0
#endif
// 1: the solves subtract each tree's bias (gravity, coriolis)
#ifndef FIS_BIAS
#define FIS_BIAS 0
#endif
#if FIS_BIAS
#include "fused_bias.cuh"
#endif

#define L FIS_L
#define D FIS_D
#define S FIS_S
#define LO FIS_LO
#define DO FIS_DO
#define G FIS_G

static_assert(G <= 32, "the touching pairs of a sphere are kept as one 32-bit mask");
static_assert(L <= 32 && LO <= 32 && S <= 32 && D <= 32, "one lane per link, sphere and dof");
#if FIS_BODY
static_assert(G >= 7, "a sphere's cube record (7 floats) lives in its row of the box depths");
#endif
#if FIS_K > 0
#define K FIS_K
#define GX FIS_GX
#define GY FIS_GY
#define GZ FIS_GZ
static_assert(K <= 32, "the touching grid pairs of a sphere are kept as one 32-bit mask");
#endif

// Robot, spheres and contact constants, copied into each block's shared
// memory.  Mirrored field by field by
// partmanip_tpu_torch/sim/fused.py:pack_spec_obj; every member is 4 bytes
// wide, so the struct has no padding.
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
#if FIS_BODY
    float cube_mass;
    float cube_inertia[9];
    float cube_half[3];
    float cube_gscale;
    float cube_mu;
    float cd_cube;            // 2 zeta sqrt(kn * m_cube)
    float cd_corner;          // 2 zeta sqrt(kn * m_cube / 4)
    float coef_cube;          // h cd_cube + h^2 kn
    float hold_vel;
#endif
#if FIS_BIAS
    float gscale;             // the robot's gravity_scale
    float coriolis;           // 1: the velocity-product term too
#endif
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
#if FIS_BIAS
    float gscale;             // the object's gravity_scale
#endif
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
// (ops/sdf.grid_query_grad, same operations, each rounded on its own as
// fused_geom.cuh says).  Outside the interior cells: value 1
// (outside_value) and a zero gradient, without a load.
__device__ __forceinline__ float grid_query_grad(const GridStack& st, int gid, V3 p, V3* grad) {
    const float vs = __ldg(st.voxel + gid);
    const float ix = __fdiv_rn(__fsub_rn(p.x, __ldg(st.bbox + 3 * gid)), vs);
    const float iy = __fdiv_rn(__fsub_rn(p.y, __ldg(st.bbox + 3 * gid + 1)), vs);
    const float iz = __fdiv_rn(__fsub_rn(p.z, __ldg(st.bbox + 3 * gid + 2)), vs);
    const bool valid = ix >= 1.0f && ix <= (float)(GX - 2) && iy >= 1.0f
                    && iy <= (float)(GY - 2) && iz >= 1.0f && iz <= (float)(GZ - 2);
    if (!valid) {
        *grad = v3(0.0f, 0.0f, 0.0f);
        return 1.0f;
    }
    // inside [1, hi] the reference's clip to [0, hi] changes nothing
    const int x0 = (int)ix, y0 = (int)iy, z0 = (int)iz;
    const float fx = __fsub_rn(ix, (float)x0), fy = __fsub_rn(iy, (float)y0);
    const float fz = __fsub_rn(iz, (float)z0);
    const float* c = st.sdf + (size_t)gid * (GX * GY * GZ) + (size_t)x0 * (GY * GZ) + y0 * GZ + z0;
    const float c000 = __ldg(c), c001 = __ldg(c + 1);
    const float c010 = __ldg(c + GZ), c011 = __ldg(c + GZ + 1);
    const float c100 = __ldg(c + GY * GZ), c101 = __ldg(c + GY * GZ + 1);
    const float c110 = __ldg(c + GY * GZ + GZ), c111 = __ldg(c + GY * GZ + GZ + 1);
    const float gx = __fsub_rn(1.0f, fx), gy = __fsub_rn(1.0f, fy), gz = __fsub_rn(1.0f, fz);
    // a * (1 - f) + b * f, each product and the sum rounded
    auto lerp = [](float a, float b, float g, float f) {
        return __fadd_rn(__fmul_rn(a, g), __fmul_rn(b, f));
    };
    const float c00 = lerp(c000, c001, gz, fz);
    const float c01 = lerp(c010, c011, gz, fz);
    const float c10 = lerp(c100, c101, gz, fz);
    const float c11 = lerp(c110, c111, gz, fz);
    const float c0 = lerp(c00, c01, gy, fy);
    const float c1 = lerp(c10, c11, gy, fy);
    const float val = lerp(c0, c1, gx, fx);
    const float dx = __fsub_rn(c1, c0);
    const float dy = lerp(__fsub_rn(c01, c00), __fsub_rn(c11, c10), gx, fx);
    const float dz = lerp(lerp(__fsub_rn(c001, c000), __fsub_rn(c011, c010), gy, fy),
                          lerp(__fsub_rn(c101, c100), __fsub_rn(c111, c110), gy, fy), gx, fx);
    *grad = v3(__fdiv_rn(dx, vs), __fdiv_rn(dy, vs), __fdiv_rn(dz, vs));
    return val;
}
#endif

// The scene's Spec, uploaded once per scene; each block copies it to shared
// memory.
__device__ Spec g_spec;

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
#if FIS_BODY
    R_BPOS = R_ORQ + 4,
    R_BQUAT = R_BPOS + 3,
    R_BLIN = R_BQUAT + 4,
    R_BANG = R_BLIN + 3,
    R_ANCP = R_BANG + 3,
#else
    R_ANCP = R_ORQ + 4,
#endif
    R_TGT = R_ANCP + 3 * S,
    FIS_NF = R_TGT + D
};

__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

constexpr int TRI = D * (D + 1) / 2;        // lower triangle of the robot's D x D
constexpr int TRIO = DO * (DO + 1) / 2;     // and of the object's DO x DO
constexpr int KG = FIS_K > 0 ? FIS_K : 1;   // grid arrays keep one slot in B1b
// The scratch area, reused phase by phase: the link chains' local joint
// transforms (7 (L + LO)); the mass matrix's COMs, inertias and Jacobian columns
// (NL x 12 + NL x ND x 6, robot then object); the sphere Jacobians
// (S x D x 3) beside first the pair depths (S x G + S x K), then N J (S x D
// x 3); the two trees' Cholesky factors (2 x D x D).  The bias build keeps
// each tree's per-link and per-dof terms after its mass matrix's.
#if FIS_BIAS
constexpr int SCRATCH = cmax(cmax(7 * (L + LO), 2 * D * D),
                             cmax(cmax(L * 12 + L * D * 6 + FIS_BIAS_SCRATCH(L, D),
                                       LO * 12 + LO * DO * 6 + FIS_BIAS_SCRATCH(LO, DO)),
                                  S * D * 3 + cmax(S * G + S * KG, S * D * 3)));
#else
constexpr int SCRATCH = cmax(cmax(7 * (L + LO), 2 * D * D),
                             cmax(cmax(L * 12 + L * D * 6, LO * 12 + LO * DO * 6),
                                  S * D * 3 + cmax(S * G + S * KG, S * D * 3)));
#endif

// One env's working set in shared memory (a warp's).  4-byte members only;
// tests/test_torch_fused_warp.py reads the layout out of this source.
struct Work {
    float st[R_ANCP];         // state rows R_QPOS .. R_ORQ + 3 (B1e: .. R_BANG + 2)
    float tgt[D];
    float lp[L][3];           // robot link poses
    float lq[L][4];
    float axw[D][3];          // per-dof world axes and anchors
    float anw[D][3];
    float rev[D];
    float pris[D];
    float M[TRI];
    float Ac[TRI];
    float tau[D];
    float olp[LO][3];         // object link poses
    float olq[LO][4];
    float oaxw[DO][3];
    float oanw[DO][3];
    float orev[DO];
    float opris[DO];
    float Mo[TRIO];
    float Ao[TRIO];
    float tau_o[DO];
    float bp[G][3];           // world box poses
    float bq[G][4];
    float gp[KG][3];          // world grid-geom frames (B1c)
    float gq[KG][4];
    int gact[G];              // the env's active boxes, ascending
    int kact[KG];             // its active grid geoms, ascending
    float cen[S][3];          // sphere centres
    float F[S][3];            // per-sphere force and normal operator
    float N[S][9];
    int act[S];               // the sphere touches a partner this step
    float scratch[SCRATCH];
#if FIS_BIAS
    float bias[D];            // the trees' biases of this inner step
    float obias[DO];
#endif
};

constexpr int SPEC_WORDS = (int)(sizeof(Spec) / 4);
constexpr int OBJ_WORDS = (int)(sizeof(ObjSpec) / 4);
constexpr int WORK_WORDS = (int)(sizeof(Work) / 4);
#if FIS_K > 0
constexpr int GRID_WORDS = (int)(sizeof(GridSpec) / 4);
#else
constexpr int GRID_WORDS = 0;
#endif
constexpr int FIS_THREADS = 32 * FIS_WARPS;
// dynamic shared memory of a block: [Spec][Work x W][ObjSpec x W][GridSpec x W]
constexpr int SMEM_BYTES = 4 * (SPEC_WORDS + FIS_WARPS * (WORK_WORDS + OBJ_WORDS + GRID_WORDS));
static_assert(SMEM_BYTES <= 232448, "a block's shared memory exceeds the H100's 227 KB");

// The phases the FIS_PHASES build times (fused_phases.cuh).
#define FIS_NPHASE 8
#include "fused_phases.cuh"

// Linear Jacobian column of dof d for a world point attached to a link with
// ancestor flag a (kinematics._columns).
__device__ __forceinline__ V3 jac_col(float a, int d, V3 point, const float (*axw)[3],
                                      const float (*anw)[3], const float* rev,
                                      const float* pris) {
    const V3 ax = ld3(axw[d]);
    V3 col = cross(ax, point - ld3(anw[d])) * rev[d] + ax * pris[d];
    return col * a;
}

// ---------------------------------------------------------------------------
// Tree phases, shared by the robot (T = Spec) and the object (T = ObjSpec):
// both name their tree fields alike.  Every lane of the warp calls each one.
// ---------------------------------------------------------------------------

// Forward kinematics of both trees at once (kinematics.forward_kinematics):
// link poses, per-dof world axes and anchors, revolute / prismatic
// indicators; the robot on lanes 0..15, the object on lanes 16..31.  Lanes
// over links form each joint's local rotation and translation (the sines
// and cosines), lanes 0 and 16 compose the two chains side by side, lanes
// over dofs read the world axes.  Uses 7 (L + LO) scratch floats.
__device__ __forceinline__ void trees_fk(const Spec& sp, const ObjSpec& os, Work& w, int lane) {
    static_assert(L <= 16 && LO <= 16 && D <= 16 && DO <= 16, "a half-warp per tree");
    const bool obj = lane >= 16;
    const int l = lane & 15, nl = obj ? LO : L, nd = obj ? DO : D;
    float* jl = w.scratch + (obj ? 7 * L : 0);
    const float* q = w.st + (obj ? R_OQ : R_QPOS);
    const int* parent = obj ? os.parent : sp.parent;
    const int* joint_type = obj ? os.joint_type : sp.joint_type;
    const float (*axis)[3] = obj ? os.axis : sp.axis;
    float (*lp)[3] = obj ? w.olp : w.lp;
    float (*lq)[4] = obj ? w.olq : w.lq;
    if (l >= 1 && l < nl) {                   // the joint of link l
        const float ql = q[obj ? os.dof_idx[l] : sp.dof_idx[l]];
        const float is_rev = joint_type[l] == 1 ? 1.0f : 0.0f;
        const float is_pris = joint_type[l] == 2 ? 1.0f : 0.0f;
        const V3 ax = ld3(axis[l]);
        const float half_ang = __fmul_rn(0.5f, __fmul_rn(ql, is_rev));
        const float sn = sinf(half_ang), cs = cosf(half_ang);
        const V3 axs = mul_r(ax, sn);
        const Q4 jq = {axs.x, axs.y, axs.z, cs};
        st4(jl + 7 * l, jq);
        st3(jl + 7 * l + 4, mul_r(ax, __fmul_rn(ql, is_pris)));
    }
    __syncwarp();
    if (l == 0) {                             // the chains, root first
        const float (*origin_pos)[3] = obj ? os.origin_pos : sp.origin_pos;
        const float (*origin_quat)[4] = obj ? os.origin_quat : sp.origin_quat;
        const float* root = w.st + (obj ? R_ORP : R_ROOTP);
        const V3 root_p = ld3(root);
        const Q4 root_q = ld4(root + 3);
        V3 p;
        Q4 r;
        compose_t(root_p, root_q, ld3(origin_pos[0]), ld4(origin_quat[0]), &p, &r);
        st3(lp[0], p);
        st4(lq[0], r);
#pragma unroll 1
        for (int k = 1; k < nl; ++k) {
            const int pi = parent[k] > 0 ? parent[k] : 0;
            // a chain link's parent is the link before: kept in registers
            const Q4 pq = pi == k - 1 ? r : ld4(lq[pi]);
            const V3 pp = pi == k - 1 ? p : ld3(lp[pi]);
            V3 jp;
            Q4 jqw;
            compose_t(pp, pq, ld3(origin_pos[k]), ld4(origin_quat[k]), &jp, &jqw);
            p = add_r(jp, quat_rotate_t(jqw, ld3(jl + 7 * k + 4)));
            r = quat_mul_t(jqw, ld4(jl + 7 * k));
            st3(lp[k], p);
            st4(lq[k], r);
        }
    }
    __syncwarp();
    if (l < nd) {
        const int c = obj ? os.dof_child[l] : sp.dof_child[l];
        const float mask = obj ? os.dof_mask[l] : sp.dof_mask[l];
        st3(obj ? w.oaxw[l] : w.axw[l], quat_rotate_t(ld4(lq[c]), ld3(axis[c])));
        st3(obj ? w.oanw[l] : w.anw[l], ld3(lp[c]));
        const int kind = joint_type[c];
        (obj ? w.orev : w.rev)[l] = (kind == 1 ? 1.0f : 0.0f) * mask;
        (obj ? w.opris : w.pris)[l] = (kind == 2 ? 1.0f : 0.0f) * mask;
    }
    __syncwarp();
}

// Joint-space inertia, row-major lower triangle Mt (dynamics.mass_matrix).
// scratch: NL x 12 + NL x ND x 6 floats.
template <int NL, int ND, class T>
__device__ __forceinline__ void tree_mass(const T& t, const float (*lp)[3], const float (*lq)[4],
                                          const float (*axw)[3], const float (*anw)[3],
                                          const float* rev, const float* pris, float* Mt,
                                          float* scratch, int lane) {
    float* com_w = scratch;                   // [NL][3]
    float* Iw = com_w + NL * 3;               // [NL][9]
    float* jv = Iw + NL * 9;                  // [NL][ND][3]
    float* Ijw = jv + NL * ND * 3;            // [NL][ND][3]
    if (lane < NL) {
        const int l = lane;
        const Q4 q = ld4(lq[l]);
        st3(com_w + 3 * l, ld3(lp[l]) + quat_rotate(q, ld3(t.com[l])));
        float R[9], I[9], Il[9];
#pragma unroll
        for (int k = 0; k < 9; ++k) I[k] = t.inertia[l][k];
        quat_to_mat(q, R);
        rotate_inertia(R, I, Il);
#pragma unroll
        for (int k = 0; k < 9; ++k) Iw[9 * l + k] = Il[k];
    }
    __syncwarp();
    for (int i = lane; i < NL * ND; i += 32) {
        const int l = i / ND, d = i - l * ND;
        const float a = t.ancestor[l][d];
        st3(jv + 3 * i, jac_col(a, d, ld3(com_w + 3 * l), axw, anw, rev, pris));
        st3(Ijw + 3 * i, matvec(Iw + 9 * l, ld3(axw[d]) * (rev[d] * a)));
    }
    __syncwarp();
    // lane t sums entries t, t + 32, ... side by side, each over the links
    // in link order
    constexpr int NT = ND * (ND + 1) / 2, PER = (NT + 31) / 32;
    int dd[PER], ff[PER];
    float m[PER];
#pragma unroll
    for (int k = 0; k < PER; ++k) {
        const int i = lane + 32 * k < NT ? lane + 32 * k : NT - 1;
        dd[k] = tri_row(i);
        ff[k] = i - dd[k] * (dd[k] + 1) / 2;
        m[k] = 0.0f;
    }
    for (int l = 0; l < NL; ++l) {
        const float ml = t.mass[l];
#pragma unroll
        for (int k = 0; k < PER; ++k) {
            const int d = dd[k], f = ff[k];
            const float ad = t.ancestor[l][d];
            const V3 jwd = ld3(axw[d]) * (rev[d] * ad);
            const float term = ml * dot(ld3(jv + 3 * (l * ND + d)), ld3(jv + 3 * (l * ND + f)))
                             + dot(jwd, ld3(Ijw + 3 * (l * ND + f)));
            // a link off the entry's dofs adds an exact +0 (the sum starts
            // at +0 and never turns -0): the serial sum's bits, no branch
            m[k] += ad != 0.0f && t.ancestor[l][f] != 0.0f ? term : 0.0f;
        }
    }
#pragma unroll
    for (int k = 0; k < PER; ++k) {
        const int d = dd[k];
        if (d == ff[k]) m[k] += t.armature[d] * t.dof_mask[d] + (1.0f - t.dof_mask[d]);
        if (lane + 32 * k < NT) Mt[lane + 32 * k] = m[k];
    }
    __syncwarp();
}

// Two-pass effort-clamped implicit PD step (dynamics.step_tree) of both
// trees at once, a lane per dof: (M + h D + h^2 K + Ac) qacc = tau_drive +
// tau_fric + tau_ext (- the tree's bias in the FIS_BIAS build), then the clipped velocity / position update with
// joint limits.  The robot's D rows lie on lanes 0..15, the object's DO rows
// on lanes 16..31, padded to D rows with identity rows and a zero right-hand
// side: rows and columns after the real ones change none of the 4 x 4
// solve's operations (their factor entries and solutions are exact zeros),
// so the object gets what a solve of its own would give.  The object is
// undriven: its target is its own qpos.  Updates q, qv and the object's in
// place; Lsh: 2 x D x D scratch floats (the two systems).
__device__ __forceinline__ void tree_steps(const Spec& sp, const ObjSpec& os, Work& w, float* Lsh,
                                           int lane) {
    static_assert(D <= 16 && DO <= D, "a half-warp per tree, the object padded to D rows");
    const float h = sp.h;
    const bool obj = lane >= 16;
    const int hl = lane & 15;
    const int nd = obj ? DO : D;
    const bool real = hl < nd;
    const int d = real ? hl : nd - 1;         // padding lanes read a real dof, then drop it
    float* q = w.st + (obj ? R_OQ : R_QPOS);
    float* qv = w.st + (obj ? R_OV : R_QVEL);
    const float* Mt = obj ? w.Mo : w.M;
    const float* Act = obj ? w.Ao : w.Ac;
    const float qd = q[d], qvd = qv[d];
    const float tg = obj ? q[d] : w.tgt[d];
#if FIS_BIAS
    const float te = obj ? w.tau_o[d] - w.obias[d] : w.tau[d] - w.bias[d];
#else
    const float te = obj ? w.tau_o[d] : w.tau[d];
#endif
#define DOF(field) (obj ? os.field[d] : sp.field[d])
    const float kp = DOF(kp), kd = DOF(kd), mask = DOF(dof_mask), effort = DOF(effort);
    const float fric = DOF(friction), damping = DOF(damping), vel_limit = DOF(vel_limit);
    const float lower = DOF(lower), upper = DOF(upper);
#undef DOF
    const float Mdd = Mt[d * (d + 1) / 2 + d];
    const float tau_d0 = kp * (tg - qd - h * qvd) - kd * qvd;
    const float tau_fric = -fric * clampf(div_pos(qvd, sp.friction_veps), -1.0f, 1.0f);
    const float d_fric = div_pos(fric, sp.friction_veps)
                       * (fabsf(qvd) < sp.friction_veps ? 1.0f : 0.0f);
    float* Lh = Lsh + (obj ? D * D : 0);
    float row[D];
    // pass 1: fully implicit, no effort limit
    system_row<D>(row, hl, Mt, Act, d, (h * (kd + 0.0f + damping + d_fric) + (h * h) * kp) * mask,
                  real);
    float qacc = spd_solve_warp<D>(row, real ? (tau_d0 + tau_fric + te) * mask : 0.0f, Lh, hl,
                                   lane & 16);
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
        system_row<D>(row, hl, Mt, Act, d, diag * mask, real);
        qacc = spd_solve_warp<D>(row, real ? (tau_drive + tau_fric + te) * mask : 0.0f, Lh, hl,
                                 lane & 16);
    }
    const float qa = qacc * mask;
    const float v_new = clampf(qvd + h * qa, -vel_limit, vel_limit);
    const float q_new = qd + h * v_new;
    const bool at_lo = (q_new < lower) && (v_new < 0.0f);
    const bool at_hi = (q_new > upper) && (v_new > 0.0f);
    const float vel_new = ((at_lo || at_hi) ? 0.0f : v_new) * mask;
    const float pos_new = clampf(q_new, lower, upper) * mask;
    __syncwarp();
    if (real) {
        q[d] = pos_new;
        qv[d] = vel_new;
    }
    __syncwarp();
}

// Linear and angular Jacobian columns of the object at the centre bp of a
// geom on link li (engine: frame Jacobian at the link origin, shifted to the
// geom centre by Jw x r).
__device__ __forceinline__ void obj_jacobian(const ObjSpec& os, const Work& w, int li, V3 bp,
                                             V3* jv, V3* jw) {
    const V3 olp = ld3(w.olp[li]);
    const V3 r_box = bp - olp;
#pragma unroll
    for (int d = 0; d < DO; ++d) {
        const float a = os.ancestor[li][d];
        const V3 jv_link = jac_col(a, d, olp, w.oaxw, w.oanw, w.orev, w.opris);
        jw[d] = ld3(w.oaxw[d]) * (w.orev[d] * a);
        jv[d] = jv_link + cross(jw[d], r_box);
    }
}

// One touching (sphere, object geom) pair of pass B: its penalty force on
// the sphere, its part of the sphere's normal operator N, and the reaction
// wrench (-f, -(rel x f)) about the geom centre through the geom Jacobian
// into the sphere's share of the object's tau and A_c.
__device__ __forceinline__ V3 obj_pair_force(const Spec& sp, const ObjSpec& os, const Work& w,
                                             int li, V3 gpos, V3 rel, V3 n, float depth, V3 v,
                                             float mu, float n_act, float* N, float* to,
                                             float* ao, V3* vo_out, float* fn_out) {
    V3 jv[DO], jw[DO];
    obj_jacobian(os, w, li, gpos, jv, jw);
    V3 vc = v3(0.0f, 0.0f, 0.0f), wc = v3(0.0f, 0.0f, 0.0f);
    const float* ov = w.st + R_OV;
#pragma unroll
    for (int d = 0; d < DO; ++d) {
        vc = vc + jv[d] * ov[d];
        wc = wc + jw[d] * ov[d];
    }
    const V3 vo = vc + cross(wc, rel);
    const V3 f = penalty_force(depth, n, v - vo, mu, 0.3f, sp.cd_obj, n_act, 0.0f, sp.h, sp.kn,
                               sp.kt, sp.max_depen, fn_out);
    const float nn[3] = {n.x, n.y, n.z};
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int b = 0; b < 3; ++b) N[a * 3 + b] += sp.coef_obj * nn[a] * nn[b];
    const V3 tf = cross(rel, f);
    float jn[DO];
#pragma unroll
    for (int d = 0; d < DO; ++d) {
        to[d] -= dot(jv[d], f) + dot(jw[d], tf);
        jn[d] = dot(jv[d], n);
    }
#pragma unroll
    for (int d = 0; d < DO; ++d)
#pragma unroll
        for (int f2 = 0; f2 <= d; ++f2) ao[d * (d + 1) / 2 + f2] += sp.coef_obj * jn[d] * jn[f2];
    *vo_out = vo;
    return f;
}

// The friction reaction -ft at c on the object through the Jacobian of the
// selected geom (on link li, centre gpos): no velocity cap, the cabinet is
// an articulation, not a free body.
__device__ __forceinline__ void obj_friction_reaction(const ObjSpec& os, const Work& w, int li,
                                                      V3 gpos, V3 c, V3 ft, float* to) {
    V3 jv[DO], jw[DO];
    obj_jacobian(os, w, li, gpos, jv, jw);
    const V3 tf = cross(c - gpos, ft);
#pragma unroll
    for (int d = 0; d < DO; ++d) to[d] -= dot(jv[d], ft) + dot(jw[d], tf);
}

#if FIS_BODY
// component a (0, 1, 2) of v, by selects (no indexing into local memory)
__device__ __forceinline__ float comp(V3 v, int a) { return a == 0 ? v.x : (a == 1 ? v.y : v.z); }

// The cube's depth below sphere s (negative: touching) and its outward
// normal in the cube's frame (contact.spheres_vs_boxes), from the state at
// the start of the inner step.
__device__ __forceinline__ float cube_depth(const Spec& sp, const Work& w, int s, V3 c,
                                            V3* n_local) {
    return __fsub_rn(box_sdf_t(quat_rotate_inv_t(ld4(w.st + R_BQUAT), sub_r(c, ld3(w.st + R_BPOS))),
                               ld3(sp.cube_half), n_local),
                     sp.sph_radius[s]);
}

// The free box (engine._inner_step's corner contacts and delta-v cap, then
// contact.integrate_free_body), B1a's box_step over the env's warp: lanes
// over the 8 corners against the ground; the corners' force and torque and
// this lane's part of the spheres' reaction (f, t) summed over the warp;
// then a lane per axis integrates its velocities and position (its row of
// the cofactor inverse) and a lane per component the quaternion, into the
// state rows.
__device__ __forceinline__ void body_step(const Spec& sp, Work& w, int lane, V3 f, V3 t) {
    const float h = sp.h;
    const V3 bpos = ld3(w.st + R_BPOS), blin = ld3(w.st + R_BLIN), bang = ld3(w.st + R_BANG);
    const Q4 bquat = ld4(w.st + R_BQUAT);
    const V3 half = ld3(sp.cube_half);
    V3 cw = v3(0.0f, 0.0f, 0.0f);
    if (lane < 8)
        cw = add_r(bpos, quat_rotate_t(bquat, v3((lane & 4) ? half.x : -half.x,
                                                 (lane & 2) ? half.y : -half.y,
                                                 (lane & 1) ? half.z : -half.z)));
    const bool on_ground = lane < 8 && cw.z < 0.0f;
    const float n_act_c = fmaxf(1.0f, (float)warp_count(on_ground));
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
    f = v3(warp_sum(f.x), warp_sum(f.y), warp_sum(f.z));
    t = v3(warp_sum(t.x), warp_sum(t.y), warp_sum(t.z));
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
    const int ax = lane < 3 ? lane : 0;
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
    const V3 wn = v3(__shfl_sync(FIS_FULL_MASK, ang, 0), __shfl_sync(FIS_FULL_MASK, ang, 1),
                     __shfl_sync(FIS_FULL_MASK, ang, 2));
    const Q4 dq = {0.5f * h * wn.x, 0.5f * h * wn.y, 0.5f * h * wn.z, 0.0f};
    const Q4 dqq = quat_mul(dq, bquat);
    const Q4 qn = {bquat.x + dqq.x, bquat.y + dqq.y, bquat.z + dqq.z, bquat.w + dqq.w};
    const float nrm = sqrtf(qn.x * qn.x + qn.y * qn.y + qn.z * qn.z + qn.w * qn.w) + 1e-9f;
    const int k = lane < 4 ? lane : 0;
    const float qk = div_pos(k == 0 ? qn.x : (k == 1 ? qn.y : (k == 2 ? qn.z : qn.w)), nrm);
    __syncwarp();                             // every lane has read the old rows
    if (lane < 3) {
        w.st[R_BPOS + ax] = pos;
        w.st[R_BLIN + ax] = lin;
        w.st[R_BANG + ax] = ang;
    }
    if (lane < 4) w.st[R_BQUAT + k] = qk;
    __syncwarp();
}
#endif

__global__ void __launch_bounds__(FIS_THREADS, 16 / FIS_WARPS)
fused_inner_step_obj_kernel(const float* __restrict__ in, const int* __restrict__ anc_b_in,
                            float* __restrict__ out, int* __restrict__ anc_b_out,
                            const ObjSpec* __restrict__ obj_table,
#if FIS_K > 0
                            const GridSpec* __restrict__ grid_table, GridStack stack,
#endif
                            const int* __restrict__ obj_id, int E, int n_steps) {
    extern __shared__ float smem[];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int e = blockIdx.x * FIS_WARPS + warp;
    Spec& sp = *reinterpret_cast<Spec*>(smem);
    Work& w = reinterpret_cast<Work*>(smem + SPEC_WORDS)[warp];
    ObjSpec& os = reinterpret_cast<ObjSpec*>(smem + SPEC_WORDS + FIS_WARPS * WORK_WORDS)[warp];
#if FIS_K > 0
    GridSpec& gr = reinterpret_cast<GridSpec*>(
        smem + SPEC_WORDS + FIS_WARPS * (WORK_WORDS + OBJ_WORDS))[warp];
    const int KOFF = 2 + G;          // partner ids of the grid geoms start here
#endif
    // ---- the block's Spec, each env's cabinet records ----
    for (int i = threadIdx.x; i < SPEC_WORDS; i += FIS_THREADS)
        smem[i] = reinterpret_cast<const float*>(&g_spec)[i];
    if (e < E) {
        const int oid = obj_id[e];
        const float* src = reinterpret_cast<const float*>(obj_table + oid);
        float* dst = reinterpret_cast<float*>(&os);
        for (int i = lane; i < OBJ_WORDS; i += 32) dst[i] = src[i];
#if FIS_K > 0
        const float* gsrc = reinterpret_cast<const float*>(grid_table + oid);
        float* gdst = reinterpret_cast<float*>(&gr);
        for (int i = lane; i < GRID_WORDS; i += 32) gdst[i] = gsrc[i];
#endif
    }
    __syncthreads();
    if (e >= E) return;

    // ---- load state ----
    for (int r = lane; r < R_ANCP; r += 32) w.st[r] = in[(size_t)r * E + e];
    for (int d = lane; d < D; d += 32) w.tgt[d] = in[(size_t)(R_TGT + d) * E + e];
    const float* qv = w.st + R_QVEL;
    // lane s < S holds sphere s's anchor
    V3 anc_p = v3(0.0f, 0.0f, 0.0f);
    int anc_b = -1;
    if (lane < S) {
        const int r = R_ANCP + 3 * lane;
        anc_p = v3(in[(size_t)r * E + e], in[(size_t)(r + 1) * E + e], in[(size_t)(r + 2) * E + e]);
        anc_b = anc_b_in[(size_t)lane * E + e];
    }
    // the active boxes (and grid geoms) of the env, ascending
    const unsigned bmask = __ballot_sync(FIS_FULL_MASK, lane < G && os.b_mask[lane] != 0.0f);
    const int nb = __popc(bmask);
    if (lane < G && ((bmask >> lane) & 1u)) w.gact[__popc(bmask & ((1u << lane) - 1u))] = lane;
#if FIS_K > 0
    const unsigned gkmask = __ballot_sync(FIS_FULL_MASK, lane < K && gr.g_mask[lane] != 0.0f);
    const int nk = __popc(gkmask);
    if (lane < K && ((gkmask >> lane) & 1u)) w.kact[__popc(gkmask & ((1u << lane) - 1u))] = lane;
#endif
    __syncwarp();

    float* jp = w.scratch;                    // [S][D][3] sphere Jacobians
    float* dsg = jp + S * D * 3;              // [S][G] masked (sphere, box) depths
    float* Njp = dsg;                         // [S][D][3] N J, after pass B
#if FIS_K > 0
    float* dsk = dsg + S * G;                 // [S][K] masked (sphere, grid) depths
#endif

    PHASES_BEGIN
    for (int step = 0; step < n_steps; ++step) {
        // ---- both trees: kinematics and inertia ----
        trees_fk(sp, os, w, lane);
        PHASE(0)
        tree_mass<L, D>(sp, w.lp, w.lq, w.axw, w.anw, w.rev, w.pris, w.M, w.scratch, lane);
#if FIS_BIAS
        // from tree_mass's COMs, inertias and Jacobian columns in scratch
        tree_bias<L, D>(sp, w.lp, w.axw, w.anw, w.rev, w.pris, w.st + R_QVEL, w.scratch,
                        w.scratch + L * 3, w.scratch + L * 12, w.scratch + L * 12 + L * D * 6,
                        w.bias, sp.gravity, sp.gscale, sp.coriolis != 0.0f, lane);
#endif
        PHASE(1)
        tree_mass<LO, DO>(os, w.olp, w.olq, w.oaxw, w.oanw, w.orev, w.opris, w.Mo, w.scratch,
                          lane);
#if FIS_BIAS
        tree_bias<LO, DO>(os, w.olp, w.oaxw, w.oanw, w.orev, w.opris, w.st + R_OV, w.scratch,
                          w.scratch + LO * 3, w.scratch + LO * 12,
                          w.scratch + LO * 12 + LO * DO * 6, w.obias, sp.gravity, os.gscale,
                          sp.coriolis != 0.0f, lane);
#endif
        PHASE(2)

        // ---- world box (and grid) poses; sphere centres, ground budget ----
        if (lane < G) {
            const int li = os.b_link[lane];
            V3 bp;
            Q4 bq;
            compose_t(ld3(w.olp[li]), ld4(w.olq[li]), ld3(os.b_pos[lane]), ld4(os.b_quat[lane]),
                      &bp, &bq);
            st3(w.bp[lane], bp);
            st4(w.bq[lane], bq);
        }
#if FIS_K > 0
        if (lane < K) {
            const int li = gr.g_link[lane];
            V3 gp;
            Q4 gq;
            compose_t(ld3(w.olp[li]), ld4(w.olq[li]), ld3(gr.g_pos[lane]), ld4(gr.g_quat[lane]),
                      &gp, &gq);
            st3(w.gp[lane], gp);
            st4(w.gq[lane], gq);
        }
#endif
        bool on_ground = false;
#if FIS_BODY
        bool on_cube = false;
#endif
        if (lane < S) {
            const int li = sp.sph_link[lane];
            const V3 c = add_r(ld3(w.lp[li]), quat_rotate_t(ld4(w.lq[li]), ld3(sp.sph_off[lane])));
            st3(w.cen[lane], c);
            on_ground = (c.z - sp.sph_radius[lane]) < 0.0f;
#if FIS_BODY
            V3 n_unused;
            on_cube = cube_depth(sp, w, lane, c, &n_unused) < 0.0f;
#endif
        }
        const float n_act_g = fmaxf(1.0f, (float)warp_count(on_ground));
#if FIS_BODY
        const float n_act_b = fmaxf(1.0f, (float)warp_count(on_cube));
#endif
        __syncwarp();
        PHASE(3)

        // ---- sphere Jacobians, lanes over (sphere, dof) ----
        for (int i = lane; i < S * D; i += 32) {
            const int s = i / D, d = i - s * D;
            st3(jp + 3 * i, jac_col(sp.ancestor[sp.sph_link[s]][d], d, ld3(w.cen[s]), w.axw,
                                    w.anw, w.rev, w.pris));
        }

        // ---- narrowphase, pass A: lanes over (sphere, active box) pairs;
        // the budget counts the touching pairs of the whole env
        int n_touch = 0;
        for (int base = 0; base < S * nb; base += 32) {
            const int p = base + lane;
            bool touch = false;
            if (p < S * nb) {
                const int s = p / nb, j = p - s * nb, g = w.gact[j];
                V3 n_local;
                const float depth = __fsub_rn(
                    box_sdf_t(quat_rotate_inv_t(ld4(w.bq[g]), sub_r(ld3(w.cen[s]), ld3(w.bp[g]))),
                              ld3(os.b_half[g]), &n_local), sp.sph_radius[s]);
                touch = depth < 0.0f;
                dsg[s * G + j] = touch ? depth : 1e9f;
            }
            n_touch += warp_count(touch);
        }
        const float n_act_o = fmaxf(1.0f, (float)n_touch);
#if FIS_K > 0
        // the same for the grid geoms: touching = depth < 0 and an active
        // pair (gradient norm > 1e-6); a budget of their own
        n_touch = 0;
        for (int base = 0; base < S * nk; base += 32) {
            const int p = base + lane;
            bool touch = false;
            if (p < S * nk) {
                const int s = p / nk, j = p - s * nk, k = w.kact[j];
                V3 grad;
                const float val = grid_query_grad(
                    stack, gr.g_gid[k],
                    quat_rotate_inv_t(ld4(w.gq[k]), sub_r(ld3(w.cen[s]), ld3(w.gp[k]))), &grad);
                const float depth = __fsub_rn(val, sp.sph_radius[s]);
                touch = norm_t(grad) > 1e-6f && depth < 0.0f;
                dsk[s * K + j] = touch ? depth : 1e9f;
            }
            n_touch += warp_count(touch);
        }
        const float n_act_k = fmaxf(1.0f, (float)n_touch);
#endif
        __syncwarp();
        PHASE(4)

        // ---- pass B, a lane per sphere: partner, forces, anchor, and the
        // sphere's part of the object's reaction
        float to[DO], ao[TRIO];
#pragma unroll
        for (int d = 0; d < DO; ++d) to[d] = 0.0f;
#pragma unroll
        for (int i = 0; i < TRIO; ++i) ao[i] = 0.0f;
        if (lane < S) {
            const int s = lane;
            const int li = sp.sph_link[s];
            const V3 c = ld3(w.cen[s]);
            V3 v = v3(0.0f, 0.0f, 0.0f);
            for (int d = 0; d < D; ++d) {
                if (sp.ancestor[li][d] == 0.0f) continue;
                v = v + ld3(jp + 3 * (s * D + d)) * qv[d];
            }
            const float r = sp.sph_radius[s];
            const float dg = c.z - r;
#if FIS_BODY
            V3 nb_local;
            const float db = cube_depth(sp, w, s, c, &nb_local);
#endif
            // the touching boxes and the best (first deepest) one, in box order
            unsigned tmask = 0u;
            float best_bd = 1e9f;
            int best_g = -1;
            for (int j = 0; j < nb; ++j) {
                const float dd = dsg[s * G + j];
                if (dd < 0.0f) {
                    const int g = w.gact[j];
                    tmask |= 1u << g;
                    if (dd < best_bd) {
                        best_bd = dd;
                        best_g = g;
                    }
                }
            }
#if FIS_K > 0
            unsigned kmask = 0u;
            float best_kd = 1e9f;
            int best_k = -1;
            for (int j = 0; j < nk; ++j) {
                const float dd = dsk[s * K + j];
                if (dd < 0.0f) {
                    const int k = w.kact[j];
                    kmask |= 1u << k;
                    if (dd < best_kd) {
                        best_kd = dd;
                        best_k = k;
                    }
                }
            }
#endif
            // partner choice in the order ground (0), cube (1, B1e), boxes
            // (2 + g), grids (2 + G + k): a later partner wins only with a
            // strictly smaller depth
            int id = -1;
            float bd = 1e9f;
            if (dg < 0.0f && dg < bd) { id = 0; bd = dg; }
#if FIS_BODY
            if (db < 0.0f && db < bd) { id = 1; bd = db; }
#endif
            if (best_g >= 0 && best_bd < bd) { id = 2 + best_g; bd = best_bd; }
#if FIS_K > 0
            if (best_k >= 0 && best_kd < bd) { id = KOFF + best_k; bd = best_kd; }
#endif
            V3 F = v3(0.0f, 0.0f, 0.0f);
            float N[9];
#pragma unroll
            for (int k = 0; k < 9; ++k) N[k] = 0.0f;
#if FIS_BODY
            // the sphere's cube record, in its row of pass A's depths (read
            // above): [0, 3) the cube's normal force on the sphere, [3, 6)
            // the friction force and [6] |v_t| when the cube is the
            // selected partner (else -1)
            float* rec = dsg + s * G;
            st3(rec, v3(0.0f, 0.0f, 0.0f));
            rec[6] = -1.0f;
#endif
            if (id < 0) {          // touches nothing: no force, anchor released
                anc_b = -1;
            } else {
                float fn_g = 0.0f;
                const float mu_g = 0.5f * (sp.sph_mu[s] + sp.ground_mu);
                if (dg < 0.0f) {
                    F = F + penalty_force(dg, v3(0.0f, 0.0f, 1.0f), v, mu_g, 0.5f, sp.cd_ground,
                                          n_act_g, 0.0f, sp.h, sp.kn, sp.kt, sp.max_depen, &fn_g);
                    N[8] += sp.coef_ground;
                }
                V3 sel_n = v3(0.0f, 0.0f, 1.0f), sel_vo = v3(0.0f, 0.0f, 0.0f);
                float sel_fn = 0.0f, sel_mu = 0.0f;
#if FIS_BODY
                // the cube: its penalty force (kept in the record) and its
                // part of N
                const V3 rc = c - ld3(w.st + R_BPOS);
                const V3 v_box = ld3(w.st + R_BLIN) + cross(ld3(w.st + R_BANG), rc);
                if (db < 0.0f) {
                    const V3 nb = quat_rotate_t(ld4(w.st + R_BQUAT), nb_local);
                    const float mu_b = 0.5f * (sp.sph_mu[s] + sp.cube_mu);
                    float fn_b;
                    const V3 fb = penalty_force(db, nb, v - v_box, mu_b, sp.cube_mass, sp.cd_cube,
                                                n_act_b, 1.0f, sp.h, sp.kn, sp.kt, sp.max_depen,
                                                &fn_b);
                    F = F + fb;
                    const float nn[3] = {nb.x, nb.y, nb.z};
#pragma unroll
                    for (int a = 0; a < 3; ++a)
#pragma unroll
                        for (int b = 0; b < 3; ++b) N[a * 3 + b] += sp.coef_cube * nn[a] * nn[b];
                    st3(rec, fb);
                    if (id == 1) {
                        sel_n = nb;
                        sel_fn = fn_b;
                        sel_mu = mu_b;
                        sel_vo = v_box;
                    }
                }
#endif
                // the touching boxes, in box order
                for (unsigned m = tmask; m != 0u; m &= m - 1u) {
                    const int g = __ffs(m) - 1;
                    const V3 bp = ld3(w.bp[g]);
                    const Q4 bq = ld4(w.bq[g]);
                    const V3 rel = sub_r(c, bp);
                    V3 n_local;
                    const float depth = __fsub_rn(
                        box_sdf_t(quat_rotate_inv_t(bq, rel), ld3(os.b_half[g]), &n_local), r);
                    const V3 n = quat_rotate_t(bq, n_local);
                    const float mu_o = 0.5f * (sp.sph_mu[s] + os.b_mu[g]);
                    float fn;
                    V3 vo;
                    F = F + obj_pair_force(sp, os, w, os.b_link[g], bp, rel, n, depth, v, mu_o,
                                           n_act_o, N, to, ao, &vo, &fn);
                    if (id == 2 + g) {
                        sel_n = n;
                        sel_fn = fn;
                        sel_mu = mu_o;
                        sel_vo = vo;
                    }
                }
#if FIS_K > 0
                // the touching grid geoms, in geom order
                for (unsigned m = kmask; m != 0u; m &= m - 1u) {
                    const int k = __ffs(m) - 1;
                    const V3 gp = ld3(w.gp[k]);
                    const Q4 gq = ld4(w.gq[k]);
                    const V3 rel = sub_r(c, gp);
                    V3 grad;
                    const float depth = __fsub_rn(
                        grid_query_grad(stack, gr.g_gid[k], quat_rotate_inv_t(gq, rel), &grad), r);
                    const float gn = fmaxf(norm_t(grad), 1e-9f);
                    const V3 n = quat_rotate_t(
                        gq, v3(__fdiv_rn(grad.x, gn), __fdiv_rn(grad.y, gn), __fdiv_rn(grad.z, gn)));
                    const float mu_k = 0.5f * (sp.sph_mu[s] + gr.g_mu[k]);
                    float fn;
                    V3 vo;
                    F = F + obj_pair_force(sp, os, w, gr.g_link[k], gp, rel, n, depth, v, mu_k,
                                           n_act_k, N, to, ao, &vo, &fn);
                    if (id == KOFF + k) {
                        sel_n = n;
                        sel_fn = fn;
                        sel_mu = mu_k;
                        sel_vo = vo;
                    }
                }
                const bool on_grid = id >= KOFF;
                const int ks = on_grid ? id - KOFF : 0;
#else
                const bool on_grid = false;
#endif
                // the selected contact
                const bool on_box = id >= 2 && !on_grid;
#if FIS_BODY
                const bool on_obj = id >= 1;          // a selection above: the cube or a geom
#else
                const bool on_obj = id >= 2;
#endif
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
                    const bool same = anc_b == id;
                    V3 aw = anc_p;                          // ground / none: world frame
                    if (anc_b >= 2) {
                        const int ga = min(anc_b - 2, G - 1);
                        aw = add_r(quat_rotate_t(ld4(w.bq[ga]), anc_p), ld3(w.bp[ga]));
                    }
#if FIS_K > 0
                    if (anc_b >= KOFF) {
                        const int ka = min(anc_b - KOFF, K - 1);
                        aw = add_r(quat_rotate_t(ld4(w.gq[ka]), anc_p), ld3(w.gp[ka]));
                    }
#endif
#if FIS_BODY
                    if (anc_b == 1) aw = add_r(quat_rotate_t(ld4(w.st + R_BQUAT), anc_p),
                                               ld3(w.st + R_BPOS));
#endif
                    const V3 delta = c - aw;
                    const V3 delta_t = delta - dot(delta, n) * n;
                    const V3 ft_raw = same ? (-sp.anchor_ks) * delta_t - sp.anchor_cdt * vt
                                           : (-sp.anchor_cdt) * vt;
                    const float ft_mag = norm(ft_raw);
                    const float limit = mu * fn;
                    const bool stick = (ft_mag <= limit) && same;
                    const float scale =
                        ft_mag > 1e-9f ? fminf(limit / fmaxf(ft_mag, 1e-9f), 1.0f) : 0.0f;
                    ft = ft_raw * scale;
                    const V3 new_w = stick ? aw : c + ft / sp.anchor_ks;
                    anc_p = on_box ? quat_rotate_inv_t(ld4(w.bq[gs]), sub_r(new_w, ld3(w.bp[gs])))
                                   : new_w;
#if FIS_K > 0
                    if (on_grid) anc_p = quat_rotate_inv_t(ld4(w.gq[ks]), sub_r(new_w, ld3(w.gp[ks])));
#endif
#if FIS_BODY
                    if (id == 1) anc_p = quat_rotate_inv_t(ld4(w.st + R_BQUAT),
                                                           sub_r(new_w, ld3(w.st + R_BPOS)));
#endif
                    anc_b = id;
                    ft = ft * sticky;
                } else {
                    anc_b = -1;
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
                // friction reaction on the selected geom
                if (on_box) obj_friction_reaction(os, w, os.b_link[gs], ld3(w.bp[gs]), c, ft, to);
#if FIS_K > 0
                if (on_grid) obj_friction_reaction(os, w, gr.g_link[ks], ld3(w.gp[ks]), c, ft, to);
#endif
#if FIS_BODY
                // the friction on the cube, capped below once the spheres
                // that select it are counted
                if (id == 1) {
                    st3(rec + 3, ft);
                    rec[6] = norm(vt);
                }
#endif
            }
            st3(w.F[s], F);
#pragma unroll
            for (int k = 0; k < 9; ++k) w.N[s][k] = N[k];
            w.act[s] = id >= 0;
        }
        // the spheres that touch a partner, in sphere order
        const unsigned touching = __ballot_sync(FIS_FULL_MASK, lane < S && w.act[lane]);
        // the object's reaction: the spheres' parts summed over the lanes
#pragma unroll
        for (int d = 0; d < DO; ++d) to[d] = warp_sum(to[d]);
#pragma unroll
        for (int i = 0; i < TRIO; ++i) ao[i] = warp_sum(ao[i]);
        if (lane == 0) {
#pragma unroll
            for (int d = 0; d < DO; ++d) w.tau_o[d] = to[d];
#pragma unroll
            for (int i = 0; i < TRIO; ++i) w.Ao[i] = ao[i];
        }
        __syncwarp();
#if FIS_BODY
        // ---- the cube: a lane per sphere its normal reaction (-f,
        // -(rc x f)) and, where the cube is the selected partner, the
        // friction reaction capped to velocity matching; then the corners
        // and the integration
        {
            V3 fw = v3(0.0f, 0.0f, 0.0f), tw = v3(0.0f, 0.0f, 0.0f);
            V3 rc = fw;
            const float* rec = dsg + (lane < S ? lane : 0) * G;
            const bool sel = lane < S && rec[6] >= 0.0f;
            if (lane < S) {
                rc = ld3(w.cen[lane]) - ld3(w.st + R_BPOS);
                const V3 fb = ld3(rec);
                fw = fw - fb;
                tw = tw - cross(rc, fb);
            }
            const float n_touch_box = fmaxf(1.0f, (float)warp_count(sel));
            if (sel) {
                const V3 ft = ld3(rec + 3);
                const float cap = (sp.cube_mass / n_touch_box) * (rec[6] + sp.hold_vel) / sp.h;
                const float mag = norm(ft);
                const V3 ftc = ft * div_pos(fminf(mag, cap), fmaxf(mag, 1e-9f));
                fw = fw - ftc;
                tw = tw - cross(rc, ftc);
            }
            body_step(sp, w, lane, fw, tw);
        }
#endif
        PHASE(5)

        // ---- robot joint space: N J, then tau = J^T F and Ac = J^T N J,
        // lanes over entries summing over the touching spheres in order
        for (int i = lane; i < S * D; i += 32)
            st3(Njp + 3 * i, matvec(w.N[i / D], ld3(jp + 3 * i)));
        __syncwarp();
        {
            constexpr int NT = TRI + D, PER = (NT + 31) / 32;
            int dd[PER], ff[PER];
            float acc[PER];
#pragma unroll
            for (int k = 0; k < PER; ++k) {
                const int i = lane + 32 * k < NT ? lane + 32 * k : NT - 1;
                dd[k] = i >= TRI ? i - TRI : tri_row(i);
                ff[k] = i >= TRI ? -1 : i - dd[k] * (dd[k] + 1) / 2;   // -1: tau
                acc[k] = 0.0f;
            }
            for (unsigned m = touching; m != 0u; m &= m - 1u) {
                const int s = __ffs(m) - 1;
                const int li = sp.sph_link[s];
#pragma unroll
                for (int k = 0; k < PER; ++k) {
                    const int d = dd[k], f = ff[k];
                    const V3 jd = ld3(jp + 3 * (s * D + d));
                    const float term = dot(jd, f < 0 ? ld3(w.F[s]) : ld3(Njp + 3 * (s * D + f)));
                    acc[k] += sp.ancestor[li][d] != 0.0f
                              && (f < 0 || sp.ancestor[li][f] != 0.0f) ? term : 0.0f;
                }
            }
#pragma unroll
            for (int k = 0; k < PER; ++k) {
                const int i = lane + 32 * k;
                if (i < TRI) w.Ac[i] = acc[k];
                else if (i < NT) w.tau[i - TRI] = acc[k];
            }
        }
        __syncwarp();
        PHASE(6)

        // ---- both trees: two-pass effort-clamped implicit PD ----
        tree_steps(sp, os, w, w.scratch, lane);
        PHASE(7)
    }
    PHASES_END(lane == 0)

    // ---- store state (roots and targets pass through) ----
    for (int r = lane; r < R_ANCP; r += 32) out[(size_t)r * E + e] = w.st[r];
    for (int d = lane; d < D; d += 32) out[(size_t)(R_TGT + d) * E + e] = w.tgt[d];
    if (lane < S) {
        const int r = R_ANCP + 3 * lane;
        out[(size_t)r * E + e] = anc_p.x;
        out[(size_t)(r + 1) * E + e] = anc_p.y;
        out[(size_t)(r + 2) * E + e] = anc_p.z;
        anc_b_out[(size_t)lane * E + e] = anc_b;
    }
}

static int fis_prepare() {
    static bool done = false;
    if (done) return 0;
    const cudaError_t err = cudaFuncSetAttribute(
        fused_inner_step_obj_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    done = true;
    return 0;
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

// The launch configuration the wrapper checks against its own formula
// (sim/fused.launch_config): 0 envs (warps) per block, 1 threads per block,
// 2 dynamic shared-memory bytes per block.
int fis_launch_config(int which) {
    const int cfg[3] = {FIS_WARPS, FIS_THREADS, SMEM_BYTES};
    return (which >= 0 && which < 3) ? cfg[which] : -1;
}

// Blocks of this kernel resident on one SM at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
int fis_occupancy(int* blocks_per_sm) {
    const int err = fis_prepare();
    if (err != 0) return err;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, fused_inner_step_obj_kernel, FIS_THREADS, SMEM_BYTES);
}

// Copy the robot / contact description to the device, ordered on `stream`.
int fis_set_spec(const void* host_spec, int bytes, void* stream) {
    if (bytes != (int)sizeof(Spec)) return -1;
    cudaError_t err = cudaMemcpyToSymbolAsync(g_spec, host_spec, sizeof(Spec), 0,
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
    const int err = fis_prepare();
    if (err != 0) return err;
    const int blocks = (E + FIS_WARPS - 1) / FIS_WARPS;
    GridStack st = {(const float*)grid_sdf, (const float*)grid_bbox, (const float*)grid_voxel};
    fused_inner_step_obj_kernel<<<blocks, FIS_THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
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
    const int err = fis_prepare();
    if (err != 0) return err;
    const int blocks = (E + FIS_WARPS - 1) / FIS_WARPS;
    fused_inner_step_obj_kernel<<<blocks, FIS_THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
        (const float*)in, (const int*)anc_b_in, (float*)out, (int*)anc_b_out,
        (const ObjSpec*)obj_table, (const int*)obj_id, E, n_steps);
    return (int)cudaGetLastError();
}
#endif

}  // extern "C"
