// The contact geometry of kernels B1a / B1b / B1c rounded as the plain version
// rounds it on the card: forward kinematics, sphere centres, geom frames,
// a sphere's point in a geom's frame, the box distance and the trilinear
// SDF lookup.  Which side of a test a contact falls on (touching at depth
// 0, the trilinear cell of a grid query, whose gradient jumps at every cell
// face) follows from these numbers, so the kernel computes them bit for bit
// as the plain PyTorch version does: every elementwise operation of
// partmanip_tpu_torch/ops/rotations.py, sim/contact.py and ops/sdf.py
// rounded on its own (__fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn, which
// nvcc never contracts), in the plain version's order, and torch.linalg.cross
// and torch.linalg.norm as PyTorch's CUDA kernels compute them (checked
// against PyTorch 2.11.0+cu128 on an H100; chip_smoke.py's kernel_check
// prints, as rounding_share_bit_equal, the share of inputs on which each
// copied formula equals this PyTorch's result, so that a PyTorch that
// rounds otherwise shows in the run whose check it fails).  The rest of the
// kernel (Jacobians, forces, the solves) keeps fma contraction: it feeds no
// such test.

#pragma once

#include <cuda_runtime.h>

#include "fused_common.cuh"

__device__ __forceinline__ V3 add_r(V3 a, V3 b) {
    return v3(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y), __fadd_rn(a.z, b.z));
}
__device__ __forceinline__ V3 sub_r(V3 a, V3 b) {
    return v3(__fsub_rn(a.x, b.x), __fsub_rn(a.y, b.y), __fsub_rn(a.z, b.z));
}
__device__ __forceinline__ V3 mul_r(V3 a, float s) {
    return v3(__fmul_rn(a.x, s), __fmul_rn(a.y, s), __fmul_rn(a.z, s));
}

// torch.linalg.cross on the card: a1 b2 - a2 b1 as fma(a1, b2, -(a2 b1)).
__device__ __forceinline__ V3 cross_t(V3 a, V3 b) {
    return v3(__fmaf_rn(a.y, b.z, -__fmul_rn(a.z, b.y)),
              __fmaf_rn(a.z, b.x, -__fmul_rn(a.x, b.z)),
              __fmaf_rn(a.x, b.y, -__fmul_rn(a.y, b.x)));
}

// rotations.quat_mul: aw bx + ax bw + ay bz - az by ..., left to right.
__device__ __forceinline__ Q4 quat_mul_t(Q4 a, Q4 b) {
    Q4 r;
    r.x = __fsub_rn(__fadd_rn(__fadd_rn(__fmul_rn(a.w, b.x), __fmul_rn(a.x, b.w)),
                              __fmul_rn(a.y, b.z)), __fmul_rn(a.z, b.y));
    r.y = __fadd_rn(__fadd_rn(__fsub_rn(__fmul_rn(a.w, b.y), __fmul_rn(a.x, b.z)),
                              __fmul_rn(a.y, b.w)), __fmul_rn(a.z, b.x));
    r.z = __fadd_rn(__fsub_rn(__fadd_rn(__fmul_rn(a.w, b.z), __fmul_rn(a.x, b.y)),
                              __fmul_rn(a.y, b.x)), __fmul_rn(a.z, b.w));
    r.w = __fsub_rn(__fsub_rn(__fsub_rn(__fmul_rn(a.w, b.w), __fmul_rn(a.x, b.x)),
                              __fmul_rn(a.y, b.y)), __fmul_rn(a.z, b.z));
    return r;
}

// rotations.quat_rotate: t = 2 (q_vec x v); v + q_w t + q_vec x t.
__device__ __forceinline__ V3 quat_rotate_t(Q4 q, V3 v) {
    const V3 qv = v3(q.x, q.y, q.z);
    const V3 t = mul_r(cross_t(qv, v), 2.0f);
    return add_r(add_r(v, mul_r(t, q.w)), cross_t(qv, t));
}
__device__ __forceinline__ V3 quat_rotate_inv_t(Q4 q, V3 v) {
    const Q4 c = {-q.x, -q.y, -q.z, q.w};
    return quat_rotate_t(c, v);
}

// torch.linalg.norm over three floats as PyTorch's CUDA reduction adds the
// squares for most rows, (x^2 + z^2) + y^2 (its order varies with a row's
// alignment; only the box distance near an edge or corner reads it).
__device__ __forceinline__ float norm_t(V3 a) {
    return __fsqrt_rn(__fadd_rn(__fadd_rn(__fmul_rn(a.x, a.x), __fmul_rn(a.z, a.z)),
                                __fmul_rn(a.y, a.y)));
}

// contact.box_sdf: signed distance and outward normal of an axis-aligned
// box at local p, the distance rounded as the plain version rounds it.
__device__ __forceinline__ float box_sdf_t(V3 p, V3 half, V3* normal) {
    const V3 q = v3(__fsub_rn(fabsf(p.x), half.x), __fsub_rn(fabsf(p.y), half.y),
                    __fsub_rn(fabsf(p.z), half.z));
    const V3 q_out = v3(fmaxf(q.x, 0.0f), fmaxf(q.y, 0.0f), fmaxf(q.z, 0.0f));
    const float d_out = norm_t(q_out);
    const float q_max = fmaxf(q.x, fmaxf(q.y, q.z));
    const float d_in = fminf(q_max, 0.0f);
    const V3 sgn = v3(p.x >= 0.0f ? 1.0f : -1.0f, p.y >= 0.0f ? 1.0f : -1.0f,
                      p.z >= 0.0f ? 1.0f : -1.0f);
    if (d_out > 0.0f) {
        const float inv = fmaxf(d_out, 1e-9f);
        *normal = v3(__fdiv_rn(__fmul_rn(sgn.x, q_out.x), inv),
                     __fdiv_rn(__fmul_rn(sgn.y, q_out.y), inv),
                     __fdiv_rn(__fmul_rn(sgn.z, q_out.z), inv));
    } else {
        // inside: face(s) of least penetration
        const V3 n_in = v3(sgn.x * (q.x == q_max ? 1.0f : 0.0f),
                           sgn.y * (q.y == q_max ? 1.0f : 0.0f),
                           sgn.z * (q.z == q_max ? 1.0f : 0.0f));
        const float inv = fmaxf(norm_t(n_in), 1e-9f);
        *normal = v3(__fdiv_rn(n_in.x, inv), __fdiv_rn(n_in.y, inv), __fdiv_rn(n_in.z, inv));
    }
    return __fadd_rn(d_out, d_in);
}

// (position, quaternion) of frame B given in frame A: rotations
// .transform_compose, (quat_rotate(q_a, p_b) + p_a, quat_mul(q_a, q_b)).
__device__ __forceinline__ void compose_t(V3 pa, Q4 qa, V3 pb, Q4 qb, V3* p, Q4* q) {
    *p = add_r(quat_rotate_t(qa, pb), pa);
    *q = quat_mul_t(qa, qb);
}
