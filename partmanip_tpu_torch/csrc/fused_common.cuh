// Device functions shared by the fused inner-step kernels (B1a in
// fused_inner_step.cu, B1b / B1c in fused_inner_step_obj.cu): 3-vectors and
// xyzw quaternions, the world inertia and the regularized penalty force.
// Each follows the plain PyTorch version (partmanip_tpu_torch/ops/
// rotations.py, sim/contact.py) literally: every max(x, eps) guard is kept;
// build without -use_fast_math.  fused_geom.cuh holds the contact geometry
// rounded as the plain version rounds it, fused_warp.cuh the lane-level
// helpers and the Cholesky solve.

#pragma once

#include <cuda_runtime.h>

struct V3 { float x, y, z; };
struct Q4 { float x, y, z, w; };

__device__ __forceinline__ V3 v3(float x, float y, float z) { V3 r = {x, y, z}; return r; }
__device__ __forceinline__ V3 operator+(V3 a, V3 b) { return v3(a.x + b.x, a.y + b.y, a.z + b.z); }
__device__ __forceinline__ V3 operator-(V3 a, V3 b) { return v3(a.x - b.x, a.y - b.y, a.z - b.z); }
__device__ __forceinline__ V3 operator*(V3 a, float s) { return v3(a.x * s, a.y * s, a.z * s); }
__device__ __forceinline__ V3 operator*(float s, V3 a) { return v3(a.x * s, a.y * s, a.z * s); }
__device__ __forceinline__ V3 operator/(V3 a, float s) { return v3(a.x / s, a.y / s, a.z / s); }
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
    return v3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x);
}
__device__ __forceinline__ float norm(V3 a) { return sqrtf(dot(a, a)); }
__device__ __forceinline__ V3 ld3(const float* p) { return v3(p[0], p[1], p[2]); }
__device__ __forceinline__ Q4 ld4(const float* p) { Q4 r = {p[0], p[1], p[2], p[3]}; return r; }
__device__ __forceinline__ void st3(float* p, V3 v) { p[0] = v.x; p[1] = v.y; p[2] = v.z; }
__device__ __forceinline__ void st4(float* p, Q4 q) { p[0] = q.x; p[1] = q.y; p[2] = q.z; p[3] = q.w; }

__device__ __forceinline__ Q4 quat_mul(Q4 a, Q4 b) {
    Q4 r;
    r.x = a.w * b.x + a.x * b.w + a.y * b.z - a.z * b.y;
    r.y = a.w * b.y - a.x * b.z + a.y * b.w + a.z * b.x;
    r.z = a.w * b.z + a.x * b.y - a.y * b.x + a.z * b.w;
    r.w = a.w * b.w - a.x * b.x - a.y * b.y - a.z * b.z;
    return r;
}
__device__ __forceinline__ V3 quat_rotate(Q4 q, V3 v) {
    V3 qv = v3(q.x, q.y, q.z);
    V3 t = 2.0f * cross(qv, v);
    return v + q.w * t + cross(qv, t);
}
// xyzw quat -> row-major 3x3, with the 2/|q|^2 factor of the plain version
__device__ __forceinline__ void quat_to_mat(Q4 q, float* m) {
    float i = q.x, j = q.y, k = q.z, r = q.w;
    float two_s = 2.0f / (i * i + j * j + k * k + r * r);
    m[0] = 1.0f - two_s * (j * j + k * k);
    m[1] = two_s * (i * j - k * r);
    m[2] = two_s * (i * k + j * r);
    m[3] = two_s * (i * j + k * r);
    m[4] = 1.0f - two_s * (i * i + k * k);
    m[5] = two_s * (j * k - i * r);
    m[6] = two_s * (i * k - j * r);
    m[7] = two_s * (j * k + i * r);
    m[8] = 1.0f - two_s * (i * i + j * j);
}
// Iw = R I R^T (all row-major 3x3)
__device__ __forceinline__ void rotate_inertia(const float* R, const float* I, float* Iw) {
    float RI[9];
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int c = 0; c < 3; ++c)
            RI[a * 3 + c] = R[a * 3 + 0] * I[0 * 3 + c] + R[a * 3 + 1] * I[1 * 3 + c]
                          + R[a * 3 + 2] * I[2 * 3 + c];
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int d = 0; d < 3; ++d)
            Iw[a * 3 + d] = RI[a * 3 + 0] * R[d * 3 + 0] + RI[a * 3 + 1] * R[d * 3 + 1]
                          + RI[a * 3 + 2] * R[d * 3 + 2];
}
__device__ __forceinline__ V3 matvec(const float* m, V3 v) {
    return v3(m[0] * v.x + m[1] * v.y + m[2] * v.z,
              m[3] * v.x + m[4] * v.y + m[5] * v.z,
              m[6] * v.x + m[7] * v.y + m[8] * v.z);
}
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
    return fminf(fmaxf(x, lo), hi);
}

// Regularized penalty force of one contact (contact.penalty_forces); the
// caller has already established that the contact touches (depth < 0).
// n_act is the number of touching contacts sharing the impulse budget.
__device__ __forceinline__ V3 penalty_force(float depth, V3 n, V3 v_rel, float mu, float m_eff,
                                            float cd, float n_act, float recede_damp, float h,
                                            float kn, float kt, float max_depen, float* fn_out) {
    float vn = dot(v_rel, n);
    V3 vt = v_rel - vn * n;
    float vt_norm = norm(vt);
    float m_c = m_eff / n_act;
    float depth_pred = depth + h * vn;
    float budget = fmaxf(0.0f, max_depen - fmaxf(vn, 0.0f));
    float fn_spring = fminf(fmaxf(0.0f, -kn * fminf(depth, depth_pred)), m_c * budget / h);
    float approach = fmaxf(0.0f, -vn);
    float fn_damp = fminf(cd * approach, m_c * approach / h);
    float recede = fmaxf(0.0f, vn);
    float fn_rec = recede_damp * fminf(cd * recede, m_c * recede / h);
    float fn = fmaxf(0.0f, fn_spring + fn_damp - fn_rec);
    float ft_mag = fminf(fminf(mu * fn, kt * vt_norm), m_c * vt_norm / h);
    V3 ft = ((-ft_mag) * vt) / fmaxf(vt_norm, 1e-6f);
    *fn_out = fn;
    return fn * n + ft;
}
