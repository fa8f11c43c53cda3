// Warp-level helpers of the fused inner-step kernels that split an env over
// lanes (B1b / B1c in fused_inner_step_obj.cu, a warp per env; B1a in
// fused_inner_step.cu, a half-warp per env): deterministic warp and
// half-warp sums and counts, and the Cholesky solve of an N x N SPD system
// with one row per lane.  Every sum here has one fixed order, so a result
// does not depend on timing; no atomics.

#pragma once

#include <cuda_runtime.h>

#define FIS_FULL_MASK 0xffffffffu

// Sum of v over the 32 lanes by a butterfly: every lane ends with the same
// bits (a + b == b + a in IEEE arithmetic, level by level).
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FIS_FULL_MASK, v, off);
    return v;
}

// Number of lanes whose predicate holds (an exact integer count).
__device__ __forceinline__ int warp_count(bool pred) {
    return __popc(__ballot_sync(FIS_FULL_MASK, pred));
}

// The lanes of the half-warp that starts at lane base (0 or 16) whose
// predicate holds, as a 16-bit mask (bit i: lane base + i).  Every lane of
// the warp calls it.
__device__ __forceinline__ unsigned half_ballot(bool pred, int base) {
    return (__ballot_sync(FIS_FULL_MASK, pred) >> base) & 0xffffu;
}

// Number of lanes of the half-warp that starts at base whose predicate
// holds (an exact integer count).
__device__ __forceinline__ int half_count(bool pred, int base) {
    return __popc(half_ballot(pred, base));
}

// Sum of v over the 16 lanes of each half-warp by a butterfly (xor 8, 4, 2,
// 1): every lane of a half ends with the same bits, and the two halves never
// mix.
__device__ __forceinline__ float half_sum(float v) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(FIS_FULL_MASK, v, off);
    return v;
}

// IEEE a / b and sqrt(x), as "/" and sqrtf compile without fast math, but
// opaque to the compiler: it cannot fold the operand selects below away and
// divide every lane's own (possibly zero or uninitialised) operands.
__device__ __forceinline__ float div_rn(float a, float b) {
    float q;
    asm("div.rn.f32 %0, %1, %2;" : "=f"(q) : "f"(a), "f"(b));
    return q;
}
__device__ __forceinline__ float sqrt_rn(float x) {
    float r;
    asm("sqrt.rn.f32 %0, %1;" : "=f"(r) : "f"(x));
    return r;
}

// a / b for b > 0, the division's result bit for bit (a zero a gives
// itself: 0 / b keeps a's sign), but a lane whose a is zero, or whose result
// is discarded (use false, the result is then a), divides 1 by 1: no lane
// sends the warp down the IEEE division's slow path on a zero or on garbage.
__device__ __forceinline__ float div_pos(float a, float b, bool use = true) {
    const bool go = use && a != 0.0f;
    const float q = div_rn(go ? a : 1.0f, go ? b : 1.0f);
    return go ? q : a;
}

// sqrtf(x) for x >= 0, bit for bit (sqrt(+-0) = +-0), without the square
// root's slow path on a zero.
__device__ __forceinline__ float sqrt_nz(float x) {
    const bool z = x == 0.0f;
    const float r = sqrt_rn(z ? 1.0f : x);
    return z ? x : r;
}

// Solve A x = b for an N x N SPD matrix (ops/linalg.py: cholesky_factor +
// cholesky_solve), the lane base + ri (ri < N) holding row ri of A's lower
// triangle in row[0..ri] (zeros past it) and b_i, and getting x_i back
// (lanes with ri >= N hold finite rows of their own, write nothing and must
// drop what they get).  Every lane of the warp calls it; two systems may
// share the warp (base 0 and 16, N <= 16).  Lsh: N x N floats of shared
// memory for the back substitution.
//
// Factor, column by column: lane i computes r_i = A[i][j] - sum_{k<j}
// L[j][k] L[i][k] in k order, with the pivot row's entries shuffled from
// lane j; lane j's r is the pivot (the serial factor's s, same order), each
// lane takes L[j][j] = sqrt(max(s, 1e-12)) and lanes i > j divide.  Forward
// substitution: y_i on lane i, each later row subtracting L[i][k] y_k in k
// order as the serial solve does.  Back substitution reads column i of L
// from Lsh, subtracting L[k][i] x_k from k = N - 1 down (the serial solve
// goes up).  The divisions go through div_pos: only the lanes whose
// quotient is kept divide; selects, no divergent branch.
template <int N>
__device__ __forceinline__ float spd_solve_warp(float (&row)[N], float b, float* Lsh, int ri,
                                                int base) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
        float r = row[j];
#pragma unroll
        for (int k = 0; k < j; ++k) r -= __shfl_sync(FIS_FULL_MASK, row[k], base + j) * row[k];
        const float ljj = sqrtf(fmaxf(__shfl_sync(FIS_FULL_MASK, r, base + j), 1e-12f));
        const float q = div_pos(r, ljj, ri > j);
        row[j] = ri == j ? ljj : q;
    }
    float s = b, y = 0.0f;
#pragma unroll
    for (int i = 0; i < N; ++i) {
        const float yi = __shfl_sync(FIS_FULL_MASK, div_pos(s, row[i], ri == i), base + i);
        y = ri == i ? yi : y;
        s = ri > i ? s - row[i] * yi : s;
    }
    if (ri < N) {
#pragma unroll
        for (int k = 0; k < N; ++k)
            if (k <= ri) Lsh[ri * N + k] = row[k];
    }
    __syncwarp();
    float t = y, x = 0.0f;
#pragma unroll
    for (int i = N - 1; i >= 0; --i) {
        const float xi = __shfl_sync(FIS_FULL_MASK, div_pos(t, row[i], ri == i), base + i);
        x = ri == i ? xi : x;
        t = ri < i ? t - Lsh[i * N + (ri < i ? ri : 0)] * xi : t;
    }
    __syncwarp();
    return x;
}

// (d, f) of entry i of a row-major lower triangle (i = d (d + 1) / 2 + f).
__device__ __forceinline__ int tri_row(int i) {
    int d = 0;
    while ((d + 1) * (d + 2) / 2 <= i) ++d;
    return d;
}

// Row d of A = M + diag + Ac (lower triangles Mt, Act) into registers,
// zeros past the diagonal; a padding lane (real false) takes row ri of the
// identity instead (all zeros for ri >= NR): spd_solve_warp's row.
template <int NR>
__device__ __forceinline__ void system_row(float (&row)[NR], int ri, const float* Mt,
                                           const float* Act, int d, float diag, bool real) {
    const int base = d * (d + 1) / 2;
#pragma unroll
    for (int f = 0; f < NR; ++f) {
        const int i = base + (f < d ? f : d);
        const float a = f < d ? Mt[i] + Act[i] : (f == d ? Mt[i] + diag + Act[i] : 0.0f);
        row[f] = real ? a : (f == ri ? 1.0f : 0.0f);
    }
}
