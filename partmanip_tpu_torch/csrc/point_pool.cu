// PointNet's max pool over points and its backward at the argmax points,
// CUDA C++ for sm_90a.
//
// Replaces no TPU kernel: the JAX package pools with jnp.max after its last
// point layer (partmanip_tpu/models/networks.py, PointNet) and leaves the
// gradient to XLA.  Its plain PyTorch version is
// partmanip_tpu_torch/ops/point_pool.py (pool_plain, backward_plain), which
// computes what autograd through Linear + amax computes.
//
// PointNet's last point layer h = h2 W^T + b ([B, N, D] -> [B, N, C], no
// activation after it) is pooled by the max over the N points.  amax's
// backward hands the layer a dense [B, N, C] gradient that is zero except
// at each (row, channel)'s maxima, where it is g / k (k equal maxima share
// the gradient evenly), and the layer's backward multiplies those zeros in
// two GEMMs of B * N * C * D products each.  What they yield depends only on
// the maxima:
//
//   db[c]      = sum_b g[b,c]
//   dW[c, :]   = sum_b g[b,c] / k[b,c] * sum_{p in ties(b,c)} h2[b,p,:]
//   dh2[b,p,:] = sum_{c : p in ties(b,c)} g[b,c] / k[b,c] * W[c,:]
//
// Three kernels:
//
// 1. pool_forward_kernel reads h once (the product itself stays a cuBLAS
//    GEMM in the wrapper) and writes the max (bit for bit amax's: a max is
//    exact), the first index of the max, the count k of points equal to
//    it and, for channels with k > 1 only, a bitmask of those points (one
//    bit a point, [B, C, ceil(N / 32)] words).  A block takes one row and
//    128 channels, a lane 4 of them (one 16-byte load a point), its warp
//    every 8th word of 32 points; the 8 warps' (max, first, count) are
//    merged in shared memory.  Only a block that holds a tied channel reads
//    its tile again, for the bitmask.  Bound: the bytes of h (B * N * C * 4).
// 2. pool_weight_grad_kernel: a block per channel, a thread per column of
//    h2, the rows in order: dW gathers one 256-wide row of h2 a row where
//    k = 1 (all the rows first, with weight 0 at the tied ones, so that the
//    loads carry no branch), then the tied rows' points in order; db is the
//    sum of g in row order.  Bound: the gathered bytes (B * C * D * 4).
// 3. pool_input_grad_kernel: a block per row.  The row's C channels are
//    sorted by (argmax point, channel) in shared memory (bitonic; channels
//    that tie sort last, by channel), which gives each point the run of
//    channels whose single maximum it holds.  The block then writes every
//    point's gradient row: the sum over its run, then over the tied
//    channels whose bitmask holds it (their words staged in shared memory
//    32 points at a time), zero off the argmax points.  It also counts the
//    row's argmax points and tied channels.  Bound: the bytes of dh2
//    (B * N * D * 4), which the dense layer below needs whole.
//
// Every sum runs in a fixed order (no atomics), so two calls on the same
// inputs give the same bits.  No kernel synchronises with the host.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int POOL_THREADS = 256;
constexpr int POOL_WARPS = POOL_THREADS / 32;
constexpr int TILE = 128;              // channels a forward block: 32 lanes x 4
constexpr int C_BITS = 10;             // a sort key's channel bits: C <= 1024
constexpr unsigned C_MASK = (1u << C_BITS) - 1u;
constexpr int ROWS = 256;              // rows of (g, k, argmax) staged at once
constexpr int TIE_BATCH = 8;           // a tied pool's points loaded at once

// Fold value v at point p into a running (max, first index, count): a
// larger value or the first NaN restarts the run (amax propagates NaN), an
// equal value counts; points arrive in increasing order.
__device__ __forceinline__ void take(float v, int p, float& m, int& i, int& k) {
    if (v > m || (v != v && m == m)) {
        m = v; i = p; k = 1;
    } else if (v == m) {
        if (k == 0) i = p;
        k += 1;
    }
}

// Merge another warp's (max, first, count) of disjoint points into (m, i, k).
__device__ __forceinline__ void merge(float m2, int i2, int k2, float& m, int& i, int& k) {
    if (k2 == 0) return;
    if (k == 0 || m2 > m || (m2 != m2 && m == m)) {
        m = m2; i = i2; k = k2;
    } else if (m2 == m) {
        k += k2; i = min(i, i2);
    } else if (m2 != m2 && m != m) {
        i = min(i, i2);
    }
}

__global__ void __launch_bounds__(POOL_THREADS)
pool_forward_kernel(const float* __restrict__ h, float* __restrict__ pooled,
                    int* __restrict__ first, int* __restrict__ count,
                    unsigned* __restrict__ mask, int N, int C, int W) {
    __shared__ float s_m[POOL_WARPS][TILE];
    __shared__ int s_i[POOL_WARPS][TILE];
    __shared__ int s_k[POOL_WARPS][TILE];
    __shared__ float s_max[TILE];
    __shared__ int s_count[TILE];
    __shared__ int s_tied;
    const int b = blockIdx.x;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int c0 = blockIdx.y * TILE + 4 * lane;
    const bool live = c0 < C;                     // C % 4 == 0 (the wrapper checks)
    const float* row = h + (size_t)b * N * C + c0;

    float m[4];
    int i[4], k[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) { m[q] = -CUDART_INF_F; i[q] = 0; k[q] = 0; }
    if (live) {
        for (int j = warp; j < W; j += POOL_WARPS) {
            const int p0 = 32 * j, p1 = min(p0 + 32, N);
#pragma unroll 8
            for (int p = p0; p < p1; ++p) {
                const float4 v = __ldg(reinterpret_cast<const float4*>(row + (size_t)p * C));
                take(v.x, p, m[0], i[0], k[0]);
                take(v.y, p, m[1], i[1], k[1]);
                take(v.z, p, m[2], i[2], k[2]);
                take(v.w, p, m[3], i[3], k[3]);
            }
        }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        s_m[warp][4 * lane + q] = m[q];
        s_i[warp][4 * lane + q] = i[q];
        s_k[warp][4 * lane + q] = k[q];
    }
    if (threadIdx.x == 0) s_tied = 0;
    __syncthreads();
    if (threadIdx.x < TILE) {
        const int t = threadIdx.x, c = blockIdx.y * TILE + t;
        float M = s_m[0][t];
        int I = s_i[0][t], K = s_k[0][t];
        for (int w = 1; w < POOL_WARPS; ++w) merge(s_m[w][t], s_i[w][t], s_k[w][t], M, I, K);
        s_max[t] = M;
        s_count[t] = K;
        if (c < C) {
            const size_t at = (size_t)b * C + c;
            pooled[at] = M;
            first[at] = I;
            count[at] = K;
            if (K > 1) s_tied = 1;
        }
    }
    __syncthreads();
    if (!s_tied || !live) return;
    // the tied channels' bitmasks: bit p % 32 of word p / 32 is h[p] == max
    for (int j = warp; j < W; j += POOL_WARPS) {
        const int p0 = 32 * j, p1 = min(p0 + 32, N);
        unsigned bits[4] = {0u, 0u, 0u, 0u};
        for (int p = p0; p < p1; ++p) {
            const float4 v = __ldg(reinterpret_cast<const float4*>(row + (size_t)p * C));
            const unsigned bit = 1u << (p - p0);
            bits[0] |= v.x == s_max[4 * lane + 0] ? bit : 0u;
            bits[1] |= v.y == s_max[4 * lane + 1] ? bit : 0u;
            bits[2] |= v.z == s_max[4 * lane + 2] ? bit : 0u;
            bits[3] |= v.w == s_max[4 * lane + 3] ? bit : 0u;
        }
#pragma unroll
        for (int q = 0; q < 4; ++q)
            if (s_count[4 * lane + q] > 1) mask[((size_t)b * C + c0 + q) * W + j] = bits[q];
    }
}

__global__ void __launch_bounds__(1024)
pool_weight_grad_kernel(const float* __restrict__ g, const float* __restrict__ h2,
                        const int* __restrict__ first, const int* __restrict__ count,
                        const unsigned* __restrict__ mask, float* __restrict__ dw,
                        float* __restrict__ db, int B, int N, int C, int D, int W) {
    __shared__ float s_g[ROWS], s_w[ROWS];
    __shared__ int s_k[ROWS], s_p[ROWS];
    const int c = blockIdx.x, d = threadIdx.x;
    float acc = 0.f, bacc = 0.f;
    for (int b0 = 0; b0 < B; b0 += ROWS) {
        const int n = min(ROWS, B - b0);
        for (int t = threadIdx.x; t < n; t += blockDim.x) {
            const size_t at = (size_t)(b0 + t) * C + c;
            const int k = count[at];
            const float gv = g[at];
            s_g[t] = gv;
            s_k[t] = k;
            s_w[t] = k == 1 ? gv : 0.f;
            s_p[t] = k == 1 ? first[at] : 0;
        }
        __syncthreads();
        if (d < D) {
            const float* base = h2 + (size_t)b0 * N * D + d;
#pragma unroll 8
            for (int t = 0; t < n; ++t)
                acc = fmaf(s_w[t], __ldg(base + ((size_t)t * N + s_p[t]) * D), acc);
            for (int t = 0; t < n; ++t) {
                const int k = s_k[t];
                if (k < 2) continue;
                const float w = s_g[t] / (float)k;
                const unsigned* words = mask + ((size_t)(b0 + t) * C + c) * W;
                const float* rowp = base + (size_t)t * N * D;
                for (int j = 0; j < W; ++j) {
                    unsigned bits = words[j];
                    while (bits) {              // up to TIE_BATCH loads in flight
                        float v[TIE_BATCH];
                        int taken = 0;
#pragma unroll
                        for (int u = 0; u < TIE_BATCH; ++u) {
                            v[u] = 0.f;
                            if (bits) {
                                const int q = __ffs(bits) - 1;
                                bits &= bits - 1u;
                                v[u] = __ldg(rowp + (size_t)(32 * j + q) * D);
                                taken = u + 1;
                            }
                        }
#pragma unroll
                        for (int u = 0; u < TIE_BATCH; ++u)
                            if (u < taken) acc = fmaf(w, v[u], acc);
                    }
                }
            }
        }
        if (threadIdx.x == 0)
            for (int t = 0; t < n; ++t) bacc += s_g[t];
        __syncthreads();
    }
    if (d < D) dw[(size_t)c * D + d] = acc;
    if (threadIdx.x == 0) db[c] = bacc;
}

// Dynamic shared memory of pool_input_grad_kernel (ops/point_pool.py
// input_grad_smem): P sort keys, C weights g / k, C staged bitmask words,
// then each point's run of sorted positions [start, end) as 16-bit values.
__host__ __device__ inline int pow2_at_least(int n) {
    int p = 1;
    while (p < n) p <<= 1;
    return p;
}

__global__ void __launch_bounds__(1024)
pool_input_grad_kernel(const float* __restrict__ g, const float* __restrict__ w3,
                       const int* __restrict__ first, const int* __restrict__ count,
                       const unsigned* __restrict__ mask, float* __restrict__ dh2,
                       int* __restrict__ stats, int N, int C, int D, int W) {
    extern __shared__ unsigned smem[];
    const int P = pow2_at_least(C);
    unsigned* keys = smem;
    float* wgt = reinterpret_cast<float*>(keys + P);
    unsigned* tw = reinterpret_cast<unsigned*>(wgt + C);
    unsigned short* start = reinterpret_cast<unsigned short*>(tw + C);
    unsigned short* end = start + N;
    __shared__ int s_single;                  // channels with one maximum
    const int b = blockIdx.x, tid = threadIdx.x, d = threadIdx.x;

    if (tid == 0) s_single = C;
    for (int c = tid; c < P; c += blockDim.x) {
        if (c < C) {
            const size_t at = (size_t)b * C + c;
            const int k = count[at];
            wgt[c] = g[at] / (float)k;
            const unsigned p = k == 1 ? (unsigned)first[at] : (unsigned)N;
            keys[c] = (p << C_BITS) | (unsigned)c;
        } else {
            keys[c] = 0xffffffffu;
        }
    }
    for (int p = tid; p < N; p += blockDim.x) start[p] = end[p] = 0;
    __syncthreads();
    for (int k = 2; k <= P; k <<= 1) {
        for (int j = k >> 1; j > 0; j >>= 1) {
            for (int i = tid; i < P; i += blockDim.x) {
                const int l = i ^ j;
                if (l > i) {
                    const unsigned a = keys[i], e = keys[l];
                    if (((i & k) == 0) ? a > e : a < e) { keys[i] = e; keys[l] = a; }
                }
            }
            __syncthreads();
        }
    }
    for (int s = tid; s < C; s += blockDim.x) {
        const unsigned p = keys[s] >> C_BITS;
        const unsigned prev = s > 0 ? keys[s - 1] >> C_BITS : 0xffffffffu;
        const unsigned next = s + 1 < C ? keys[s + 1] >> C_BITS : 0xffffffffu;
        if (p < (unsigned)N) {
            if (prev != p) start[p] = (unsigned short)s;
            if (next != p) end[p] = (unsigned short)(s + 1);
        } else if (s == 0 || prev < (unsigned)N) {
            s_single = s;
        }
    }
    __syncthreads();
    const int n1 = s_single, T = C - n1;
    int critical = 0;
    for (int j = 0; j < W; ++j) {
        if (T > 0) {
            for (int t = tid; t < T; t += blockDim.x)
                tw[t] = mask[((size_t)b * C + (keys[n1 + t] & C_MASK)) * W + j];
            __syncthreads();
        }
        const int q1 = min(32, N - 32 * j);
        for (int q = 0; q < q1; ++q) {
            const int p = 32 * j + q;
            float v = 0.f;
            bool hit = false;
            for (int s = start[p]; s < end[p]; ++s) {
                const int c = keys[s] & C_MASK;
                if (d < D) v = fmaf(wgt[c], __ldg(w3 + (size_t)c * D + d), v);
                hit = true;
            }
            for (int t = 0; t < T; ++t) {
                if ((tw[t] >> q) & 1u) {
                    const int c = keys[n1 + t] & C_MASK;
                    if (d < D) v = fmaf(wgt[c], __ldg(w3 + (size_t)c * D + d), v);
                    hit = true;
                }
            }
            if (d < D) dh2[((size_t)b * N + p) * D + d] = v;
            critical += hit;
        }
        if (T > 0) __syncthreads();           // before the next word's staging
    }
    if (tid == 0) {
        stats[2 * b] = critical;
        stats[2 * b + 1] = T;
    }
}

}  // namespace

extern "C" {

// Max over the N points of h ([B, N, C] f32, C % 4 == 0, 16-byte aligned):
// pooled [B, C] f32, the first index of the max and the count of points equal
// to it ([B, C] i32 each), and for channels whose count exceeds 1 the bitmask
// of those points ([B, C, W] u32, W = ceil(N / 32); other channels' words are
// left as they were).  Returns the CUDA error of the launch.
int point_pool_forward(const float* h, float* pooled, int* first, int* count, unsigned* mask,
                       int B, int N, int C, void* stream) {
    const int W = (N + 31) / 32;
    const dim3 grid(B, (C + TILE - 1) / TILE);
    pool_forward_kernel<<<grid, POOL_THREADS, 0, (cudaStream_t)stream>>>(
        h, pooled, first, count, mask, N, C, W);
    return (int)cudaGetLastError();
}

// The gradients of pooled = max_p (h2 W^T + b) from g ([B, C] f32) and the
// forward's first / count / mask: dh2 [B, N, D] (every element written),
// dw [C, D], db [C], and per row its argmax points and tied channels
// (stats [B, 2] i32).  `smem` is pool_input_grad_kernel's dynamic shared
// memory in bytes, `threads` the block size (D rounded up to whole warps).
// Returns the CUDA error of the launches.
int point_pool_backward(const float* g, const float* h2, const float* w3, const int* first,
                        const int* count, const unsigned* mask, float* dh2, float* dw,
                        float* db, int* stats, int B, int N, int C, int D, int threads,
                        int smem, void* stream) {
    const int W = (N + 31) / 32;
    cudaStream_t s = (cudaStream_t)stream;
    pool_weight_grad_kernel<<<C, threads, 0, s>>>(g, h2, first, count, mask, dw, db,
                                                   B, N, C, D, W);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    pool_input_grad_kernel<<<B, threads, smem, s>>>(g, w3, first, count, mask, dh2, stats,
                                                    N, C, D, W);
    return (int)cudaGetLastError();
}

}  // extern "C"
