// Farthest-point sampling (kernel B3), CUDA C++ for sm_90a.
//
// Replaces the TPU Pallas kernel of partmanip_tpu/ops/fps.py
// (farthest_point_sampling_pallas, body `kernel`) and computes what
// partmanip_tpu_torch/ops/fps.py:farthest_point_sampling_plain computes, its
// plain PyTorch version: pick index 0, then k - 1 times update every point's
// running minimum squared distance to the picked set with its distance to the
// last pick, and pick the point whose minimum is largest, the lowest index
// among equals (jnp.argmax's rule).
//
// Design.  One thread block of 1024 threads per batch row; the k - 1
// iterations are a loop inside the block, each one a pass over the row's
// points (float4, packed once by the wrapper) that writes the running
// minimum back to device memory, followed by a block-wide (value, index)
// argmax: warp shuffles, then one warp over the 32 warp results.  The running
// minimum does not fit on chip at the main path's size (N = 442,368: 1.77 MB
// a row against 227 KB of shared memory an SM), so it stays in device memory
// (and in L2 where it fits).  Each thread walks its points in increasing
// index order and keeps a strictly larger value, so its own candidate is the
// lowest index of its maximum; the reductions break ties towards the lower
// index.  A grid of B blocks keeps at most B of the 132 SMs at work;
// splitting a row over a thread-block cluster with a reduction in
// distributed shared memory is later work.
//
// What bounds it on an H100: the k·N·B distance evaluations (8 f32
// operations each) are f32 work; bytes in (the points once) and out (the
// indices) are small, but this design streams the points and the running
// minimum through device memory on every iteration.
//
// Numerics.  The distance is the fused multiply-add chain
// fma(dz, dz, fma(dy, dy, dx * dx)) with explicit intrinsics (__fsub_rn,
// __fmul_rn, __fmaf_rn: nothing left to the compiler's contraction), which
// is what the JAX package's XLA loop computes on the CPU and what the plain
// version computes (fps.fma_f32), so that the three agree bit for bit and
// pick the same indices even where distinct points tie.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int THREADS = 1024;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float sqdist(float4 a, float4 q) {
    const float dx = __fsub_rn(a.x, q.x);
    const float dy = __fsub_rn(a.y, q.y);
    const float dz = __fsub_rn(a.z, q.z);
    return __fmaf_rn(dz, dz, __fmaf_rn(dy, dy, __fmul_rn(dx, dx)));
}

// (v, i) replaces (best, bi) when larger, or equal with a lower index.
__device__ __forceinline__ void take(float& best, int& bi, float v, int i) {
    if (v > best || (v == best && i < bi)) {
        best = v;
        bi = i;
    }
}

__device__ __forceinline__ void warp_argmax(float& best, int& bi) {
    for (int off = 16; off > 0; off >>= 1) {
        const float v = __shfl_down_sync(FULL, best, off);
        const int i = __shfl_down_sync(FULL, bi, off);
        take(best, bi, v, i);
    }
}

__global__ void __launch_bounds__(THREADS)
fps_kernel(const float4* __restrict__ pts_all,   // [B, N]
           float* __restrict__ mind_all,         // [B, N] scratch
           int* __restrict__ idx_all,            // [B, k]
           int N, int k) {
    __shared__ float s_val[THREADS / 32];
    __shared__ int s_idx[THREADS / 32];
    __shared__ int s_last;
    const int b = blockIdx.x;
    const float4* __restrict__ pts = pts_all + (size_t)b * N;
    float* __restrict__ mind = mind_all + (size_t)b * N;
    int* __restrict__ idx = idx_all + (size_t)b * k;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    if (tid == 0) idx[0] = 0;
    int last = 0;
    for (int it = 1; it < k; ++it) {
        const float4 q = __ldg(pts + last);
        const bool first = (it == 1);      // running minimum still +inf
        float best = -CUDART_INF_F;
        int bi = 0x7fffffff;
        int j = tid;
        for (; j + 3 * THREADS < N; j += 4 * THREADS) {
            const float4 a0 = __ldg(pts + j), a1 = __ldg(pts + j + THREADS),
                         a2 = __ldg(pts + j + 2 * THREADS), a3 = __ldg(pts + j + 3 * THREADS);
            float m0 = sqdist(a0, q), m1 = sqdist(a1, q), m2 = sqdist(a2, q),
                  m3 = sqdist(a3, q);
            if (!first) {
                m0 = fminf(mind[j], m0);
                m1 = fminf(mind[j + THREADS], m1);
                m2 = fminf(mind[j + 2 * THREADS], m2);
                m3 = fminf(mind[j + 3 * THREADS], m3);
            }
            mind[j] = m0;
            mind[j + THREADS] = m1;
            mind[j + 2 * THREADS] = m2;
            mind[j + 3 * THREADS] = m3;
            if (m0 > best) { best = m0; bi = j; }
            if (m1 > best) { best = m1; bi = j + THREADS; }
            if (m2 > best) { best = m2; bi = j + 2 * THREADS; }
            if (m3 > best) { best = m3; bi = j + 3 * THREADS; }
        }
        for (; j < N; j += THREADS) {
            float m = sqdist(__ldg(pts + j), q);
            if (!first) m = fminf(mind[j], m);
            mind[j] = m;
            if (m > best) { best = m; bi = j; }
        }
        warp_argmax(best, bi);
        if (lane == 0) {
            s_val[warp] = best;
            s_idx[warp] = bi;
        }
        __syncthreads();
        if (warp == 0) {
            best = s_val[lane];
            bi = s_idx[lane];
            warp_argmax(best, bi);
            if (lane == 0) {
                idx[it] = bi;
                s_last = bi;
            }
        }
        __syncthreads();
        last = s_last;
    }
}

}  // namespace

extern "C" {

// Indices [B, k] of the farthest-point samples of B rows of N points, on
// `stream`; `mind` is [B, N] f32 scratch.  Returns the CUDA error of the
// launch (0 when it was accepted).
int fps_launch(const void* pts, float* mind, int* idx, int B, int N, int k,
               void* stream) {
    fps_kernel<<<B, THREADS, 0, (cudaStream_t)stream>>>(
        static_cast<const float4*>(pts), mind, idx, N, k);
    return (int)cudaGetLastError();
}

}  // extern "C"
