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
// Design.  Each batch row is split over a thread-block cluster of C CTAs
// (C at most 8, the portable cluster size; launched with cudaLaunchKernelEx
// and a cluster-dimension attribute), so that B rows keep B * C SMs at work.
// A cluster must fit within one GPC, so fewer clusters of 8 may fit on the
// card at once than 132 / 8: the wrapper (ops/fps.py) asks
// cudaOccupancyMaxActiveClusters and takes the size that runs the B rows in
// the fewest waves, the largest among those.  One launch runs three
// phases:
//
// 1. Compaction (the zero cluster collapsed).  The points that are all +-0
//    (the invalid pixels the caller zeroes, 87 % of a render cloud) have
//    equal distances to every query, so they always tie, and under the
//    lowest-index rule only the lowest-index one can ever be picked.  Each
//    CTA counts the kept points of its 1/C of the row (index 0, every
//    point that is not all +-0) and its lowest all-zero index; the CTAs read
//    each other's counts over distributed shared memory, and each writes its
//    kept points, in order, at its offset of the compacted row in device
//    memory, the row's lowest all-zero point among them (x, y, z and the
//    original index).  So the compacted row holds the same candidates in the
//    same order, and the picks are the same indices, bit for bit: (-0) - q
//    and 0 - q round alike.
// 2. Each CTA loads its 1/C of the compacted row into shared memory as
//    (x, y, z, running minimum), 16 bytes a point, up to `cap` points (the
//    opt-in 227 KB); a share that does not fit keeps the rest, and its
//    running minimum, in device memory.
// 3. The k - 1 iterations: each thread updates the running minimum of its
//    points (increasing position, strictly larger wins, so its candidate is
//    the lowest position of its maximum); a (value, position) argmax over
//    the block (warp shuffles, then one warp over the warp results); the
//    CTA's pair goes to its shared memory, one cluster.sync(), and warp 0 of
//    every CTA reduces the C pairs read over distributed shared memory
//    and reads the winner's coordinates from its owner's shared memory.  The
//    pairs are double-buffered by parity, so one cluster barrier per
//    iteration suffices; no grid-wide sync, no host round trip.  Positions
//    of the compacted row order like original indices, so ties break on
//    positions; CTA 0 writes the picked positions and maps them to original
//    indices at the end.
//
// What bounds it on an H100: the k * M * B distance evaluations (8 f32
// operations each, M the compacted row length); the bytes in (the points
// once) and out (the indices) are small, and the design streams nothing
// through device memory per iteration while the shares fit on chip.  With
// few operations per iteration (M / C points a CTA), the per-iteration
// latency of the block reduction and the cluster barrier bounds it in
// practice.
//
// Numerics.  The distance is the fused multiply-add chain
// fma(dz, dz, fma(dy, dy, dx * dx)) with explicit intrinsics (__fsub_rn,
// __fmul_rn, __fmaf_rn: nothing left to the compiler's contraction), which
// is what the JAX package's XLA loop computes on the CPU and what the plain
// version computes (fps.fma_f32), so that the three agree bit for bit and
// pick the same indices even where distinct points tie.

#include <climits>
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_CLUSTER = 8;     // CTAs a row at most (the portable cluster size)
constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int STATIC_SMEM = 1024;  // bound of Shared below (ops/fps.py STATIC_SMEM)
constexpr unsigned FULL = 0xffffffffu;

struct Shared {
    float red_val[WARPS];          // per-warp argmax candidates
    int red_idx[WARPS];
    int scan[WARPS];               // per-warp kept counts of a compaction tile
    float pair_val[2];             // this CTA's argmax, by iteration parity
    int pair_idx[2];
    int count;                     // phase 1: kept points of this CTA's raw chunk
    int zero_min;                  //          and its lowest all-zero index
    int offset, total, rep;        // its compacted offset, the row's count, the zero point kept
    float4 query;
};
static_assert(sizeof(Shared) <= STATIC_SMEM, "static shared memory over its bound");

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

__device__ __forceinline__ long long globaltimer() {    // ns, one clock for all SMs
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return (long long)t;
}

__device__ __forceinline__ long long smid() {
    unsigned id;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(id));
    return id;
}

__device__ __forceinline__ bool all_zero(float x, float y, float z) {
    return x == 0.0f && y == 0.0f && z == 0.0f;        // true for -0.0 too
}

__global__ void __launch_bounds__(THREADS, 1)
fps_kernel(const float* __restrict__ pts_all,     // [B, N, 3]
           float4* __restrict__ comp_all,         // [B, N] compacted: x, y, z, original index
           float* __restrict__ mind_all,          // [B, N] running minimum beyond shared memory
           int* __restrict__ idx_all,             // [B, k]
           int* __restrict__ count_all,           // [B] compacted length
           long long* __restrict__ trace,         // [B * C, 3] or null: SM, start, end (ns)
           int N, int k, int cap) {
    extern __shared__ float4 pts_s[];             // [cap] x, y, z, running minimum
    __shared__ Shared sh;
    cg::cluster_group cluster = cg::this_cluster();
    const int C = (int)cluster.num_blocks();
    const int rank = (int)cluster.block_rank();
    const int b = blockIdx.x / C;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const float* __restrict__ pts = pts_all + (size_t)b * N * 3;
    float4* comp = comp_all + (size_t)b * N;
    float* mind = mind_all + (size_t)b * N;
    int* idx = idx_all + (size_t)b * k;
    if (trace != nullptr && tid == 0) trace[3 * blockIdx.x + 1] = globaltimer();

    // ---- phase 1: compaction -------------------------------------------
    const int chunk = (N + C - 1) / C;
    const int lo = min(N, rank * chunk), hi = min(N, lo + chunk);
    int count = 0, zmin = INT_MAX;
    for (int i = lo + tid; i < hi; i += THREADS) {
        const float* r = pts + 3 * (size_t)i;
        const bool zero = all_zero(r[0], r[1], r[2]);
        if (zero) zmin = min(zmin, i);
        if (i == 0 || !zero) ++count;
    }
    count = __reduce_add_sync(FULL, count);
    zmin = __reduce_min_sync(FULL, zmin);
    if (lane == 0) {
        sh.scan[warp] = count;
        sh.red_idx[warp] = zmin;
    }
    __syncthreads();
    if (warp == 0) {
        count = __reduce_add_sync(FULL, sh.scan[lane]);
        zmin = __reduce_min_sync(FULL, sh.red_idx[lane]);
        if (lane == 0) {
            sh.count = count;
            sh.zero_min = zmin;
        }
    }
    cluster.sync();
    if (warp == 0) {
        int c = 0, z = INT_MAX;
        if (lane < C) {
            const Shared* other = cluster.map_shared_rank(&sh, lane);
            c = other->count;
            z = other->zero_min;
        }
        z = __reduce_min_sync(FULL, z);
        // the row's lowest all-zero point is kept beside index 0 (unless it is 0)
        const int rep = (z != INT_MAX && z > 0) ? z : -1;
        const int before = __reduce_add_sync(FULL, lane < rank ? c : 0);
        const int total = __reduce_add_sync(FULL, c);
        if (lane == 0) {
            sh.offset = before + ((rep >= 0 && rep < lo) ? 1 : 0);
            sh.total = total + (rep >= 0 ? 1 : 0);
            sh.rep = rep;
        }
    }
    __syncthreads();
    const int rep = sh.rep;
    int out = sh.offset;
    for (int i0 = lo; i0 < hi; i0 += THREADS) {
        const int i = i0 + tid;
        bool keep = false;
        float x = 0.0f, y = 0.0f, z = 0.0f;
        if (i < hi) {
            const float* r = pts + 3 * (size_t)i;
            x = r[0];
            y = r[1];
            z = r[2];
            keep = i == 0 || i == rep || !all_zero(x, y, z);
        }
        const unsigned ballot = __ballot_sync(FULL, keep);
        if (lane == 0) sh.scan[warp] = __popc(ballot);
        __syncthreads();
        int before = 0, tile = 0;
        for (int w = 0; w < WARPS; ++w) {
            const int c = sh.scan[w];
            before += w < warp ? c : 0;
            tile += c;
        }
        if (keep)
            comp[out + before + __popc(ballot & ((1u << lane) - 1u))] =
                make_float4(x, y, z, __int_as_float(i));
        out += tile;
        __syncthreads();
    }
    __threadfence();
    cluster.sync();                               // the compacted row is complete

    // ---- phase 2: this CTA's share on chip -------------------------------
    const int M = sh.total;
    const int share = (M + C - 1) / C;
    const int start = min(M, rank * share);
    const int n_all = min(M, start + share) - start;
    const int n_chip = min(n_all, cap);
    for (int l = tid; l < n_chip; l += THREADS) {
        float4 p = comp[start + l];
        p.w = CUDART_INF_F;
        pts_s[l] = p;
    }
    for (int l = n_chip + tid; l < n_all; l += THREADS) mind[start + l] = CUDART_INF_F;
    if (rank == 0 && tid == 0) {
        idx[0] = 0;                               // position 0 is original index 0
        count_all[b] = M;
    }
    float4 q = comp[0];
    __syncthreads();

    // ---- phase 3: the k - 1 iterations -----------------------------------
    for (int it = 1; it < k; ++it) {
        float best = -CUDART_INF_F;
        int bi = INT_MAX;
        for (int l = tid; l < n_chip; l += THREADS) {
            const float4 p = pts_s[l];
            const float m = fminf(p.w, sqdist(p, q));
            pts_s[l].w = m;
            if (m > best) {
                best = m;
                bi = start + l;
            }
        }
        for (int l = n_chip + tid; l < n_all; l += THREADS) {
            const int g = start + l;
            const float m = fminf(mind[g], sqdist(comp[g], q));
            mind[g] = m;
            if (m > best) {
                best = m;
                bi = g;
            }
        }
        warp_argmax(best, bi);
        if (lane == 0) {
            sh.red_val[warp] = best;
            sh.red_idx[warp] = bi;
        }
        __syncthreads();
        const int par = it & 1;
        if (warp == 0) {
            best = sh.red_val[lane];
            bi = sh.red_idx[lane];
            warp_argmax(best, bi);
            if (lane == 0) {
                sh.pair_val[par] = best;
                sh.pair_idx[par] = bi;
            }
        }
        cluster.sync();
        if (warp == 0) {
            best = -CUDART_INF_F;
            bi = INT_MAX;
            if (lane < C) {
                const Shared* other = cluster.map_shared_rank(&sh, lane);
                best = other->pair_val[par];
                bi = other->pair_idx[par];
            }
            warp_argmax(best, bi);
            if (lane == 0) {
                const int owner = bi / share, local = bi - owner * share;
                float4 p;
                if (local < cap) {
                    // x, y, z only: the owner may be writing the minimum (w)
                    const float* r = reinterpret_cast<const float*>(
                        cluster.map_shared_rank(&pts_s[local], owner));
                    p = make_float4(r[0], r[1], r[2], 0.0f);
                } else {
                    p = comp[bi];
                }
                sh.query = p;
                if (rank == 0) idx[it] = bi;
            }
        }
        __syncthreads();
        q = sh.query;
    }
    cluster.sync();         // no CTA leaves while another may read its shared memory
    if (rank == 0)
        for (int j = tid; j < k; j += THREADS) idx[j] = __float_as_int(comp[idx[j]].w);
    if (trace != nullptr && tid == 0) {
        trace[3 * blockIdx.x] = smid();
        trace[3 * blockIdx.x + 2] = globaltimer();
    }
}

cudaLaunchConfig_t config(int B, int C, int smem, cudaStream_t stream,
                          cudaLaunchAttribute* attr) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(B * C);
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    attr->id = cudaLaunchAttributeClusterDimension;
    attr->val.clusterDim.x = C;
    attr->val.clusterDim.y = 1;
    attr->val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cfg;
}

}  // namespace

extern "C" {

// Indices [B, k] of the farthest-point samples of B rows of N points
// ([B, N, 3] f32) on `stream`, and the compacted length of each row
// (`counts`, [B] i32); `comp` is [B, N] float4 and `mind` [B, N] f32
// scratch; a row runs on `cluster` CTAs, each with `cap` points of its
// share in shared memory (16 * cap dynamic bytes).  A non-null `trace`
// ([B * cluster, 3] i64) receives each CTA's SM and its start and end on the
// card's global timer (ns).  Returns the CUDA error of the launch (0 when it
// was accepted).
int fps_launch(const float* pts, void* comp, float* mind, int* idx, int* counts,
               void* trace, int B, int N, int k, int cluster, int cap, void* stream) {
    if (cluster < 1 || cluster > MAX_CLUSTER) return (int)cudaErrorInvalidValue;
    const int smem = 16 * cap;
    cudaError_t err = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(&fps_kernel),
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg = config(B, cluster, smem, (cudaStream_t)stream, &attr);
    err = cudaLaunchKernelEx(&cfg, fps_kernel, pts, static_cast<float4*>(comp), mind,
                             idx, counts, static_cast<long long*>(trace), N, k, cap);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

// How many clusters of `cluster` CTAs of this kernel can be resident at once
// with `cap` points of shared memory a CTA (cudaOccupancyMaxActiveClusters).
int fps_max_active_clusters(int cluster, int cap, int* clusters) {
    if (cluster < 1 || cluster > MAX_CLUSTER) return (int)cudaErrorInvalidValue;
    const int smem = 16 * cap;
    cudaError_t err = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(&fps_kernel),
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg = config(1, cluster, smem, 0, &attr);
    return (int)cudaOccupancyMaxActiveClusters(
        clusters, reinterpret_cast<const void*>(&fps_kernel), &cfg);
}

}  // extern "C"
