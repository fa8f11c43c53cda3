// Sphere-tracing depth camera (kernel B2), CUDA C++ for sm_90a.
//
// Replaces the TPU Pallas kernel of partmanip_tpu/ops/raymarch_tpu.py
// (_march_kernel, launched by _render_tpu, entry render_depth_tpu) and
// computes what partmanip_tpu_torch/ops/raymarch.py:march_plain computes, its
// plain PyTorch version: every ray starts at its t0 and advances by the scene
// SDF along the unit ray (converted to z-depth) until the SDF falls below eps
// or the depth passes far, for at most n_steps steps; a final evaluation
// decides hit (depth) or miss (far).  The scene is R robot spheres, G oriented
// boxes and the z = 0 ground plane; the SDF of a ray is the minimum over the
// primitives its 32x32-pixel tile keeps (mask [E, V, T, S + G], the TPU
// kernel's per-tile cone culling, raymarch.prim_masks) and the ground, which
// is never culled.  Culling changes the result: a primitive the ray never
// hits still shortens its steps, so the mask is part of the function.
//
// Design.  One thread block of 32 x 32 threads per (env, view, tile):
// blockIdx.z is the env, blockIdx.y the view, blockIdx.x the tile,
// threadIdx.x the pixel column and threadIdx.y the row within the tile; the
// output stays row-major.  Warp 0 compacts the tile's kept spheres and warp
// 1 its kept boxes into shared memory (a ballot and a prefix count per 32
// primitives), so the loop over primitives has a bound that is the same for
// every thread of the block and no per-primitive test; threads outside a
// ragged tile return after that.
// Each ray leaves its loop as soon as it is done: a done ray never moves
// again in the plain version (its depth is held by a where), so the early
// exit changes no result; it replaces the TPU kernel's whole-tile early-out.
// Coarse to fine is two launches of this kernel (a quarter-resolution pass
// and a full-resolution refine from per-ray start depths, each with the
// tiles and masks of its own resolution); the wrapper does the min filter
// and the upsampling in between.
//
// What bounds it on an H100: f32 operations.  Per ray and step: the point
// (6), each kept sphere (11), each kept box (53; the sign flips are operand
// modifiers), the ground and the update; device memory is read once per ray
// (3 floats of direction, one start depth) and written once.
//
// Numerics.  Built with -fmad=false and without -use_fast_math, and written
// in the plain version's order of operations (the box distance in the
// component form of the TPU kernel, 1/sqrt for the ray's inverse length,
// IEEE sqrt and division), so that each operation rounds as it does in
// PyTorch; the minimum over the kept primitives is exact in any order.

#include <cuda_runtime.h>

namespace {

constexpr int BLK = 32;            // tile edge in pixels
constexpr int SPH = 4;             // kept sphere: centre, radius
constexpr int BOX = 10;            // kept box: position, quaternion (xyzw), half extents
constexpr unsigned FULL = 0xffffffffu;

struct Ray {
    float ox, oy, oz, dx, dy, dz;
};

__device__ __forceinline__ float scene_dist(const Ray& r, float tz,
                                            const float* __restrict__ sph, int S,
                                            const float* __restrict__ box, int G,
                                            int ground) {
    const float px = r.ox + tz * r.dx;
    const float py = r.oy + tz * r.dy;
    const float pz = r.oz + tz * r.dz;
    float dist = 1e6f;
    for (int s = 0; s < S; ++s) {
        const float* c = sph + SPH * s;
        const float rx = px - c[0];
        const float ry = py - c[1];
        const float rz = pz - c[2];
        const float ds = sqrtf(rx * rx + ry * ry + rz * rz) - c[3];
        dist = fminf(dist, ds);
    }
    for (int g = 0; g < G; ++g) {
        const float* b = box + BOX * g;
        const float qx = b[3], qy = b[4], qz = b[5], qw = b[6];
        const float rx = px - b[0];
        const float ry = py - b[1];
        const float rz = pz - b[2];
        // conjugate-quaternion rotation into the box frame
        const float tx = 2.0f * (-qy * rz + qz * ry);
        const float ty = 2.0f * (-qz * rx + qx * rz);
        const float tz2 = 2.0f * (-qx * ry + qy * rx);
        const float lx = rx + qw * tx + (-qy * tz2 + qz * ty);
        const float ly = ry + qw * ty + (-qz * tx + qx * tz2);
        const float lz = rz + qw * tz2 + (-qx * ty + qy * tx);
        const float ax = fabsf(lx) - b[7];
        const float ay = fabsf(ly) - b[8];
        const float az = fabsf(lz) - b[9];
        const float ox = fmaxf(ax, 0.0f);
        const float oy = fmaxf(ay, 0.0f);
        const float oz = fmaxf(az, 0.0f);
        const float d_out = sqrtf(ox * ox + oy * oy + oz * oz);
        const float d_in = fminf(fmaxf(fmaxf(ax, ay), az), 0.0f);
        dist = fminf(dist, d_out + d_in);
    }
    if (ground) dist = fminf(dist, pz);
    return dist;
}

// One warp copies the kept rows of src ([n, stride] floats, the first
// `width` of each row) to dst ([kept, width]) in index order; returns the
// number kept (in every lane).
__device__ __forceinline__ int compact(const float* __restrict__ src, int stride,
                                       int width, const unsigned char* __restrict__ keep,
                                       int n, float* __restrict__ dst, int lane) {
    int count = 0;
    for (int base = 0; base < n; base += 32) {
        const int i = base + lane;
        const bool k = i < n && keep[i] != 0;
        const unsigned ballot = __ballot_sync(FULL, k);
        if (k) {
            float* d = dst + width * (count + __popc(ballot & ((1u << lane) - 1u)));
            for (int c = 0; c < width; ++c) d[c] = src[(size_t)stride * i + c];
        }
        count += __popc(ballot);
    }
    return count;
}

__global__ void __launch_bounds__(1024)
march_kernel(const float* __restrict__ sph_all,        // [E, S, 4]
             const float* __restrict__ box_all,        // [E, G, 11]
             const unsigned char* __restrict__ mask,   // [E, V, T, S + G]
             const float* __restrict__ dirs,           // [V, 3, H * W]
             const float* __restrict__ origins,        // [V, 3]
             const float* __restrict__ t0,             // [E, V, H * W] or null
             float t0_const, float* __restrict__ out,  // [E, V, H * W]
             int V, int H, int W, int T, int S, int G, int n_steps, float far,
             float eps, float hit_eps, int ground) {
    extern __shared__ float sh[];
    float* sph = sh;                 // [kept spheres, 4]
    float* box = sh + SPH * S;       // [kept boxes, 10]
    __shared__ int kept[2];
    const int t = blockIdx.x;
    const int v = blockIdx.y;
    const int e = blockIdx.z;
    const int tid = threadIdx.y * BLK + threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const unsigned char* m = mask + (((size_t)e * V + v) * T + t) * (S + G);
    if (warp == 0)
        kept[0] = compact(sph_all + (size_t)e * 4 * S, 4, SPH, m, S, sph, lane);
    else if (warp == 1)
        kept[1] = compact(box_all + (size_t)e * 11 * G, 11, BOX, m + S, G, box, lane);
    __syncthreads();

    const int nbw = (W + BLK - 1) / BLK;
    const int i = (t / nbw) * BLK + threadIdx.y;
    const int j = (t % nbw) * BLK + threadIdx.x;
    if (i >= H || j >= W) return;
    const int n_sph = kept[0], n_box = kept[1];
    const size_t N = (size_t)H * W;
    const size_t n = (size_t)i * W + j;
    Ray r;
    r.ox = origins[3 * v + 0];
    r.oy = origins[3 * v + 1];
    r.oz = origins[3 * v + 2];
    r.dx = dirs[((size_t)v * 3 + 0) * N + n];
    r.dy = dirs[((size_t)v * 3 + 1) * N + n];
    r.dz = dirs[((size_t)v * 3 + 2) * N + n];
    const float inv = 1.0f / sqrtf(r.dx * r.dx + r.dy * r.dy + r.dz * r.dz);
    const size_t o = ((size_t)e * V + v) * N + n;
    float tz = t0 ? t0[o] : t0_const;
    for (int it = 0; it < n_steps; ++it) {
        const float dist = scene_dist(r, tz, sph, n_sph, box, n_box, ground);
        if (dist < eps || tz > far) break;
        tz = tz + fmaxf(dist, 0.0f) * inv;
    }
    const float dist = scene_dist(r, tz, sph, n_sph, box, n_box, ground);
    out[o] = (dist < hit_eps && tz <= far) ? tz : far;
}

}  // namespace

extern "C" {

// One launch over E x V x T tiles of an H x W image on `stream`.  Returns
// the CUDA error of the launch (0 when it was accepted).
int rm_launch(const float* sph, const float* box, const unsigned char* mask,
              const float* dirs, const float* origins, const float* t0, float t0_const,
              float* out, int E, int V, int H, int W, int T, int S, int G, int n_steps,
              float far, float eps, float hit_eps, int ground, void* stream) {
    dim3 grid(T, V, E);
    dim3 block(BLK, BLK);
    size_t shmem = sizeof(float) * (SPH * (size_t)S + BOX * (size_t)G);
    march_kernel<<<grid, block, shmem, (cudaStream_t)stream>>>(
        sph, box, mask, dirs, origins, t0, t0_const, out, V, H, W, T, S, G, n_steps,
        far, eps, hit_eps, ground);
    return (int)cudaGetLastError();
}

}  // extern "C"
