// Sphere-tracing depth camera (kernel B2), CUDA C++ for sm_90a.
//
// Replaces the TPU Pallas kernel of partmanip_tpu/ops/raymarch_tpu.py
// (_march_kernel, launched by _render_tpu, entry render_depth_tpu) and
// computes what partmanip_tpu_torch/ops/raymarch.py:march_plain computes, its
// plain PyTorch version: every ray starts at its t0 and advances by the scene
// SDF along the unit ray (converted to z-depth) until the SDF falls below eps
// or the depth passes far, for at most n_steps steps; a final evaluation
// decides hit (depth) or miss (far).  The scene is R robot spheres, G oriented
// boxes (box_mask 0 = absent) and the z = 0 ground plane.
//
// Design.  One thread per ray; blockIdx.z is the env, blockIdx.y the view, so
// one block reads one env's primitives into shared memory once and every
// thread of the block then reads them as broadcasts.  A ray leaves its loop
// as soon as it is done: a done ray never moves again in the plain version
// (its depth is held by a where), so the early exit changes no result; it
// replaces the TPU kernel's whole-tile early-out.  The TPU kernel's
// per-tile cone culling is not done: it only skips primitives, and the
// minimum over primitives does not depend on which are skipped.  Coarse to
// fine is two launches of this kernel (a quarter-resolution pass and a
// full-resolution refine from per-ray start depths); the wrapper does the
// min filter and the upsampling in between.
//
// What bounds it on an H100: f32 operations.  Per ray and step: the point
// (6), each sphere (11), each live box (54: 53 arithmetic operations and the
// mask test; the sign flips are operand modifiers), the ground and the
// update; device memory is read once per ray (3 floats of direction, one
// start depth) and written once.
//
// Numerics.  Built with -fmad=false and without -use_fast_math, and written
// in the plain version's order of operations (the box distance in the
// component form of the TPU kernel, 1/sqrt for the ray's inverse length,
// IEEE sqrt and division), so that each operation rounds as it does in
// PyTorch.

#include <cuda_runtime.h>

namespace {

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
        const float* c = sph + 4 * s;
        const float rx = px - c[0];
        const float ry = py - c[1];
        const float rz = pz - c[2];
        const float ds = sqrtf(rx * rx + ry * ry + rz * rz) - c[3];
        dist = fminf(dist, ds);
    }
    for (int g = 0; g < G; ++g) {
        const float* b = box + 11 * g;
        if (!(b[10] > 0.0f)) continue;            // box_mask
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

__global__ void march_kernel(const float* __restrict__ sph_all,
                             const float* __restrict__ box_all,
                             const float* __restrict__ dirs,     // [V, 3, N]
                             const float* __restrict__ origins,  // [V, 3]
                             const float* __restrict__ t0,       // [E, V, N] or null
                             float t0_const, float* __restrict__ out,  // [E, V, N]
                             int V, int N, int S, int G, int n_steps, float far,
                             float eps, float hit_eps, int ground) {
    extern __shared__ float sh[];
    float* sph = sh;                 // [S, 4]
    float* box = sh + 4 * S;         // [G, 11]
    const int e = blockIdx.z;
    const int v = blockIdx.y;
    for (int i = threadIdx.x; i < 4 * S; i += blockDim.x)
        sph[i] = sph_all[(size_t)e * 4 * S + i];
    for (int i = threadIdx.x; i < 11 * G; i += blockDim.x)
        box[i] = box_all[(size_t)e * 11 * G + i];
    __syncthreads();

    const int n = blockIdx.x * blockDim.x + threadIdx.x;
    if (n >= N) return;
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
    for (int i = 0; i < n_steps; ++i) {
        const float dist = scene_dist(r, tz, sph, S, box, G, ground);
        if (dist < eps || tz > far) break;
        tz = tz + fmaxf(dist, 0.0f) * inv;
    }
    const float dist = scene_dist(r, tz, sph, S, box, G, ground);
    out[o] = (dist < hit_eps && tz <= far) ? tz : far;
}

}  // namespace

extern "C" {

// One launch over E x V x N rays on `stream`.  Returns the CUDA error of the
// launch (0 when it was accepted).
int rm_launch(const float* sph, const float* box, const float* dirs,
              const float* origins, const float* t0, float t0_const, float* out,
              int E, int V, int N, int S, int G, int n_steps, float far, float eps,
              float hit_eps, int ground, int threads, void* stream) {
    dim3 grid((N + threads - 1) / threads, V, E);
    size_t shmem = sizeof(float) * (4 * (size_t)S + 11 * (size_t)G);
    march_kernel<<<grid, threads, shmem, (cudaStream_t)stream>>>(
        sph, box, dirs, origins, t0, t0_const, out, V, N, S, G, n_steps, far, eps,
        hit_eps, ground);
    return (int)cudaGetLastError();
}

}  // extern "C"
