// The FIS_PHASES instrumentation of the fused inner-step kernels
// (scripts/prof_torch_fused_phases.py builds it; the default build has
// none of it).  The lane that PHASES_END's `writer` names (one per env)
// adds up the SM clock cycles of each phase of the inner step (FIS_NPHASE of
// them, over all n_steps, marked by PHASE(i)) and writes them to a device
// buffer [E][FIS_NPHASE + 3] (fis_set_phase_buffer), followed by its SM and
// the env's start and end on the card's global timer (ns): where one env's
// latency goes, and where and when it ran.  The kernel defines FIS_NPHASE
// and names its env index e.

#pragma once

#include <cuda_runtime.h>

#ifdef FIS_PHASES
__device__ long long* g_phase_out;
__device__ __forceinline__ long long fis_globaltimer() {
    long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
}
__device__ __forceinline__ long long fis_smid() {
    unsigned id;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(id));
    return id;
}
#define PHASES_BEGIN \
    const long long ph_start = fis_globaltimer(); \
    long long ph_t0 = clock64(), ph_acc[FIS_NPHASE] = {};
#define PHASE(i) { const long long ph_t = clock64(); ph_acc[i] += ph_t - ph_t0; ph_t0 = ph_t; }
#define PHASES_END(writer) \
    if (writer) { \
        long long* ph_out = g_phase_out + (size_t)e * (FIS_NPHASE + 3); \
        for (int i = 0; i < FIS_NPHASE; ++i) ph_out[i] = ph_acc[i]; \
        ph_out[FIS_NPHASE] = fis_smid(); \
        ph_out[FIS_NPHASE + 1] = ph_start; \
        ph_out[FIS_NPHASE + 2] = fis_globaltimer(); \
    }

// Where the FIS_PHASES build writes its cycles and placement:
// [E][FIS_NPHASE + 3] i64.
extern "C" int fis_set_phase_buffer(void* buf) {
    return (int)cudaMemcpyToSymbol(g_phase_out, &buf, sizeof(buf));
}
#else
#define PHASES_BEGIN
#define PHASE(i)
#define PHASES_END(writer)
#endif
