"""Where one env's time goes in kernels B1b / B1c (a warp per env,
``partmanip_tpu_torch/csrc/fused_inner_step_obj.cu``) and B1a (two envs a
warp, ``partmanip_tpu_torch/csrc/fused_inner_step.cu``), and where and when
each env's warp ran.

Builds the kernel's ``FIS_PHASES`` library beside the default one (the same
source with clock reads between the phases of the inner step) and launches
it through ``sim/fused.launch_packed`` on the rollout state of
``chip_smoke.py``'s path (B1b / B1c: the expert's 40 steps, B1a: 20 steps
of the random policy), at 2048 envs and at the fewest envs of
``chip_smoke.SWEEP_ENVS`` (the state's columns repeated as
``chip_smoke.py``'s env sweep makes them), with the main path's inner steps
per launch.  Prints one JSON line per (kernel, envs): the mean over envs of
one env's SM clock cycles per phase, and the placement its warps wrote (the
distinct SMs, the waves — a warp that starts after another has ended is a
wave later than it — and the most warps running at once; B1a's rows are
envs, two a warp, so there it counts envs), beside the
occupancy query and the ``ptxas`` lines of both builds, which say whether
the instrumented build places its blocks as the default one does.

    python3 scripts/prof_torch_fused_phases.py [--kernel b1b b1c b1a]
"""
import argparse
import ctypes
import json
import os
import shutil
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# the phases of the inner step, in the order of the kernel's PHASE(i) marks:
# B1b / B1c, then B1a
PHASE_NAMES = ("trees_fk", "robot_mass", "object_mass", "poses_and_spheres",
               "sphere_jacobians_and_pass_a", "pass_b", "jt_n_j", "tree_solves")
PHASE_NAMES_B1A = ("fk", "mass_matrix", "spheres_and_pass_a", "pass_b", "free_body",
                   "jt_n_j", "solves")


def phases_library(lib):
    """``lib`` (a fused inner-step library) built with ``FIS_PHASES``."""
    from partmanip_tpu_torch.utils import cuda_lib
    sig = dict(lib.signatures, fis_set_phase_buffer=((ctypes.c_void_p,), ctypes.c_int))
    return cuda_lib.Library(lib.name, lib.source,
                            os.path.basename(lib.path).replace(".so", "_phases.so"), sig,
                            defines=list(lib.defines) + [("FIS_PHASES", 1)],
                            extra_flags=lib.extra_flags)


def placement(sm, start, end):
    wave = {}
    for i in sorted(range(len(start)), key=start.__getitem__):
        wave[i] = 1 + max((wave[j] for j in wave if end[j] <= start[i]), default=0)
    events = sorted([(t, 1) for t in start] + [(t, -1) for t in end], key=lambda x: (x[0], x[1]))
    running = most = 0
    for _, d in events:
        running += d
        most = max(most, running)
    return {"sms_used": len(set(sm)), "waves": max(wave.values()), "warps_at_once": most,
            "span_us": (max(end) - min(start)) / 1e3}


@torch.no_grad()
def profile(scene, buf, anc_b, n, lib, names):
    """One launch of the phase build: {phase: mean cycles} and placement."""
    from partmanip_tpu_torch.sim import fused
    E = buf.shape[1]
    out = torch.zeros((E, len(names) + 3), dtype=torch.int64, device=buf.device)
    err = lib.load().fis_set_phase_buffer(out.data_ptr())
    if err != 0:
        raise RuntimeError(f"fis_set_phase_buffer failed: CUDA error {err}")
    fused.launch_packed(scene, buf, anc_b, n)
    torch.cuda.synchronize()
    cycles = out[:, :len(names)].double().mean(0).tolist()
    sm, start, end = out[:, len(names):].cpu().T.tolist()
    return {"cycles_per_env_by_phase": dict(zip(names, cycles)),
            "cycles_per_env": sum(cycles), "placement": placement(sm, start, end)}


@torch.no_grad()
def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--kernel", nargs="+", default=["b1b", "b1c"], choices=["b1a", "b1b", "b1c"])
    args = ap.parse_args()
    import chip_smoke
    from partmanip_tpu_torch.sim import fused
    from partmanip_tpu_torch.utils import cuda_lib
    print(chip_smoke.nvidia_smi_line(), flush=True)
    default_library = fused.library
    for kind in args.kernel:
        path = next(p for p in chip_smoke.PATHS if p.kernel == kind)
        if kind == "b1c":
            shutil.rmtree(chip_smoke.MESH_ASSETS, ignore_errors=True)
        env, cfg = chip_smoke.make_env(path, chip_smoke.NUM_ENVS)
        sim, targets = chip_smoke.check_cases(path, env, cfg)[f"rollout{path.rollout_steps}"]
        dims = fused._dims(env.scene)
        libs = [default_library(kind, dims)]
        libs.append(phases_library(libs[0]))
        reports = [lib.finish(lib.start()) for lib in libs]
        occupancy = []
        for lib in libs:
            blocks = ctypes.c_int(0)
            cuda_lib.check_launch(lib.load().fis_occupancy(ctypes.byref(blocks)), "occupancy")
            occupancy.append(blocks.value)
        fused.library = lambda variant, d: phases_library(default_library(variant, d))
        try:
            p = env.scene.params
            n = p.substeps * p.inner_substeps
            buf, anc_b = fused.pack_state(sim, targets)
            keep = []
            for E in (buf.shape[1], chip_smoke.SWEEP_ENVS[0]):
                idx = torch.arange(E, device=buf.device) % buf.shape[1]
                scene_e = chip_smoke.repeat_envs(env.scene, idx)
                keep.append(scene_e)
                buf_e, anc_e = buf[:, idx].contiguous(), anc_b[:, idx].contiguous()
                names = PHASE_NAMES_B1A if kind == "b1a" else PHASE_NAMES
                profile(scene_e, buf_e, anc_e, n, libs[1], names)   # warm-up
                row = profile(scene_e, buf_e, anc_e, n, libs[1], names)
                print(json.dumps({"kernel": kind, "num_envs": E, "n_steps": n, **row,
                                  "launch_config": fused.launch_config(E, dims),
                                  "blocks_per_sm": {"default": occupancy[0],
                                                    "phases": occupancy[1]},
                                  "ptxas": {"default": cuda_lib.ptxas_lines(reports[0]),
                                            "phases": cuda_lib.ptxas_lines(reports[1])}}),
                      flush=True)
        finally:
            fused.library = default_library


if __name__ == "__main__":
    main()
