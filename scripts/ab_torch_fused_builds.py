"""Kernel B1's default builds (B1a, B1b, B1c, B1d) of this checkout against
those of another checkout, on the card: what nvcc makes of each source (the
ptxas registers and spills, the ``cuobjdump -sass`` digest, each source
compiled ``--repeat`` times, as ptxas need not give the same code twice),
and whether the two builds give the same bits on ``chip_smoke.py``'s
``kernel_check`` states (its rollout and contact cases at 2048 envs, B1d's
on the calibration scene, one physics step in one launch).

Run from the root of this checkout, the other one unpacked beside it:

    python scripts/ab_torch_fused_builds.py --other build/parent [--repeat 2]

Prints one JSON line per variant; exits 1 when a variant's bits differ.
"""
import argparse
import hashlib
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch


def _sass_digest(lib_path):
    """md5 of ``cuobjdump -sass`` of a built library (None without cuobjdump)."""
    from partmanip_tpu_torch.utils import cuda_lib
    objdump = os.path.join(os.path.dirname(os.path.realpath(cuda_lib.find_nvcc())), "cuobjdump")
    if not os.path.exists(objdump):
        return None
    out = subprocess.run([objdump, "-sass", lib_path], capture_output=True, text=True)
    if out.returncode != 0:
        return None
    return hashlib.md5(out.stdout.encode()).hexdigest()[:12]


def _builds(lib, tag, repeat):
    """Compile ``lib`` ``repeat`` times under new names; their libraries
    (the first one is loaded), ptxas lines and SASS digests."""
    from partmanip_tpu_torch.utils import cuda_lib
    libs = [cuda_lib.Library(lib.name, lib.source,
                             f"ab_{tag}_{r}_" + os.path.basename(lib.path),
                             lib.signatures, defines=lib.defines) for r in range(repeat)]
    procs = [b.start() for b in libs]
    reports = [b.finish(proc) for b, proc in zip(libs, procs)]
    return libs, [{"ptxas": cuda_lib.ptxas_lines(rep), "sass": _sass_digest(b.path)}
                  for b, rep in zip(libs, reports)]


@torch.no_grad()
def main(argv=None):
    import chip_smoke
    from partmanip_tpu_torch.sim import fused
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", required=True, help="root of the other checkout")
    ap.add_argument("--repeat", type=int, default=2)
    args = ap.parse_args(argv)
    other_csrc = os.path.join(os.path.abspath(args.other), "partmanip_tpu_torch", "csrc")
    envs = chip_smoke.make_envs()
    renv, rstate, ctrl = chip_smoke.robot_only_env(chip_smoke.NUM_ENVS)
    runs = [(path, env, lambda path=path, env=env, cfg=cfg: chip_smoke.check_cases(path, env, cfg))
            for path, (env, cfg) in zip(chip_smoke.PATHS, envs)]
    runs.append((chip_smoke.B1D_PATH, renv,
                 lambda: chip_smoke.robot_only_cases(renv, rstate, ctrl)))
    same_all = True
    for path, env, make_cases in runs:
        scene = env.scene
        mine = fused.scene_library(scene)
        other = type(mine)(mine.name, os.path.join(other_csrc, os.path.basename(mine.source)),
                           os.path.basename(mine.path), mine.signatures, defines=mine.defines)
        mine_libs, mine_info = _builds(mine, "this", args.repeat)
        other_libs, other_info = _builds(other, "other", args.repeat)
        cases = make_cases()
        p = scene.params
        n = p.substeps * p.inner_substeps
        outs = {}
        orig = fused.library
        for side, lib in (("this", mine_libs[0]), ("other", other_libs[0])):
            fused.library = lambda *a, lib=lib, **k: lib
            try:
                outs[side] = {name: fused.launch_packed(scene, *fused.pack_state(*case), n)
                              for name, case in cases.items()}
            finally:
                fused.library = orig
        torch.cuda.synchronize()
        same = {name: all(torch.equal(a, b) for a, b in zip(outs["this"][name],
                                                             outs["other"][name]))
                for name in cases}
        same_all &= all(same.values())
        print(json.dumps({"variant": path.kernel, "defines": dict(mine.defines),
                          "this": mine_info, "other": other_info,
                          "bits_equal": same, "n_steps": n, "num_envs": env.num_envs}),
              flush=True)
    print(chip_smoke.nvidia_smi_line(), flush=True)
    return 0 if same_all else 1


if __name__ == "__main__":
    sys.exit(main())
