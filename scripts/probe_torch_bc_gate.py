"""The BC gate of ``chip_smoke.py``'s ``tsdf_student`` phase, probed on the
GPU: one demo episode of the committed open_drawer expert (16 envs,
mesh_tsdf, only the successful envs), then BC at bc.yaml's widths for 6 and
7 iterations under cuDNN's deterministic algorithms, 7 again, and 7 with
cuDNN's default algorithms, each with its loss curve and whether the mean
of its last 3 iterations is at most half of iteration 1's; then the
phase's Conv3DNet card-vs-CPU check (f32, and the TF32 control) on 64 demo
rows.  One JSON line each.

    python3 scripts/probe_torch_bc_gate.py [--no-conv]     # needs a GPU
"""
import json
import os
import shutil
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import collect_demos_torch  # noqa: E402
import train_torch  # noqa: E402
from partmanip_tpu_torch.algos.bc import load_demo_tree  # noqa: E402

RUNS = ((True, 6), (True, 7), (True, 7), (False, 7))   # (deterministic, iterations)


def main():
    out = os.path.join(ROOT, "build", "probe_demos")
    shutil.rmtree(out, ignore_errors=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.time()
    collect_demos_torch.main(["--teacher", cs.DRAWER_CKPT, "--out", out, "--episodes", "1",
                              "--only_success", "--taskcfg", "open_drawer",
                              "--algo.num_envs", "16"])
    rows, _, acts = cs.check_demo_tree(out, 50, 10, 53, 0)
    print(json.dumps({"demos": rows, "s": time.time() - t0,
                      "const": float(acts.var(0).mean())}), flush=True)
    bc = None
    for det, K in RUNS:
        torch.backends.cudnn.deterministic = det
        t0 = time.time()
        bc = train_torch.main([
            "--taskcfg", "open_drawer", "--algocfg", "bc", "--algo.data_path", out,
            "--algo.max_iterations", str(K), "--algo.save_frequence", str(K),
            "--exp_name", "probe_bc_seed11", "--log.mode", "screen"])
        torch.cuda.synchronize()
        torch.backends.cudnn.deterministic = False
        loss = [log["Train/bc_loss"] for log in bc.train_logs]
        tail = float(np.mean(loss[-3:]))
        print(json.dumps({"deterministic": det, "K": K, "loss": loss, "tail": tail,
                          "gate": 0.5 * loss[0], "pass": tail <= 0.5 * loss[0],
                          "s_per_it": cs._median_after_first(bc.train_logs),
                          "wall": time.time() - t0}), flush=True)
    if "--no-conv" not in sys.argv:
        obs, _ = load_demo_tree(out, False)
        conv = cs.net_card_vs_cpu(torch.as_tensor(obs[:64]),
                                  dict(bc.model_cfg, action_std=0.1))
        print(json.dumps(conv), flush=True)
        print(json.dumps({"tf32_flag_after": torch.backends.cudnn.allow_tf32}))
    shutil.rmtree(out, ignore_errors=True)


if __name__ == "__main__":
    main()
