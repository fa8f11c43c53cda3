"""Make ``tests/golden_torch/dagger_loop_record.json``: ``Train/dagger_loss``
of iterations 1-50 of the JAX package's DAgger loop proof
``artifacts/tb/open_drawer_dagger/ceiling_r3_seed17/`` (normal_state MLP
student, teacher ``expert_r3c_seed389/model_16000.ckpt``, flags of
``scripts/pipeline_r3.sh ceiling``), read from its tfevents, for
``chip_smoke.py``'s ``dagger_loop`` phase (the card's host has no
``tensorboard``).

    python tests/golden_torch/make_dagger_record.py
"""

import json
import os

import numpy as np
from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
RUN = os.path.join("artifacts", "tb", "open_drawer_dagger", "ceiling_r3_seed17")
ITERATIONS = 50


def main():
    ea = EventAccumulator(os.path.join(ROOT, RUN), size_guidance={"scalars": 0})
    ea.Reload()
    loss = {e.step: float(e.value) for e in ea.Scalars("Train/dagger_loss")}
    succ = {e.step: float(e.value) for e in ea.Scalars("Val/succ_rate_max")}
    last = max(succ)
    curve = [loss[i] for i in range(1, ITERATIONS + 1)]
    record = {
        "run": RUN,
        "flags": "scripts/pipeline_r3.sh:68-80 (ceiling): --taskcfg open_drawer "
                 "--algocfg dagger --algo.obs_mode normal_state "
                 "--algo.model.network.name MLP --algo.num_envs 1024 --algo.buf_size 64 "
                 "--algo.minibatch_cap 2048 --algo.teacher "
                 "artifacts/open_drawer_ppo/expert_r3c_seed389/model_16000.ckpt, seed 17",
        "dagger_loss": {str(i): v for i, v in enumerate(curve, 1)},
        "dagger_loss_mean_41_50": float(np.mean(curve[40:50])),
        "iterations_in_run": max(loss),
        "val_succ_rate_max_last": {"iteration": last, "value": succ[last]},
    }
    with open(os.path.join(HERE, "dagger_loop_record.json"), "w") as f:
        json.dump(record, f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    main()
