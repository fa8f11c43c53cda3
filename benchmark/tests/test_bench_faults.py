"""Each cell's check, driven on the CPU at a size a test run can hold, with
the harness's look for a card skipped: a sound run comes out correct, and
a run whose timed path is broken underneath comes out not correct, for
each fault the cell can have (``harness/faults.py``).  On
the CPU the program runs its plain physics and renderer, so the physics
and vision gaps of a sound run are 0 and its network gaps are the bf16
rounding of the policy, as on the card."""

import contextlib
import time

import pytest
import torch

from harness import cli, faults
from harness.registry import Registry

SMALL = {
    "drawer_pc_dagger.train": {"flags": ["--algo.num_envs", "16", "--im_scale", "8",
                                         "--algo.buf_size", "4"],
                               "params": {"check_steps": [4, 6], "rollout": [2, 4]}},
    "drawer_pc_dagger.eval": {"flags": ["--algo.num_envs", "2", "--im_scale", "8",
                                        "--task.maxEpisodeLength", "6"],
                              "params": {"check_ranges": [[1, 3], [4, 6]], "rollout": [1, 3, 3]}},
}


def tiny_run(cell, seed, fault=None):
    torch.set_num_threads(4)
    run = cli.Run(Registry(), cell, seed, 0.2, False, torch.device("cpu"))
    small = SMALL[cell]
    run.config = {**run.config, "flags": run.config["flags"] + small["flags"]}
    run.cell = {**run.cell, "params": {**run.cell["params"], **small.get("params", {})}}
    with faults.planted(run.cell["driver"], fault) if fault else contextlib.nullcontext():
        line, numbers, rows = cli.execute(run, time.perf_counter())
    return line, numbers


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_sound_run_is_correct(cell):
    line, numbers = tiny_run(cell, 2 ** 31 + 17)
    assert line["correct"], (line["checks"], numbers)
    assert list(line)[-1] == "checks" and line["checks"]


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_fault_is_not_correct(cell, fault):
    line, numbers = tiny_run(cell, 2 ** 31 + 17, fault)
    assert not line["correct"], (line["checks"], numbers)
