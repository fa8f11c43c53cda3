"""The system under test: the port's runner built through its entry point
(``train_torch.build``) from the configuration's flags, the cell's flags
and the benchmark's seed, with its generated cabinets and SDF bakes in the
benchmark's cache."""

from __future__ import annotations

import os

from .registry import BENCH_DIR

CACHE = os.path.join(BENCH_DIR, "cache")
PROGRAM_ASSETS = os.path.join(CACHE, "assets")
REFERENCE_ASSETS = os.path.join(CACHE, "reference_assets")


def program_seed(seed: int) -> int:
    """The seed the program is given (its entry point seeds numpy, which
    takes 32 bits)."""
    return int(seed) % (2 ** 31)


def flags(run) -> list:
    """The configuration's flags then the cell's, as the entry point takes
    them (without the benchmark's seed and cache)."""
    return list(run.config["flags"]) + list(run.cell.get("flags", []))


def build(run, device: str = None):
    """(runner, merged config) of the cell, its env on ``device`` (default
    the run's), not yet initialised."""
    import train_torch
    argv = flags(run) + ["--seed", str(program_seed(run.seed)),
                         "--exp_name", f"bench_seed{program_seed(run.seed)}",
                         "--log.mode", "screen", "--task.asset.assetRoot", PROGRAM_ASSETS,
                         "--device", str(device or run.device)]
    return train_torch.build(argv)
