"""One run of one cell: set-up, the measured window, the traced part (with
``--trace 1``), the check against the reference, and the result line.

The result is the last line of standard output, one JSON object with
``correct``, ``attempted``, ``failed``, ``metrics``, ``device``
(``breakdown`` with ``--trace 1``) and, last, ``checks``: each number the
check compared with its limit, which are also the last lines of standard
error.  The run exits non-zero with no result where the card is missing
or has fewer devices than the cell asks for, where a cell or one of its
files is unknown, and where JAX, flax or the JAX package is loaded once
the window has closed.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import sys
import time

FORBIDDEN = ("jax", "jaxlib", "flax", "partmanip_tpu")


def forbidden_modules(modules=None) -> list:
    """The loaded modules whose top-level name is one of :data:`FORBIDDEN`,
    compared whole (``partmanip_tpu_torch`` is not ``partmanip_tpu``)."""
    names = sys.modules if modules is None else modules
    return sorted({n for n in names if n.split(".")[0] in FORBIDDEN})


class Run:
    """What a driver and the metric readers share for one run."""

    def __init__(self, registry, workload: str, seed: int, seconds: float, trace: bool,
                 device):
        from .spans import Spans
        self.registry = registry
        self.name = workload
        self.cell = registry.cell(workload)
        self.config = registry.config(self.cell["config"])
        self.seed, self.seconds, self.trace, self.device = int(seed), float(seconds), trace, device
        self.spans = Spans()
        self.profile = None        # trace.Profile of the traced part
        self.window = {}           # seconds, units, attempted, failed, work counts
        self.work = {}             # counted least times, for the mfu and roofline readers
        self.limits = dict(self.cell.get("limits", {}))


def parse(argv):
    ap = argparse.ArgumentParser(description="Run one cell of the port's benchmark once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def result_line(run, correct, rows, metrics, device, breakdown=None) -> dict:
    line = {"correct": bool(correct),
            "attempted": int(run.window.get("attempted", 0)),
            "failed": int(run.window.get("failed", 0)),
            "metrics": metrics,
            "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = {name: {"value": value, "limit": limit} for name, value, limit in rows}
    return line


def main(argv=None, t_start=None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse(argv)
    import torch
    from .registry import Registry

    registry = Registry()
    try:
        cell = registry.cell(args.workload)
    except (KeyError, FileNotFoundError) as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    chips = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA device(s); "
              f"available={torch.cuda.is_available()}, "
              f"count={torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda:0")
    torch.cuda.set_device(device)
    run = Run(registry, args.workload, args.seed, args.seconds, bool(args.trace), device)
    line, numbers, rows = execute(run, t_start)

    loaded = forbidden_modules()
    if loaded:
        print(f"benchmark: modules that must not be loaded are loaded: {loaded}",
              file=sys.stderr)
        return 3
    ends = run.window.get("unit_ends", [])
    print(f"window {len(ends)} units, ends at (s): {[round(t, 4) for t in ends]}", file=sys.stderr)
    for name in sorted(numbers):
        if name not in run.limits:
            print(f"reading {name} = {numbers[name]!r}", file=sys.stderr)
    for name, value, limit in rows:
        print(f"check {name} = {value!r} (limit {limit!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


def sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def execute(run, t_start: float):
    """Set-up, window, traced part, check and metrics of ``run`` on its
    device (the tests drive it on the CPU).  Returns (result line, every
    number the check read, the compared rows)."""
    import torch
    from . import judge, trace as trace_lib
    registry = run.registry
    on_card = run.device.type == "cuda"
    driver = registry.driver(run.cell["driver"])

    state = driver.setup(run)
    sync(run.device)
    setup_s = time.perf_counter() - t_start

    driver.window(run, state)
    if run.trace:
        if hasattr(driver, "before_profile"):
            driver.before_profile(run, state)
        run.profile = trace_lib.profile(lambda: driver.profile(run, state))
    run.spans.unwrap()
    memory_peak = int(torch.cuda.max_memory_allocated(run.device)) if on_card else 0
    e2e = dict(driver.end_to_end(run, state), setup_s=setup_s)

    driver.release(run, state)
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    numbers = driver.check(run, state)
    correct, rows = judge.verdict(numbers, run.limits)

    if run.trace:
        metrics = {}
        for m in registry.per_layer(run.name):
            value = registry.reader(m["name"]).read(run)
            if value is not None and math.isfinite(value):
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": float(e2e[m["name"]]), "unit": m["unit"]}
                   for m in registry.end_to_end(run.name)}

    dev = {"platform": "gpu" if on_card else run.device.type,
           "kind": torch.cuda.get_device_name(run.device) if on_card else "cpu",
           "count": int(run.cell["chips"]), "memory_peak_bytes": memory_peak}
    breakdown = None
    if run.trace:
        dev.update(busy_s=run.profile.busy_s, window_s=run.profile.window_s)
        breakdown = run.profile.breakdown()
    return result_line(run, correct, rows, metrics, dev, breakdown), numbers, rows
