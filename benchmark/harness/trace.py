"""The benchmark's trace reader: ``torch.profiler`` over a short steady
part of a traced run, reduced to the device's busy time, the window's
length, device time by kernel name and the idle gaps by what the host was
doing.

The profiler's Chrome trace is written to a temporary file under
``TMPDIR``, read once and deleted.  Device activity is every kernel,
memcpy and memset; busy time is the union of their intervals inside the
window (an annotation ``bench.window`` around the profiled work, which
ends in a synchronise).  An idle gap is named by the innermost benchmark
span (``Spans`` annotation) open at its midpoint, else by the innermost
PyTorch operator, else ``host``.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Callable, Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "bench.window"


class Profile:
    """What one profiled window read: ``window_s``, ``busy_s``, device
    seconds and counts by kernel name, idle seconds by host activity."""

    def __init__(self, window_s: float, busy_s: float, by_name: Dict[str, float],
                 counts: Dict[str, int], idle: Dict[str, float], units: int):
        self.window_s, self.busy_s, self.units = window_s, busy_s, units
        self.by_name, self.counts, self.idle = by_name, counts, idle

    def device_s(self, fragment: str) -> float:
        """Device seconds of the kernels whose name holds ``fragment``."""
        return sum(v for k, v in self.by_name.items() if fragment in k)

    def launches(self, fragment: str) -> int:
        return sum(v for k, v in self.counts.items() if fragment in k)

    def breakdown(self) -> dict:
        top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
        return {"device_ops": top(self.by_name), "idle_gaps": top(self.idle)}


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _innermost(pool: List[Tuple[float, float, str]], points: List[float]) -> List[str]:
    """The name of the innermost interval of ``pool`` (intervals of one
    thread, nested or disjoint) open at each of the ascending ``points``,
    or ``None``."""
    pool = sorted(pool, key=lambda iv: (iv[0], -iv[1]))
    stack, out, i = [], [], 0
    for m in points:
        while i < len(pool) and pool[i][0] <= m:
            while stack and stack[-1][1] <= pool[i][0]:
                stack.pop()
            stack.append(pool[i])
            i += 1
        while stack and stack[-1][1] <= m:
            stack.pop()
        out.append(stack[-1][2] if stack else None)
    return out


def reduce_events(events: List[dict], units: int = 1) -> Profile:
    """A :class:`Profile` from Chrome-trace ``X`` events (times in us)."""
    win = [e for e in events if e.get("name") == WINDOW and e.get("ph") == "X"]
    if not win:
        raise ValueError(f"no {WINDOW} annotation in the trace")
    w0 = min(e["ts"] for e in win)
    w1 = max(e["ts"] + e["dur"] for e in win)
    tid = win[0].get("tid")
    dev, by_name, counts = [], {}, {}
    annotations, ops = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            a, b = max(a, w0), min(b, w1)
            if b <= a:
                continue
            dev.append((a, b))
            by_name[e["name"]] = by_name.get(e["name"], 0.0) + (b - a) * 1e-6
            counts[e["name"]] = counts.get(e["name"], 0) + 1
        elif e.get("tid") != tid:
            continue
        elif cat == "user_annotation" and e["name"] != WINDOW:
            annotations.append((a, b, e["name"]))
        elif cat == "cpu_op":
            ops.append((a, b, e["name"]))
    busy = _union(dev)
    busy_us = sum(b - a for a, b in busy)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    mids = [(a + b) / 2 for a, b in gaps]
    named = [_innermost(annotations, mids), _innermost(ops, mids)]
    idle: Dict[str, float] = {}
    for j, (a, b) in enumerate(gaps):
        name = named[0][j] or named[1][j] or "host"
        idle[name] = idle.get(name, 0.0) + (b - a) * 1e-6
    return Profile((w1 - w0) * 1e-6, busy_us * 1e-6, by_name, counts, idle, units)


def profile(fn: Callable[[], int]) -> Profile:
    """Run ``fn`` (which returns the units of work it did) under
    ``torch.profiler`` inside a ``bench.window`` annotation that ends in a
    synchronise, and reduce its trace."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    sync = lambda: None
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
        sync = torch.cuda.synchronize
    sync()
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW):
            units = fn()
            sync()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return reduce_events(events, units)
