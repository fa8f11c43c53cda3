"""Lightweight profiling utilities (counterpart of
``partmanip_tpu/utils/profiler.py``).

``@TimeCounter`` decorates host-side functions and accumulates call counts
and wall time, reported at exit; ``TimeCounterSession`` is the
context-manager form.  For device-side profiling use :func:`trace`, a thin
wrapper over ``torch.profiler`` that writes a Chrome trace (the JAX
package's wraps ``jax.profiler``).
"""

from __future__ import annotations

import atexit
import functools
import os
import tempfile
import time
from collections import defaultdict
from contextlib import contextmanager

_STATS = defaultdict(lambda: [0, 0.0])  # name -> [calls, total_s]
_REPORT_REGISTERED = False


def _register_report():
    global _REPORT_REGISTERED
    if not _REPORT_REGISTERED:
        atexit.register(report)
        _REPORT_REGISTERED = True


def TimeCounter(fn):
    """Decorator accumulating wall time per call; reported at exit."""
    _register_report()

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            st = _STATS[fn.__qualname__]
            st[0] += 1
            st[1] += time.perf_counter() - t0

    return wrapper


@contextmanager
def TimeCounterSession(name: str):
    """``with TimeCounterSession('phase'):`` accumulator."""
    _register_report()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        st = _STATS[name]
        st[0] += 1
        st[1] += time.perf_counter() - t0


def report():
    if not _STATS:
        return
    print("\n===== TimeCounter report =====")
    for name, (calls, total) in sorted(_STATS.items(),
                                       key=lambda kv: -kv[1][1]):
        print(f"{name:<40} calls={calls:<8} total={total:8.3f}s "
              f"avg={total / max(calls, 1) * 1000:8.2f}ms")


def reset():
    _STATS.clear()


@contextmanager
def trace(log_dir: str = None):
    """Profile the block with ``torch.profiler`` (the CPU, and the card when
    one is present) and write ``<log_dir>/trace.json``, a Chrome trace
    (``chrome://tracing``, Perfetto).  ``log_dir`` defaults to
    ``partmanip_trace`` under the temporary directory.  Yields the
    profiler; its ``key_averages()`` are readable after the block."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "partmanip_trace")
    os.makedirs(log_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
