"""Host-clock spans around the program's layer entry points, installed by
the benchmark from its own files (the program records none of its own).

A span is the host time of one call: PyTorch returns before the device
has finished, so a span measures what the host spends in the layer
(launches, Python, any synchronisation the layer makes), not the device
work it queues.  Each wrapped call is also a ``torch.profiler``
annotation of the same name, so the device trace can say what the host
was doing during an idle gap.  Spans stay in memory; nothing is written.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Callable, Dict, List, Tuple


class Spans:
    """Named lists of (start, end) host-clock intervals, in seconds."""

    def __init__(self):
        self.spans: Dict[str, List[Tuple[float, float]]] = {}
        self._undo: List[Callable[[], None]] = []

    def add(self, name: str, t0: float, t1: float) -> None:
        self.spans.setdefault(name, []).append((t0, t1))

    def durations(self, name: str) -> List[float]:
        return [b - a for a, b in self.spans.get(name, [])]

    @contextmanager
    def span(self, name: str):
        import torch
        t0 = time.perf_counter()
        with torch.profiler.record_function(name):
            yield
        self.add(name, t0, time.perf_counter())

    def wrap(self, owner, attr: str, name: str) -> None:
        """Replace ``owner.attr`` (an object's or a module's) by a version
        that records a span ``name`` around each call, until :meth:`unwrap`."""
        fn = getattr(owner, attr)
        had_own = attr in vars(owner)

        def wrapped(*args, **kwargs):
            with self.span(name):
                return fn(*args, **kwargs)

        setattr(owner, attr, wrapped)
        self._undo.append(lambda: setattr(owner, attr, fn) if had_own
                          else delattr(owner, attr))

    def unwrap(self) -> None:
        while self._undo:
            self._undo.pop()()

    def self_ms(self, outer: str, inner: str) -> List[float]:
        """Each ``outer`` span's duration less the ``inner`` spans inside
        it, in ms."""
        inner_spans = self.spans.get(inner, [])
        out = []
        for a, b in self.spans.get(outer, []):
            covered = sum(min(b, d) - max(a, c) for c, d in inner_spans if c < b and d > a)
            out.append((b - a - covered) * 1e3)
        return out
