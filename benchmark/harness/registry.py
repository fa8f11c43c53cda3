"""Find what a cell is made of by name: its entry in ``BENCHMARK.json``,
its configuration file, its traffic file (``workloads/<cell>.json``), the
driver of its traffic kind (``drivers/<kind>.py``) and the readers of its
per-layer metrics (``metrics/<metric>.py``).

Nothing here lists a configuration, a cell, a kind or a metric: a later
change adds one by adding its files and its entries in ``BENCHMARK.json``.
"""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Dict, List

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


class Registry:
    """The benchmark's description read from ``spec_path`` (default the
    checkout's ``BENCHMARK.json``); files are looked up under ``bench_dir``
    and configuration files relative to ``root``."""

    def __init__(self, spec_path: str = None, bench_dir: str = BENCH_DIR, root: str = ROOT):
        self.root, self.bench_dir = root, bench_dir
        with open(spec_path or os.path.join(root, "BENCHMARK.json")) as f:
            self.spec = json.load(f)
        self._modules: Dict[str, object] = {}

    # -- cells and configurations --------------------------------------

    def cell(self, name: str) -> dict:
        """The cell's ``BENCHMARK.json`` entry merged with its traffic file;
        raises ``KeyError`` for an unknown cell."""
        entries = {w["name"]: w for w in self.spec["workloads"]}
        if name not in entries:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json (has {sorted(entries)})")
        with open(os.path.join(self.bench_dir, "workloads", f"{name}.json")) as f:
            traffic = json.load(f)
        return {**traffic, **entries[name]}

    def config(self, name: str) -> dict:
        entries = {c["name"]: c for c in self.spec["configs"]}
        with open(os.path.join(self.root, entries[name]["file"])) as f:
            return {**json.load(f), "source": entries[name]["source"]}

    # -- metrics ---------------------------------------------------------

    def end_to_end(self, cell: str) -> List[dict]:
        """The end-to-end metrics the cell reports: those that list it, and
        those that list no cells."""
        return [m for m in self.spec["end_to_end"]
                if "workloads" not in m or cell in m["workloads"]]

    def per_layer(self, cell: str) -> List[dict]:
        """The per-layer metrics the cell reports: those that list it, and
        those without a list whose end-to-end metric the cell reports."""
        e2e = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.spec["per_layer"]
                if (cell in m["workloads"] if "workloads" in m else m["moves"] in e2e)]

    # -- code found by name ----------------------------------------------

    def _load(self, folder: str, name: str):
        path = os.path.join(self.bench_dir, folder, f"{name}.py")
        key = f"{folder}/{name}"
        if key not in self._modules:
            if not os.path.exists(path):
                raise KeyError(f"no {folder[:-1]} {name!r}: {path} does not exist")
            spec = importlib.util.spec_from_file_location(
                f"bench_{folder}_{name}".replace(".", "_"), path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            self._modules[key] = mod
        return self._modules[key]

    def driver(self, kind: str):
        """``drivers/<kind>.py``: ``setup``, ``window``, ``profile``,
        ``end_to_end``, ``release`` and ``check`` of one traffic kind."""
        return self._load("drivers", kind)

    def reader(self, metric: str):
        """``metrics/<metric>.py``: ``read(run)`` gives the metric's value
        from the traced run, or ``None`` where it finds nothing to read."""
        return self._load("metrics", metric)
