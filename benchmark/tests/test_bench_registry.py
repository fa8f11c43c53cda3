"""The harness finds configurations, cells, drivers and metric readers by
name, and a new one added as files and entries only."""

import json
import os
import re
import shutil

import pytest

from harness.registry import BENCH_DIR, ROOT, Registry

SPEC = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
CELLS = [w["name"] for w in SPEC["workloads"]]
DRIVER_API = ("setup", "window", "profile", "end_to_end", "release", "check")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_found_by_name(cell):
    reg = Registry()
    c = reg.cell(cell)
    cfg = reg.config(c["config"])
    assert cfg["flags"] and cfg["source"].startswith("https://")
    driver = reg.driver(c["driver"])
    assert all(callable(getattr(driver, f)) for f in DRIVER_API)
    per_layer = reg.per_layer(cell)
    assert per_layer and all(callable(reg.reader(m["name"]).read) for m in per_layer)
    e2e = {m["name"] for m in reg.end_to_end(cell)}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert {m["moves"] for m in per_layer} <= e2e


def test_unknown_cell_and_file():
    reg = Registry()
    with pytest.raises(KeyError):
        reg.cell("no_such.cell")
    with pytest.raises(KeyError):
        reg.reader("no_such_metric")


def test_new_files_found_without_editing(tmp_path):
    """A configuration, a cell, a driver and a metric added as new files
    and entries are found; no existing file changes."""
    bench = tmp_path / "benchmark"
    shutil.copytree(BENCH_DIR, bench, ignore=shutil.ignore_patterns("cache", "__pycache__"))
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    spec = json.loads(json.dumps(SPEC))
    (bench / "configs" / "new_cfg.json").write_text(json.dumps({"flags": ["--taskcfg", "grasp_cube"]}))
    (bench / "workloads" / "new_cfg.run.json").write_text(json.dumps({"driver": "new_kind", "params": {}}))
    (bench / "drivers" / "new_kind.py").write_text("def setup(run):\n    return 'new'\n")
    (bench / "metrics" / "new.metric_ms.py").write_text("def read(run):\n    return 4.0\n")
    spec["configs"].append({"name": "new_cfg", "source": "https://example.org/new",
                            "file": "benchmark/configs/new_cfg.json", "reduced": []})
    spec["workloads"].append({"name": "new_cfg.run", "config": "new_cfg", "traffic": "run",
                              "chips": 1, "why": "new"})
    spec["per_layer"].append({"name": "new.metric_ms", "unit": "ms", "better": "lower",
                              "source": "program_span", "layer": "env",
                              "moves": "setup_s", "workloads": ["new_cfg.run"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    reg = Registry(str(tmp_path / "BENCHMARK.json"), bench_dir=str(bench), root=str(tmp_path))
    cell = reg.cell("new_cfg.run")
    assert reg.config(cell["config"])["flags"] == ["--taskcfg", "grasp_cube"]
    assert reg.driver(cell["driver"]).setup(None) == "new"
    assert [m["name"] for m in reg.per_layer("new_cfg.run")] == ["new.metric_ms"]
    assert reg.reader("new.metric_ms").read(None) == 4.0
    assert all(p.read_bytes() == b for p, b in before.items())


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_shape():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"] and SPEC["command"][1] == "benchmark/run.py"
    n = len(SPEC["workloads"])
    assert 1 <= SPEC["run_seconds"] <= 51
    full = 24
    assert (2 + 14 * full) * (SPEC["run_seconds"] + 60) + full * 180 + 1200 <= 43200
    names = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in SPEC[group]:
            assert NAME.match(e["name"]) and e["name"] not in names
            names.add(e["name"])
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert "bound" not in m and m["moves"] in {e["name"] for e in SPEC["end_to_end"]}
    for w in SPEC["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert os.path.exists(os.path.join(BENCH_DIR, "workloads", f"{w['name']}.json"))
    assert sum(w["chips"] == 4 for w in SPEC["workloads"]) <= max(1, n // 4)
