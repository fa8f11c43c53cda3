"""The result line's shape, and the runs that must end without one."""

import json
import os
import subprocess
import sys
import types


from harness import cli
from harness.registry import BENCH_DIR, ROOT


def test_result_line_keys_and_order():
    run = types.SimpleNamespace(window={"attempted": 5, "failed": 0})
    dev = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
           "memory_peak_bytes": 123}
    line = cli.result_line(run, True, [("loss.value", 1e-4, 1e-2)],
                           {"setup_s": {"value": 1.5, "unit": "s"}}, dev,
                           {"device_ops": [["k", 1.0]], "idle_gaps": [["env.step", 2.0]]})
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "breakdown",
                          "checks"]
    assert line["checks"] == {"loss.value": {"value": 1e-4, "limit": 1e-2}}
    assert json.loads(json.dumps(line)) == line


def _run(args, cwd):
    return subprocess.run([sys.executable, "benchmark/run.py", *args], cwd=cwd,
                          capture_output=True, text=True, timeout=120,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})


def test_no_card_no_result():
    r = _run(["--workload", "drawer_pc_dagger.train", "--seed", "2147483999",
              "--seconds", "1", "--trace", "0"], ROOT)
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_unknown_cell_no_result():
    r = _run(["--workload", "no_such.cell", "--seed", "1", "--seconds", "1", "--trace", "0"], ROOT)
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_bare_directory_no_result(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark's files."""
    import shutil
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("cache", "__pycache__"))
    r = _run(["--workload", "drawer_pc_dagger.train", "--seed", "1", "--seconds", "1",
              "--trace", "0"], tmp_path)
    assert r.returncode != 0 and r.stdout.strip() == ""
