"""The yardstick's arithmetic: counts, least times, the mfu and roofline
shares, and the idle share and idle gaps of a synthetic trace."""

import importlib.util
import math
import os
import types

import pytest

from harness import counts, trace
from harness.registry import BENCH_DIR


def reader(name):
    spec = importlib.util.spec_from_file_location(name.replace(".", "_"),
                                                  os.path.join(BENCH_DIR, "metrics", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_dense_and_pointnet_counts():
    assert counts.dense_flops([3, 4, 5], 10) == 2 * 10 * (3 * 4 + 4 * 5)
    per_point = 3 * 128 + 128 * 256 + 256 * 512
    head = 512 * 128 + 128 * 32 + 32 * 10
    assert counts.pointnet_flops(3, 1024, 0, 10, 2) == 2 * 2 * (1024 * per_point + head)


def test_bound_names_the_longer_side():
    b = counts.bound_s(67e12, 0.0)
    assert b == {"s": 1.0, "by": "operations"}
    b = counts.bound_s(0.0, 3.35e12)
    assert b["by"] == "bytes" and math.isclose(b["s"], 1.0)
    assert counts.fps_operations(1024, 1000) == 8 * 1024 * 1000


def test_mfu_arithmetic():
    run = types.SimpleNamespace(work={"least_s_per_unit": 0.01},
                                window={"units": 30, "seconds": 20.0})
    for cell in ("eval", "dagger"):
        assert math.isclose(reader(f"mfu.{cell}").read(run), 100 * 0.01 * 30 / 20.0)
    assert reader("mfu.dagger").read(types.SimpleNamespace(work={}, window={})) is None


def ev(name, ts, dur, cat, tid=1):
    return {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat, "tid": tid}


SYNTH = [ev(trace.WINDOW, 0, 100, "user_annotation"),
         ev("env.step", 0, 60, "user_annotation"),
         ev("aten::mm", 70, 20, "cpu_op"),
         ev("k1", 10, 10, "kernel", 7), ev("k2", 15, 10, "kernel", 7),   # union 10..25
         ev("k1", 40, 10, "kernel", 7), ev("Memcpy", 80, 5, "gpu_memcpy", 7),
         ev("k3", 95, 20, "kernel", 7)]                                  # clipped at 100


def test_idle_share_on_synthetic_trace():
    p = trace.reduce_events(SYNTH)
    assert math.isclose(p.window_s, 100e-6)
    assert math.isclose(p.busy_s, (15 + 10 + 5 + 5) * 1e-6)
    run = types.SimpleNamespace(profile=p)
    assert math.isclose(reader("device_idle.dagger").read(run), 65.0)
    # gaps 0-10 and 25-40 (midpoints inside env.step); 50-80 and 85-95
    # (midpoints 65 and 90: no span or operator open there)
    assert math.isclose(p.idle["env.step"], 25e-6)
    assert math.isclose(p.idle["host"], 40e-6)
    assert math.isclose(sum(p.idle.values()), 65e-6)
    assert p.launches("k1") == 2 and math.isclose(p.device_s("k1"), 20e-6)
    b = p.breakdown()
    assert len(b["device_ops"]) <= 10 and b["device_ops"][0][0] in ("k1", "k2")


def test_roofline_reader():
    p = trace.reduce_events([ev(trace.WINDOW, 0, 1000, "user_annotation")]
                            + [ev("fps_kernel(x)", 100 * i, 50, "kernel", 7)
                               for i in range(4)])
    run = types.SimpleNamespace(profile=p, work={"b3": {"s": 5e-6, "by": "operations"}})
    assert math.isclose(reader("b3_roofline").read(run), 10.0)
    run.work = {}
    assert reader("b3_roofline").read(run) is None


def test_no_window_annotation_raises():
    with pytest.raises(ValueError):
        trace.reduce_events([ev("k", 0, 1, "kernel")])
