"""The port stands alone: importing it pulls in neither JAX nor the JAX
package, and its entry points refuse to run without a GPU unless the caller
asks for the CPU."""

import os
import pkgutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

IMPORT_ALL = r"""
import glob, importlib, importlib.util, os, pkgutil, sys
import partmanip_tpu_torch
names = ["partmanip_tpu_torch", "train_torch", "chip_smoke", "collect_demos_torch",
         "tune_pid_torch", "data_proc_torch"] + [
    m.name for m in pkgutil.walk_packages(partmanip_tpu_torch.__path__,
                                          "partmanip_tpu_torch.")]
for name in names:
    importlib.import_module(name)
for path in sorted(glob.glob(os.path.join("scripts", "*_torch_*.py"))):
    spec = importlib.util.spec_from_file_location(os.path.basename(path)[:-3], path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
    names.append(path)
banned = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                       "partmanip_tpu"))
print("IMPORTED", len(names))
print("BANNED", banned)
"""


def _port_modules():
    import partmanip_tpu_torch
    return [m.name for m in pkgutil.walk_packages(
        partmanip_tpu_torch.__path__, "partmanip_tpu_torch.")]


def test_fresh_interpreter_imports_no_jax():
    out = subprocess.run([sys.executable, "-c", IMPORT_ALL], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = dict(ln.split(" ", 1) for ln in out.stdout.strip().splitlines())
    assert int(lines["IMPORTED"]) >= 20
    assert lines["BANNED"] == "[]", lines["BANNED"]


# modules of the port whose counterpart has another name
COUNTERPARTS = {"partmanip_tpu_torch.ops.raymarch_cuda": "partmanip_tpu.ops.raymarch_tpu"}


def test_every_subpackage_has_its_counterpart_layout():
    mods = _port_modules()
    for sub in ("ops", "sim", "envs", "models", "algos", "utils", "parallel"):
        assert f"partmanip_tpu_torch.{sub}" in mods
    for name in ("ops.raymarch", "ops.raymarch_cuda", "ops.fps", "ops.tsdf",
                 "envs.vision", "utils.camera", "utils.cuda_lib", "algos.dagger",
                 "ops.sdf", "algos.storage", "algos.bc", "parallel.mesh"):
        assert f"partmanip_tpu_torch.{name}" in mods, name
    for name in mods:
        if name.endswith((".contact_states", ".convert", ".cuda_lib")):
            continue                         # the port's own helpers
        name = COUNTERPARTS.get(name, name)
        rel = name.replace("partmanip_tpu_torch", "partmanip_tpu").replace(".", "/")
        assert (os.path.exists(os.path.join(ROOT, rel + ".py"))
                or os.path.isdir(os.path.join(ROOT, rel))), name


KERNEL_REGISTRY = r"""
import train_torch, chip_smoke, collect_demos_torch
from partmanip_tpu_torch.ops import fps, raymarch, raymarch_cuda, tsdf
from partmanip_tpu_torch.envs import vision
from partmanip_tpu_torch.sim import fused
from partmanip_tpu_torch.utils import cuda_lib
print("COUNTS", sorted(cuda_lib.launch_counts().items()))
print("LIBS", len(cuda_lib._LIBS))
"""


def test_every_kernel_registers_its_count_and_builds_nothing_at_import():
    """B1a, B1b, B1c, B1d, B1e, B2 and B3 count their launches through the
    shared helper; importing the port (without nvcc on the PATH) loads no
    kernel."""
    env = dict(os.environ, PATH="/usr/bin:/bin", CUDA_HOME="/nonexistent")
    out = subprocess.run([sys.executable, "-c", KERNEL_REGISTRY], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = dict(ln.split(" ", 1) for ln in out.stdout.strip().splitlines())
    assert lines["COUNTS"] == str([("b1a", 0), ("b1b", 0), ("b1c", 0), ("b1d", 0),
                                   ("b1e", 0), ("b2", 0), ("b3", 0)])
    assert lines["LIBS"] == "0"


PARALLEL_ALONE = r"""
import sys
from partmanip_tpu_torch.parallel import mesh
print("NAMES", sorted(n for n in ("make_mesh", "activate", "active_mesh", "ENV_AXIS",
                                  "SHARD_DISPATCH_COUNT", "launch") if hasattr(mesh, n)))
print("BANNED", sorted(m for m in sys.modules
                       if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "partmanip_tpu")))
"""


def test_parallel_imports_no_jax_and_keeps_the_jax_names():
    """``partmanip_tpu_torch.parallel`` imported alone in a fresh
    interpreter pulls in neither JAX nor the JAX package, and keeps the JAX
    module's names where they have a counterpart."""
    out = subprocess.run([sys.executable, "-c", PARALLEL_ALONE], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = dict(ln.split(" ", 1) for ln in out.stdout.strip().splitlines())
    assert lines["BANNED"] == "[]", lines["BANNED"]
    assert lines["NAMES"] == str(sorted(["make_mesh", "activate", "active_mesh", "ENV_AXIS",
                                         "SHARD_DISPATCH_COUNT", "launch"]))


def test_port_sources_never_name_jax_imports():
    import re
    pat = re.compile(r"^\s*(import|from)\s+(jax|flax|optax|partmanip_tpu)\b", re.M)
    files = [os.path.join(ROOT, n) for n in ("train_torch.py", "chip_smoke.py",
                                             "collect_demos_torch.py", "tune_pid_torch.py",
                                             "data_proc_torch.py")]
    files += [os.path.join(ROOT, "scripts", n) for n in os.listdir(os.path.join(ROOT, "scripts"))
              if "_torch_" in n and n.endswith(".py")]
    for d, _, names in os.walk(os.path.join(ROOT, "partmanip_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    for path in files:
        with open(path) as f:
            assert not pat.search(f.read()), path


def test_env_defaults_to_the_gpu_and_raises_without_one():
    import torch
    from partmanip_tpu_torch.config import process_cfgs
    from partmanip_tpu_torch.envs.grasp_cube import GraspCubeEnv
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device exists")
    cfg, sp = process_cfgs(["--algo.num_envs", "2"])
    with pytest.raises(RuntimeError, match="CUDA"):
        GraspCubeEnv(cfg["task"], sp)
    assert GraspCubeEnv(cfg["task"], sp, device="cpu").device.type == "cpu"


def test_cli_defaults_to_the_gpu_and_raises_without_one():
    import torch
    import train_torch
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device exists")
    with pytest.raises(RuntimeError, match="CUDA"):
        train_torch.main(["--test_only", "--algo.num_envs", "2",
                          "--exp_name", "no_gpu_seed1", "--log.mode", "screen"])


def test_tool_entry_points_default_to_the_gpu_and_raise_without_one(tmp_path):
    """tune_pid_torch.py, data_proc_torch.py armmask and the diag twins run
    on the GPU unless asked for the CPU (``--device cpu``); without a GPU
    they raise naming CUDA."""
    import importlib.util
    import numpy as np
    import torch
    import data_proc_torch
    import tune_pid_torch
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device exists")
    np.save(tmp_path / "0.npy", {"pos": np.zeros((1, 12, 3), np.float32)})
    mains = [tune_pid_torch.main,
             lambda argv: data_proc_torch.main(["armmask", str(tmp_path)] + argv)]
    for name in ("diag_torch_cube", "diag_torch_drawer", "poke_torch_cube"):
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(ROOT, "scripts", f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        mains.append(mod.main)
    for main in mains:
        with pytest.raises(RuntimeError, match="CUDA"):
            main([])


def test_chip_smoke_fails_without_a_gpu():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
