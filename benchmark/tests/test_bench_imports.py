"""Nothing the benchmark runs imports JAX, flax or the JAX package
(compared by whole top-level name), and the reference imports nothing of
the program."""

import ast
import os
import subprocess
import sys

import pytest

from harness import cli
from harness.registry import BENCH_DIR, ROOT


def test_forbidden_compares_whole_names():
    mods = ["partmanip_tpu_torch", "partmanip_tpu_torch.sim", "jaxtyping", "flax_like", "torch"]
    assert cli.forbidden_modules(mods) == []
    assert cli.forbidden_modules(mods + ["jax.numpy", "partmanip_tpu.envs", "flax"]) == [
        "flax", "jax.numpy", "partmanip_tpu.envs"]


def imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def py_files(folder):
    for d, _, files in os.walk(folder):
        if "cache" in d.split(os.sep):
            continue
        yield from (os.path.join(d, f) for f in files if f.endswith(".py"))


@pytest.mark.parametrize("path", sorted(py_files(BENCH_DIR)))
def test_no_jax_import(path):
    tops = {m.split(".")[0] for m in imports(path)}
    assert not tops & set(cli.FORBIDDEN), path


@pytest.mark.parametrize("path", sorted(py_files(os.path.join(BENCH_DIR, "reference"))))
def test_reference_imports_nothing_of_the_program(path):
    tops = {m.split(".")[0] for m in imports(path)}
    assert not tops & {"partmanip_tpu_torch", "train_torch", "partmanip_tpu", "jax"}, path


def test_loaded_modules_after_import():
    """Every module a run loads (harness, drivers, readers, reference, the
    program's entry point and the modules the drivers reach) leaves no
    forbidden module in ``sys.modules``."""
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "from harness import cli, registry\n"
        "reg = registry.Registry()\n"
        "for w in reg.spec['workloads']:\n"
        "    c = reg.cell(w['name']); reg.driver(c['driver'])\n"
        "    [reg.reader(m['name']) for m in reg.per_layer(w['name'])]\n"
        "import train_torch\n"
        "from reference import envcheck, dagger, fps, task, teacher\n"
        "import partmanip_tpu_torch.algos.ppo, partmanip_tpu_torch.algos.dagger\n"
        "import partmanip_tpu_torch.envs.open_drawer, partmanip_tpu_torch.envs.vision\n"
        "print(cli.forbidden_modules())\n" % (BENCH_DIR, ROOT))
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == "[]"
