"""Build, load and count the launches of the port's CUDA kernels.

Every kernel of the port is one ``csrc/*.cu`` file with a plain C interface.
It is compiled by ``nvcc`` for ``sm_90a`` at first use into a shared library
under the checkout's git-ignored ``build/`` and loaded with ``ctypes``.  Each
wrapper (``sim/fused.py`` for B1a/B1b, ``ops/raymarch_cuda.py`` for B2,
``ops/fps.py`` for B3) holds a :class:`Library` that says which source, which
compile-time macros and flags and which C signatures.  Nothing here needs
``nvcc`` or a GPU at import time.

Launch counting: each wrapper registers its kernels with
:func:`launch_counter` and adds one to its count where it launches a kernel,
and nowhere else; :func:`launch_counts` and :func:`reset_launch_counts` read
and zero all of them at once.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from typing import Dict, Iterable, Sequence

PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(PACKAGE, "csrc")
# <checkout>/build, listed in .gitignore
BUILD_DIR = os.path.join(os.path.dirname(PACKAGE), "build")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}     # library path -> loaded library
_COUNTERS = []                         # the dicts handed out by launch_counter


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                            "bin", "nvcc")
        if os.path.exists(cand):
            nvcc = cand
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found: the port's CUDA kernels are compiled at first "
            "use and need the CUDA toolkit (PATH or CUDA_HOME)")
    return nvcc


class Library:
    """One kernel library: ``source`` compiled by nvcc with ``defines``
    (``(macro, value)`` pairs) and ``extra_flags`` into ``BUILD_DIR/so_name``,
    and the C signatures of its entry points (``{name: (argtypes,
    restype)}``).  ``name`` is the kernel's key in :func:`launch_counts`.
    :meth:`start` / :meth:`finish` build it (several side by side),
    :meth:`load` builds it when it is missing and loads it once per
    process.  nvcc writes to a name of this process's and the library is
    moved into place whole (``os.replace``), so processes that build the
    same library at once (the ranks of ``parallel/mesh.py``) never load a
    half-written one."""

    def __init__(self, name: str, source: str, so_name: str, signatures: dict,
                 defines: Sequence = (), extra_flags: Sequence[str] = ()):
        self.name, self.source, self.signatures = name, source, signatures
        self.path = os.path.join(BUILD_DIR, so_name)
        self.defines = tuple((m, int(v)) for m, v in defines)
        self.extra_flags = list(extra_flags)

    def command(self, out: str = None):
        """The nvcc command line writing to ``out`` (default the library's
        path); the source comes last."""
        return [find_nvcc(), *NVCC_FLAGS, *self.extra_flags,
                *[f"-D{m}={v}" for m, v in self.defines], "-o", out or self.path,
                self.source]

    def start(self) -> subprocess.Popen:
        """Start nvcc without waiting; hand the process to :meth:`finish`."""
        os.makedirs(BUILD_DIR, exist_ok=True)
        out = f"{self.path}.{os.getpid()}.tmp"
        proc = subprocess.Popen(self.command(out), stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        proc.out_path = out
        return proc

    def finish(self, proc: subprocess.Popen) -> str:
        """Wait for nvcc, keep its report (registers, spills) beside the
        library, move the library into place, raise if nvcc failed.
        Returns the report."""
        report, _ = proc.communicate()
        _write_whole(self.path + ".ptxas.txt", report)
        if proc.returncode != 0:
            if os.path.exists(proc.out_path):
                os.remove(proc.out_path)
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{report}")
        os.replace(proc.out_path, self.path)
        return report

    def load(self) -> ctypes.CDLL:
        lib = _LIBS.get(self.path)
        if lib is not None:
            return lib
        if not os.path.exists(self.path):
            self.finish(self.start())
        lib = ctypes.CDLL(self.path)
        for fn_name, (argtypes, restype) in self.signatures.items():
            fn = getattr(lib, fn_name)
            fn.argtypes = list(argtypes)
            fn.restype = restype
        _LIBS[self.path] = lib
        return lib


def _write_whole(path: str, text: str) -> None:
    """Write ``text`` to ``path`` through a name of this process's, so that
    a reader sees the old file or the new one, never a part."""
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        f.write(text)
    os.replace(tmp, path)


def ptxas_lines(report: str):
    """The lines of an ``-Xptxas -v`` report that give registers, stack and
    spills."""
    return [ln.strip() for ln in report.splitlines()
            if "registers" in ln or "spill" in ln or "stack frame" in ln]


def check_launch(err: int, what: str) -> None:
    """Raise when a C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")


def stream_of(t) -> int:
    """PyTorch's current stream on ``t``'s device, as the integer the C
    entry points take."""
    import torch
    with torch.cuda.device(t.device):
        return torch.cuda.current_stream().cuda_stream


def launch_counter(*names: str) -> Dict[str, int]:
    """A fresh ``{name: 0}`` dict that the caller's launches add to, known
    to :func:`launch_counts` and :func:`reset_launch_counts`."""
    counts = {n: 0 for n in names}
    _COUNTERS.append(counts)
    return counts


def launch_counts() -> Dict[str, int]:
    """Every kernel's launches since import or the last reset."""
    out = {}
    for c in _COUNTERS:
        out.update(c)
    return out


def reset_launch_counts(names: Iterable[str] = None) -> None:
    """Zero the counts of ``names`` (all kernels by default)."""
    for c in _COUNTERS:
        for k in c:
            if names is None or k in names:
                c[k] = 0
