#!/usr/bin/env python3
"""Run one cell of the benchmark of ``partmanip_tpu_torch`` once, on the
CUDA device of this machine:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  See ``benchmark/README.md``."""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(HERE, "cache")

# every kernel and build cache at a fixed path inside the checkout
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = os.path.join(CACHE, "nv")
os.environ["USE_FLAX"] = "0"

if __name__ == "__main__":
    sys.path[:0] = [p for p in (HERE, ROOT) if p not in sys.path]
    from harness import cli
    sys.exit(cli.main(sys.argv[1:], T_START))
