#!/usr/bin/env python3
"""Run one cell of the benchmark once, on the machine it is started on:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. Prints the numbers compared with the plain
reference beside their limits as the last lines on standard error, and one
JSON result line as the last line on standard output. Exits non-zero,
printing no result, without the CUDA cards the cell needs or without the
program (ag2video_torch) beside it. See benchmark/README.md.
"""

import time

T_START = time.monotonic()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
# Build and kernel caches at fixed paths inside the checkout, so that only
# a checkout's first run builds (the program's own nvcc outputs go to
# ag2video_torch/_build/).
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, ".bench_cache",
                                                  "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, ".bench_cache", "triton")
# One host thread for the program's CPU work (its own weight init at
# set-up, the dispatch of every call): a pool of threads on a host shared
# with other processes makes set-up and the calls' host time spread.
os.environ["OMP_NUM_THREADS"] = "1"
os.environ["MKL_NUM_THREADS"] = "1"

from benchmark import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START))
