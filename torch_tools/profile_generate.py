"""Device time of repeated calls, by kernel category, under `torch.profiler`.

`profile_calls(fn, label)` makes 2 warm-up calls of `fn`, times 5
unprofiled calls, each between two `torch.cuda.synchronize()`, then traces
3 calls. It prints, per call: device kernel time by category, the count of
device kernels and of aten ops (all levels), and the device-busy share
(kernel time over the unprofiled calls' median; the profiler's own overhead
inflates the profiled calls' host time), then the 12 largest kernels, and
returns the same numbers. torch_tools/profile_train.py and
torch_tools/profile_eval.py use it and `category` / `device_us`. Needs one
CUDA card. A `generate` call's profile is a benchmark cell's traced run:

    python3 benchmark/run.py --workload cater256_factorized.gen_b16 \
        --seed <n> --seconds <s> --trace 1
"""

from __future__ import annotations

import re
import statistics
import time
from collections import defaultdict

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

WARMUP, UNPROFILED, PROFILED = 2, 5, 3
# First match wins; names are those of cuDNN, cuBLAS / CUTLASS and
# PyTorch's own CUDA kernels.
CATEGORIES = [
    ("rasterizer kernel", r"rasterize"),
    ("memcpy / memset", r"^Memcpy|^Memset|memset"),
    ("cuDNN convs (implicit GEMM + NHWC padding kernels)",
     r"fprop|implicit|conv|nchwToNhwc|nhwcToNchw|cudnn"),
    ("matmul (object-basis contraction, projections, GCN)",
     r"gemm|cutlass|cublas|sm\d+_xmma|splitK|Kernel2"),
    ("concatenation / stack", r"CatArray"),
    ("copy / cast / pad", r"copy|pad"),
    ("gather / index, grid_sample", r"grid_sampler|index|gather|scatter"),
    ("elementwise / reduce", r"elementwise|reduce|batch_norm|vectorized|"
                             r"Reduce|softmax|norm"),
]


def category(name: str) -> str:
    for cat, pattern in CATEGORIES:
        if re.search(pattern, name):
            return cat
    return "other"


def device_us(e) -> float:
    t = getattr(e, "device_time_total", None)
    return float(t if t is not None else e.cuda_time_total)


def profile_calls(fn, label: str) -> dict:
    """WARMUP calls of `fn`, UNPROFILED timed ones, each between two
    `torch.cuda.synchronize()`, then PROFILED traced ones -> the numbers
    the module docstring lists, printed under `label`."""
    for _ in range(WARMUP):
        fn()
    calls_ms = []
    for _ in range(UNPROFILED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        calls_ms.append((time.perf_counter() - t0) * 1e3)
    call_ms = statistics.median(calls_ms)

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILED):
            fn()
        torch.cuda.synchronize()
    by_cat, by_name = defaultdict(float), defaultdict(lambda: [0.0, 0])
    kernels = aten = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us = device_us(e)
            by_cat[category(e.name)] += us
            by_name[e.name][0] += us
            by_name[e.name][1] += 1
            kernels += 1
        elif e.name.startswith("aten::"):
            aten += 1
    kernel_ms = sum(by_cat.values()) / 1e3 / PROFILED
    out = dict(
        label=label,
        unprofiled_call_ms=call_ms, unprofiled_calls_ms=calls_ms,
        kernel_ms_per_call=kernel_ms,
        busy_share=kernel_ms / call_ms,
        kernels_per_call=kernels / PROFILED, aten_ops_per_call=aten / PROFILED,
        categories={k: v / 1e3 / PROFILED for k, v in
                    sorted(by_cat.items(), key=lambda kv: -kv[1])},
        top_kernels=[(n[:120], t / 1e3 / PROFILED, c / PROFILED)
                     for n, (t, c) in sorted(by_name.items(),
                                             key=lambda kv: -kv[1][0])[:12]])
    print(f"{label}: unprofiled call "
          f"{call_ms:.2f} ms (median of "
          f"{', '.join(f'{t:.2f}' for t in calls_ms)}); device kernel time "
          f"{kernel_ms:.3f} ms per call (busy {100 * out['busy_share']:.1f}%); "
          f"{out['kernels_per_call']:.0f} kernels and "
          f"{out['aten_ops_per_call']:.0f} aten ops per call")
    for cat, ms in out["categories"].items():
        print(f"  {cat:55s} {ms:9.3f} ms  {100 * ms / kernel_ms:5.1f}%")
    print("  largest kernels (ms per call, launches per call):")
    for name, ms, n in out["top_kernels"]:
        print(f"    {ms:8.3f} {n:6.0f}  {name}")
    return out
