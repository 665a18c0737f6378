#!/usr/bin/env python3
"""Where a full-width `generate` call spends its device time, per frontend.

    python3 torch_tools/profile_generate.py [factorized] [dense]

For each frontend named (both by default) this builds chip_smoke.py's
full-width CATER-256x256 model (B=2, T=8, bf16, seeded random weights;
`factorized` is the default configuration), makes 2 warm-up
`inference.generate` calls, times 5 unprofiled calls, each between two
`torch.cuda.synchronize()`, then traces 3 calls with `torch.profiler`.
It prints, per call: device kernel time by category, the count of device
kernels and of aten ops (all levels), and the device-busy share (kernel
time over the unprofiled calls' median; the profiler's own overhead inflates
the profiled calls' host time). Then the 12 largest kernels, and one JSON
line with the same numbers. Needs one CUDA card.
"""

from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import time
from collections import defaultdict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke as cs  # noqa: E402
from ag2video_torch import Config, get_vocab  # noqa: E402
from ag2video_torch.inference import generate, make_inputs  # noqa: E402
from ag2video_torch.models import AG2VideoModel  # noqa: E402

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


def profile_frontend(factorized: bool) -> dict:
    vocab = get_vocab("cater")
    cfg = Config(dataset="cater", factorized_frontend=factorized,
                 **cs.FULL).derive(vocab)
    B, T = 2, cfg.frames_per_action
    batch = make_inputs(cfg, vocab, B, T, seed=0)
    model = AG2VideoModel(cfg, vocab)
    frontend = "factorized" if factorized else "dense"
    out = profile_calls(lambda: generate(model, batch),
                        f"{frontend} frontend B={B} T={T} bf16")
    out["frontend"] = frontend
    return out


def main(argv) -> int:
    if not torch.cuda.is_available():
        raise SystemExit("profile_generate: needs a CUDA card")
    names = argv or ["factorized", "dense"]
    if set(names) - {"factorized", "dense"}:
        raise SystemExit(__doc__)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    results = [profile_frontend(n == "factorized") for n in names]
    print(json.dumps({"profiles": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
