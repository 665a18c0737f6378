"""A traced slice of the workload: `torch.profiler` over a few calls, read
from its chrome trace.

What the readers get (`Slice`): every device operation (kernels, copies,
fills) with its start and length, the kernels among them, the slice's
length, the union of device intervals (busy), and each idle gap labelled by
the host operation that launched the device operation ending the gap (what
the host was doing while the card waited). Kernel categories are those of
the program's profiling tools (torch_tools/profile_generate.py), copied.
"""

from __future__ import annotations

import bisect
import json
import os
import re
import tempfile
import warnings
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

from benchmark.stats import covered, union

SLICE = "benchmark.slice"

# First match wins; names are those of cuDNN, cuBLAS / CUTLASS and
# PyTorch's own CUDA kernels.
CATEGORIES = [
    ("rasterizer kernel", r"rasterize"),
    ("memcpy / memset", r"^Memcpy|^Memset|memset|memcpy"),
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


class Slice:
    """The parsed trace of one slice of `calls` calls (times in seconds)."""

    def __init__(self, events: List[dict], calls: int):
        self.calls = calls
        marks = [e for e in events if e.get("name") == SLICE
                 and e.get("ph") == "X" and "dur" in e
                 and e.get("cat", "").lower() == "user_annotation"]
        if not marks:
            raise RuntimeError(f"the trace has no '{SLICE}' range")
        mark = marks[0]
        t0, t1 = mark["ts"], mark["ts"] + mark["dur"]
        self.window_s = mark["dur"] * 1e-6
        dev_cats = ("kernel", "gpu_memcpy", "gpu_memset")
        self.device_ops = [e for e in events if e.get("ph") == "X"
                           and e.get("cat", "").lower() in dev_cats
                           and t0 <= e["ts"] <= t1]
        self.kernels = [e for e in self.device_ops
                        if e["cat"].lower() == "kernel"]
        spans = [(e["ts"], min(e["ts"] + e.get("dur", 0), t1))
                 for e in self.device_ops]
        self.busy_s = covered(spans) * 1e-6
        self._events, self._bounds, self._spans = events, (t0, t1), spans

    def seconds_of(self, pattern: str) -> Tuple[float, int]:
        """(summed seconds, count) of the kernels whose name matches."""
        hits = [e for e in self.kernels if re.search(pattern, e["name"])]
        return sum(e.get("dur", 0) for e in hits) * 1e-6, len(hits)

    def by_category(self) -> List[Tuple[str, float]]:
        acc: Dict[str, float] = defaultdict(float)
        for e in self.device_ops:
            acc[category(e["name"])] += e.get("dur", 0) * 1e-6
        return sorted(acc.items(), key=lambda kv: -kv[1])

    def idle_gaps(self) -> List[Tuple[str, float]]:
        """Idle seconds of the slice summed by the host operation that
        launched the device operation ending each gap (the slice's tail
        after the last one: 'end of slice'), largest first."""
        ev = self._events
        t0, t1 = self._bounds
        launch = {}
        for e in ev:
            if e.get("cat", "").lower() == "cuda_runtime" and \
                    "correlation" in e.get("args", {}):
                launch[e["args"]["correlation"]] = e
        ops = sorted((e for e in ev if e.get("ph") == "X" and
                      e.get("cat", "").lower() == "cpu_op"),
                     key=lambda e: e["ts"])
        op_starts = [e["ts"] for e in ops]
        starts = {}
        for e in self.device_ops:
            starts.setdefault(e["ts"], e)

        def host_op(dev: dict) -> str:
            """The innermost cpu op around the launch of `dev`: of the ops
            that start before the launch, the latest that still runs."""
            rt = launch.get(dev.get("args", {}).get("correlation"))
            if rt is None:
                return "unattributed"
            i = bisect.bisect_right(op_starts, rt["ts"]) - 1
            for op in ops[max(i - 256, -1) + 1:i + 1][::-1]:
                if op["ts"] + op.get("dur", 0) >= rt["ts"] and \
                        op.get("tid") == rt.get("tid"):
                    return op["name"]
            return rt["name"]

        acc: Dict[str, float] = defaultdict(float)
        at = t0
        for a, b in union(self._spans):
            if a > at:
                acc[host_op(starts[a])] += (a - at) * 1e-6
            at = max(at, b)
        if t1 > at:
            acc["end of slice"] += (t1 - at) * 1e-6
        return sorted(acc.items(), key=lambda kv: -kv[1])


def trace_calls(fn: Callable[[], None], calls: int, sync: Callable[[], None],
                tmpdir: Optional[str] = None) -> Slice:
    """Profile `calls` calls of `fn` and the final `sync` inside one
    labelled range; parse the chrome trace and delete it."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with warnings.catch_warnings():
        # "Profiler clears events at the end of each cycle": one cycle here.
        warnings.simplefilter("ignore", UserWarning)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function(SLICE):
                for _ in range(calls):
                    fn()
                sync()
    fd, path = tempfile.mkstemp(suffix=".json", dir=tmpdir)
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return Slice(events, calls)
