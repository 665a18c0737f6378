"""Step timing and device traces (port of ag2video_tpu/utils/profiling.py;
the reference parses --timing and never reads it, data/args.py:86).

- `StepTimer`: rolling per-step wall-clock stats (a copy of the JAX
  package's, held equal to it by tests/test_torch_eval.py).
- `trace(logdir)`: a `torch.profiler` trace of the CPU and the CUDA card,
  written as a Chrome trace (`trace_<pid>_<n>.json`) under `logdir`,
  viewable in Perfetto or chrome://tracing.

`flops_of` and `summarize_compiled` read XLA's cost and memory analysis of
a compiled program; eager PyTorch has no such program, so they are not
ported.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

_TRACES = itertools.count()


class StepTimer:
    def __init__(self, window: int = 50):
        self.window = window
        self.times = []
        self._last: Optional[float] = None

    def tick(self) -> Optional[float]:
        now = time.perf_counter()
        dt = None
        if self._last is not None:
            dt = now - self._last
            self.times.append(dt)
            if len(self.times) > self.window:
                self.times.pop(0)
        self._last = now
        return dt

    @property
    def mean_ms(self) -> float:
        return float(np.mean(self.times) * 1e3) if self.times else 0.0

    @property
    def p50_ms(self) -> float:
        return float(np.median(self.times) * 1e3) if self.times else 0.0

    def stats(self) -> Dict[str, float]:
        if not self.times:
            return {}
        t = np.asarray(self.times) * 1e3
        return {"step_ms_mean": float(t.mean()),
                "step_ms_p50": float(np.median(t)),
                "step_ms_p95": float(np.percentile(t, 95)),
                "steps_per_sec": float(1e3 / t.mean())}


def start_trace() -> torch.profiler.profile:
    """Start a torch.profiler trace of the CPU (and the card, if any)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    return prof


def stop_trace(prof: torch.profiler.profile, logdir: str) -> str:
    """Stop `prof` and write its Chrome trace under `logdir` -> the path."""
    prof.stop()
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, f"trace_{os.getpid()}_{next(_TRACES)}.json")
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def trace(logdir: str):
    """Trace the block into a Chrome trace under `logdir`."""
    prof = start_trace()
    try:
        yield prof
    finally:
        stop_trace(prof, logdir)
