"""The benchmark's arithmetic: percentiles, busy and idle time from a
trace, the rasterizer's least traffic, and the readers' formulas."""

import numpy as np
import pytest

from benchmark import flops, peaks, stats
from benchmark.metrics import (idle_pct, launches_per_call, mfu,
                               rasterize_roofline)
from benchmark.trace import SLICE, Slice, category


def test_p95_over_all_calls():
    rng = np.random.default_rng(3)
    xs = list(rng.gamma(2.0, 50.0, 257))
    assert stats.percentile(xs, 95) == pytest.approx(np.percentile(xs, 95))
    assert stats.percentile([5.0], 95) == 5.0
    # Every call counts: one slow call in twenty moves the p95.
    assert stats.percentile([1.0] * 19 + [100.0], 95) > 1.0


def test_union_of_intervals():
    assert stats.union([(5, 6), (0, 2), (1, 3), (3, 4)]) == [(0, 4), (5, 6)]
    assert stats.covered([(0, 2), (1, 3), (10, 11)]) == 4


def _trace():
    """A slice of 100 us: kernels on [10, 30], [20, 40] (overlapping, on
    two streams), a copy on [60, 70]; one cpu op launching each."""
    ev = [{"ph": "X", "cat": "user_annotation", "name": SLICE, "ts": 0,
           "dur": 100, "tid": 1}]
    for i, (ts, dur, cat, name, op) in enumerate([
            (10, 20, "kernel", "cudnn_conv_fprop", "aten::conv2d"),
            (20, 20, "kernel", "vectorized_elementwise_kernel", "aten::add"),
            (60, 10, "gpu_memcpy", "Memcpy HtoD", "aten::copy_")]):
        ev.append({"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
                   "args": {"correlation": i}})
        ev.append({"ph": "X", "cat": "cpu_op", "name": op, "ts": ts - 5,
                   "dur": 3, "tid": 1})
        ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunch",
                   "ts": ts - 4, "dur": 1, "tid": 1,
                   "args": {"correlation": i}})
    return Slice(ev, calls=2)


def test_busy_idle_and_gaps_from_a_trace():
    sl = _trace()
    assert sl.window_s == pytest.approx(100e-6)
    assert sl.busy_s == pytest.approx(40e-6)          # [10, 40] + [60, 70]
    assert len(sl.kernels) == 2
    assert idle_pct.read({"slice": sl}, "idle_pct.gen") == pytest.approx(60)
    assert launches_per_call.read({"slice": sl}, "x") == 1.0
    gaps = dict(sl.idle_gaps())
    assert gaps == pytest.approx({"aten::conv2d": 10e-6,
                                  "aten::copy_": 20e-6,
                                  "end of slice": 30e-6})
    cats = dict(sl.by_category())
    assert cats[category("cudnn_conv_fprop")] == pytest.approx(20e-6)


def test_rasterize_bytes_at_the_generator_shape():
    """chip_smoke.py phase 2's (c): N=16 O=11 D=512 at 256x256 bf16 writes
    1.07 GB, a bound of 0.3206 ms at 3.35 TB/s."""
    nbytes, nflops = flops.rasterize_bytes_flops(16, 11, 512, 256, 256)
    assert nbytes == pytest.approx(1.07e9, rel=5e-3)
    assert nbytes / peaks.HBM_BYTES_PER_S * 1e3 == pytest.approx(0.3206,
                                                                 rel=1e-3)
    assert nflops == 2 * 16 * 256 * 256 * 11 * 512


def test_rasterize_roofline_reader():
    class S:
        calls = 2

        def seconds_of(self, pattern):
            assert pattern == "rasterize"
            return 2 * 0.4e-3, 2

    shape = (16, 11, 512, 256, 256)
    got = rasterize_roofline.read({"slice": S(), "raster_shape": shape}, "x")
    assert got == pytest.approx(100 * 0.3206 / 0.4, rel=1e-3)
    assert rasterize_roofline.read({"slice": S()}, "x") is None


def test_mfu_reader():
    ctx = {"flops_per_call": 69.5e12, "calls": 60, "window_s": 40.0}
    assert mfu.read(ctx, "mfu.gen") == pytest.approx(
        100 * 69.5e12 * 60 / (40.0 * 989e12))
    assert mfu.read({}, "mfu.gen") is None
