#!/usr/bin/env python3
"""Where a full-width training iteration spends its device time.

    python3 torch_tools/profile_train.py [bp_prev | flow_deconv | bf16_params]

Builds chip_smoke.py phase 9's trainer (or, given a mode, phase 14's in
that training mode of chip_smoke.TRAIN_MODES) (the JAX package's Config defaults
at CATER-256x256: B=3 clips of 4 frames, graph clips of 16, factorized
frontend, bf16, VGG and feature matching on, seeded random weights), runs 2
warm-up iterations (`train_step` + `graph_step`), times 5 unprofiled ones,
each between two `torch.cuda.synchronize()`, then traces 3 with
`torch.profiler`. It prints, per iteration, in profile_generate.py's
format: device kernel time by category, the count of device kernels and of
aten ops, the device-busy share (kernel time over the unprofiled
iterations' median), the rasterizer's forward (the CUDA kernel) and
backward (autograd of its plain closed form, under
`RasterizeFunction.backward`) device time, then the 12 largest kernels and
one JSON line with the same numbers. Needs one CUDA card.
"""

from __future__ import annotations

import json
import os
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
from ag2video_torch.inference import make_inputs  # noqa: E402
from ag2video_torch.train import Trainer  # noqa: E402
from torch_tools.profile_generate import category, device_us  # noqa: E402

WARMUP, UNPROFILED, PROFILED = 2, 5, 3


def _kernel_us_under(op) -> float:
    """Device time (us) of the kernels launched under the host op `op`."""
    return sum(k.duration for k in op.kernels) + sum(
        _kernel_us_under(child) for child in op.cpu_children)


def _is_raster_backward(e) -> bool:
    """The outermost host event of the rasterizer's backward."""
    name = "RasterizeFunctionBackward"
    return name in e.name and (e.cpu_parent is None
                               or name not in e.cpu_parent.name)


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        raise SystemExit("profile_train: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    vocab = get_vocab("cater")
    mode = (sys.argv[1:] if argv is None else argv) or ["default"]
    mode = mode[0]
    cfg = Config(dataset="cater", **cs.TRAIN_FULL,
                 **({} if mode == "default" else cs.TRAIN_MODES[mode])
                 ).derive(vocab)
    B, T = cfg.batch_size, cfg.frames_per_action
    batch = make_inputs(cfg, vocab, B, T, seed=0)
    graph = make_inputs(cfg, vocab, B, 4 * cfg.frames_per_action_graph,
                        seed=1)
    trainer = Trainer(cfg, vocab)
    trainer.init(batch)

    def iteration():
        trainer.train_step(batch)
        trainer.graph_step(graph)

    for _ in range(WARMUP):
        iteration()
    iters_ms = []
    for _ in range(UNPROFILED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        iteration()
        torch.cuda.synchronize()
        iters_ms.append((time.perf_counter() - t0) * 1e3)
    iter_ms = statistics.median(iters_ms)

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILED):
            iteration()
        torch.cuda.synchronize()
    by_cat, by_name = defaultdict(float), defaultdict(lambda: [0.0, 0])
    kernels = aten = 0
    raster_bwd_us = 0.0
    for e in prof.events():
        if getattr(e, "is_user_annotation", False):
            continue  # a host range drawn on the device timeline
        if e.device_type == DeviceType.CUDA:
            us = device_us(e)
            by_cat[category(e.name)] += us
            by_name[e.name][0] += us
            by_name[e.name][1] += 1
            kernels += 1
        elif e.name.startswith("aten::"):
            aten += 1
        elif _is_raster_backward(e):
            raster_bwd_us += _kernel_us_under(e)
    kernel_ms = sum(by_cat.values()) / 1e3 / PROFILED
    out = dict(
        config="CATER 256x256 %s, B=%d T=%d, graph T=%d, bf16" % (
            mode, B, T, 4 * cfg.frames_per_action_graph),
        unprofiled_iteration_ms=iter_ms, unprofiled_iterations_ms=iters_ms,
        kernel_ms_per_iteration=kernel_ms, busy_share=kernel_ms / iter_ms,
        kernels_per_iteration=kernels / PROFILED,
        aten_ops_per_iteration=aten / PROFILED,
        rasterizer_forward_ms=by_cat.get("rasterizer kernel", 0.0) / 1e3
        / PROFILED,
        rasterizer_backward_ms=raster_bwd_us / 1e3 / PROFILED,
        categories={k: v / 1e3 / PROFILED for k, v in
                    sorted(by_cat.items(), key=lambda kv: -kv[1])},
        top_kernels=[(n[:120], t / 1e3 / PROFILED, c / PROFILED)
                     for n, (t, c) in sorted(by_name.items(),
                                             key=lambda kv: -kv[1][0])[:12]])
    print(f"training iteration ({out['config']}): unprofiled iteration "
          f"{iter_ms:.2f} ms (median of "
          f"{', '.join(f'{t:.2f}' for t in iters_ms)}); device kernel time "
          f"{kernel_ms:.3f} ms per iteration (busy "
          f"{100 * out['busy_share']:.1f}%); "
          f"{out['kernels_per_iteration']:.0f} kernels and "
          f"{out['aten_ops_per_iteration']:.0f} aten ops per iteration; "
          f"rasterizer forward {out['rasterizer_forward_ms']:.3f} ms, "
          f"backward {out['rasterizer_backward_ms']:.3f} ms")
    for cat, ms in out["categories"].items():
        print(f"  {cat:55s} {ms:9.3f} ms  {100 * ms / kernel_ms:5.1f}%")
    print("  largest kernels (ms per iteration, launches per iteration):")
    for name, ms, n in out["top_kernels"]:
        print(f"    {ms:8.3f} {n:6.0f}  {name}")
    print(json.dumps({"profile_train": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
