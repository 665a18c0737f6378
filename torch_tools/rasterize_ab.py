#!/usr/bin/env python3
"""Time the box rasterizer's CUDA kernel against other builds of its source,
at the dense generator's shape (c): N=16, O=11, D=512, 256x256, bf16.

    python3 torch_tools/rasterize_ab.py [NAME=path/to/rasterize.cu ...]

Each other source (for example csrc/rasterize.cu of an earlier commit,
unpacked with `git archive`) is compiled, all at once, with the port's
nvcc flags and
called through the same C function, `ag_rasterize_forward`. Every build is
first held against the plain version at chip_smoke.py's BF16_TOL. Then the
other builds are timed in turns with chip_smoke.py's `time_shape`: the
checkout's kernel ("kernel"), its plain version, `torch.bmm` of the
precomputed coverage and a `fill_` of the output's bytes (medians of 15
samples of 10 launches queued back to back, CUDA events). Prints the card's
name and power limit, then one line per entry. Needs one CUDA card.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from ag2video_torch.ops._kernels import BUILD_DIR, NVCC_FLAGS, _nvcc  # noqa: E402
from ag2video_torch.ops.rasterize import boxes_to_layout_batch  # noqa: E402


def build(src: str, out_dir: str) -> ctypes.CDLL:
    so = os.path.join(out_dir, f"lib{abs(hash(src))}.so")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", so, src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stderr}")
    lib = ctypes.CDLL(so)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ag_rasterize_forward.argtypes = [p, p, p, p, i, i, i, i, i, i, p]
    lib.ag_rasterize_forward.restype = ctypes.c_int
    return lib


def run(others, unchecked=()) -> dict:
    """Time this checkout's kernel, each build of `others` ({name: source})
    and chip_smoke.py's yardsticks at shape (c); print one line each and
    return the times. Builds named in `unchecked` compute something else
    on purpose and skip the check against the plain version."""
    if not torch.cuda.is_available():
        raise SystemExit("rasterize_ab: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    N, O, D, H, W = cs.SHAPE_C
    vecs, boxes, mask = cs.raster_inputs(N, O, D, H, torch.bfloat16, 3)
    ref = boxes_to_layout_batch(vecs, boxes, H, W, mask=mask,
                                backend="plain")
    cs.check_close("this checkout", boxes_to_layout_batch(
        vecs, boxes, H, W, mask=mask), ref, cs.BF16_TOL)
    stream = torch.cuda.current_stream().cuda_stream
    fns = {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        with ThreadPoolExecutor(max(1, len(others))) as pool:
            libs = dict(zip(others, pool.map(lambda src: build(src, tmp),
                                             others.values())))
        for name, lib in libs.items():
            out = torch.empty_like(ref)

            def launch(lib=lib, out=out):
                err = lib.ag_rasterize_forward(
                    vecs.data_ptr(), boxes.data_ptr(), mask.data_ptr(),
                    out.data_ptr(), N, O, D, H, W, 1, stream)
                if err != 0:
                    raise RuntimeError(f"launch failed: CUDA error {err}")

            launch()
            torch.cuda.synchronize()
            if name not in unchecked:
                cs.check_close(name, out, ref, cs.BF16_TOL)
            fns[name] = launch
        ms = cs.time_shape(vecs, boxes, mask, H, W, extra=fns)
    written = N * H * W * D * 2
    bound = written / cs.HBM_BYTES_PER_S * 1e3
    for name, t in ms.items():
        print(f"{name}: {t:.4f} ms, {written / t / 1e6:.1f} GB/s written, "
              f"{100 * bound / t:.1f}% of the {bound:.4f} ms write bound")
    return ms


if __name__ == "__main__":
    run(dict(a.split("=", 1) for a in sys.argv[1:]))
