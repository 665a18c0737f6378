#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one line (any failure raises and exits nonzero):

1. the card's name and power limit (nvidia-smi) and the kernel build;
2. the box-rasterizer kernel against its plain PyTorch version at three
   shapes, with kernel and plain times at the generator's shape;
3. gradients through the kernel's autograd.Function against autograd of the
   plain version;
4. a small fp32 model at 64x64 run with the kernel, with the plain
   rasterizer on the card, and on the CPU: the frames must agree;
5. the dense-frontend CATER-256x256 generation path at full width (B=2,
   bf16, seeded random weights) through `inference.generate`: finite
   frames, rasterizer launched by the kernel only, frames/s and peak memory.

Then a JSON line describing each kernel and, last, the device line.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import torch

from ag2video_torch import Config, get_vocab
from ag2video_torch.inference import generate, make_inputs
from ag2video_torch.models import AG2VideoModel
from ag2video_torch.ops._kernels import rasterize_library
from ag2video_torch.ops.rasterize import (KERNEL_LAUNCHES, PLAIN_CALLS,
                                          boxes_to_layout_batch)

SMALL = dict(image_size=(64, 64), frames_per_action=3, max_objects=5,
             max_triplets=6, max_actions=2, embedding_dim=16, gconv_dim=16,
             gconv_hidden_dim=32, gconv_num_layers=2, ngf=4, nff=4,
             n_blocks_F=1, n_downsample_F=2, compute_dtype="float32")
FULL = dict(image_size=(256, 256), frames_per_action=8, max_objects=11,
            max_triplets=11, max_actions=2, compute_dtype="bfloat16")
F32_TOL = dict(rtol=1e-5, atol=1e-5)
# bf16: kernel and plain round fp32 sums taken in another order, so an
# output may differ by one bf16 rounding (at most 2^-7 relative).
BF16_TOL = dict(rtol=1e-2, atol=1e-5)
# The 64x64 model in fp32 (TF32 off): kernel vs plain seg differ by fp32
# rounding only; the card vs the CPU also differ in conv summation order.
MODEL_TOL_CARD = dict(rtol=1e-4, atol=1e-4)
MODEL_TOL_CPU = dict(rtol=1e-3, atol=1e-3)


def check_close(name, got, ref, tol):
    err = (got.float() - ref.float()).abs()
    bound = tol["atol"] + tol["rtol"] * ref.float().abs()
    worst = float(err.max()) if err.numel() else 0.0
    if not bool(torch.isfinite(got).all()) or bool((err > bound).any()):
        raise AssertionError(f"{name}: max |diff| {worst:.3e} exceeds "
                             f"rtol={tol['rtol']} atol={tol['atol']}")
    return worst


def cuda_ms(fn, runs=25, warmup=3):
    """Median time of `fn` in ms over `runs` launches, by CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def raster_inputs(N, O, D, H, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    vecs = torch.randn(N, O, D, generator=g).to(dtype)
    lo = torch.rand(N, O, 2, generator=g) * 1.1 - 0.2
    ext = torch.rand(N, O, 2, generator=g) * 0.65 + 0.05
    boxes = torch.cat([lo, ext], -1)
    mask = (torch.rand(N, O, generator=g) > 0.25).float()
    return vecs.cuda(), boxes.cuda(), mask.cuda()


def phase_card():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    built = rasterize_library()
    ptxas = [ln.strip() for ln in built.build_log.splitlines()
             if "registers" in ln or "spill" in ln]
    print(f"phase 1 build: csrc/rasterize.cu -> {built.path.name} in "
          f"{built.build_seconds:.2f} s; ptxas: {' | '.join(ptxas)}")
    return card


def phase_kernel():
    def both(vecs, boxes, mask, H, W):
        k = boxes_to_layout_batch(vecs, boxes, H, W, mask=mask,
                                  backend="auto")
        p = boxes_to_layout_batch(vecs, boxes, H, W, mask=mask,
                                  backend="plain")
        torch.cuda.synchronize()
        return k, p

    errs = {}
    # (a) the JAX kernel test's shape, with a zero-width box and masks.
    vecs, boxes, mask = raster_inputs(3, 6, 128, 32, torch.float32, 0)
    boxes[0, 1, 2] = 0.0
    mask[1] = 0.0
    errs["a"] = check_close("(a) N=3 O=6 D=128 32x32 f32",
                            *both(vecs, boxes, mask, 32, 32), F32_TOL)
    # (b) odd shapes; (b2) O > 16 and D not a multiple of 4.
    vecs, boxes, mask = raster_inputs(2, 13, 400, 48, torch.float32, 1)
    errs["b"] = check_close("(b) N=2 O=13 D=400 48x48 f32",
                            *both(vecs, boxes, mask, 48, 48), F32_TOL)
    vecs, boxes, mask = raster_inputs(2, 20, 30, 20, torch.float32, 2)
    errs["b2"] = check_close("(b2) N=2 O=20 D=30 20x24 f32",
                             *both(vecs, boxes, mask, 20, 24), F32_TOL)
    # (c) the dense generator's shape: B*T=16 frames, O=11, D=512, 256^2.
    vecs, boxes, mask = raster_inputs(16, 11, 512, 256, torch.bfloat16, 3)
    errs["c"] = check_close("(c) N=16 O=11 D=512 256x256 bf16",
                            *both(vecs, boxes, mask, 256, 256), BF16_TOL)
    ms = cuda_ms(lambda: boxes_to_layout_batch(
        vecs, boxes, 256, mask=mask, backend="auto"))
    plain_ms = cuda_ms(lambda: boxes_to_layout_batch(
        vecs, boxes, 256, mask=mask, backend="plain"))
    written = 16 * 256 * 256 * 512 * 2
    print(f"phase 2 kernel vs plain max|diff|: (a) {errs['a']:.3e} "
          f"(b) {errs['b']:.3e} (b2) {errs['b2']:.3e} (c) {errs['c']:.3e}; "
          f"at (c) kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (median of "
          f"25, CUDA events), {written / ms / 1e6:.1f} GB/s written")
    return errs["c"], ms, plain_ms


def phase_grad():
    vecs, boxes, mask = raster_inputs(3, 6, 128, 32, torch.float32, 4)
    boxes[0, 1, 2] = 0.0
    g = torch.randn(3, 32, 32, 128, device="cuda")
    grads = {}
    for backend in ("auto", "plain"):
        v = vecs.clone().requires_grad_(True)
        b = boxes.clone().requires_grad_(True)
        out = boxes_to_layout_batch(v, b, 32, mask=mask, backend=backend)
        dv, db = torch.autograd.grad((out * g).sum(), (v, b))
        grads[backend] = (dv, db)
    e_v = check_close("dvecs", grads["auto"][0], grads["plain"][0], F32_TOL)
    e_b = check_close("dboxes", grads["auto"][1], grads["plain"][1],
                      dict(rtol=1e-4, atol=1e-4))
    print(f"phase 3 gradients through the kernel's autograd.Function vs "
          f"plain autograd: dvecs {e_v:.3e}, dboxes {e_b:.3e}")


def phase_small_model():
    vocab = get_vocab("cater")
    cfg = Config(dataset="cater", factorized_frontend=False,
                 **SMALL).derive(vocab)
    batch = make_inputs(cfg, vocab, 2, cfg.frames_per_action, seed=0)
    model = AG2VideoModel(cfg, vocab)
    cpu_imgs, _ = generate(model, batch)
    model.cuda()
    KERNEL_LAUNCHES.reset()
    k_imgs, _ = generate(model, batch)
    torch.cuda.synchronize()
    if KERNEL_LAUNCHES.n == 0:
        raise AssertionError("the small model did not launch the kernel")
    model.layout_to_video.rasterizer_backend = "plain"
    p_imgs, _ = generate(model, batch)
    e_card = check_close("64x64 kernel vs plain on the card", k_imgs, p_imgs,
                         MODEL_TOL_CARD)
    e_cpu = check_close("64x64 card vs CPU", k_imgs.cpu(), cpu_imgs,
                        MODEL_TOL_CPU)
    print(f"phase 4 small fp32 model 64x64: imgs_pred kernel vs plain on "
          f"the card {e_card:.3e}, card vs CPU {e_cpu:.3e}")


def phase_full():
    vocab = get_vocab("cater")
    cfg = Config(dataset="cater", factorized_frontend=False,
                 **FULL).derive(vocab)
    B, T = 2, cfg.frames_per_action
    H, W = cfg.image_size
    batch = make_inputs(cfg, vocab, B, T, seed=0)
    t0 = time.perf_counter()
    model = AG2VideoModel(cfg, vocab).cuda()
    setup_s = time.perf_counter() - t0

    KERNEL_LAUNCHES.reset()
    PLAIN_CALLS.reset()
    imgs, boxes = generate(model, batch)
    torch.cuda.synchronize()
    launches, plain = KERNEL_LAUNCHES.n, PLAIN_CALLS.n
    if tuple(imgs.shape) != (B, T, H, W, 3):
        raise AssertionError(f"imgs_pred shape {tuple(imgs.shape)}")
    if not bool(torch.isfinite(imgs).all()) or \
            float(imgs.abs().max()) > 1e3:
        raise AssertionError("non-finite or runaway generated frames")
    if launches == 0 or plain != 0:
        raise AssertionError(f"rasterizer kernel launches {launches}, "
                             f"plain calls {plain}")

    torch.cuda.reset_peak_memory_stats()
    generate(model, batch)
    torch.cuda.synchronize()
    runs = 10
    t0 = time.perf_counter()
    for _ in range(runs):
        generate(model, batch)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / runs
    frames = B * (T - (cfg.n_frames_G - 1))
    peak = torch.cuda.max_memory_allocated()
    print(f"phase 5 CATER 256x256 dense frontend B={B} T={T} bf16: "
          f"imgs_pred {tuple(imgs.shape)} finite; rasterizer kernel "
          f"launches {launches}, plain calls {plain}; {frames / dt:.2f} "
          f"generated frames/s ({dt * 1e3:.1f} ms per call, mean of {runs}); "
          f"peak memory {peak / 2**30:.2f} GiB; model setup {setup_s:.1f} s")
    return launches


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script needs the "
                         "card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_card()
    err, ms, plain_ms = phase_kernel()
    phase_grad()
    phase_small_model()
    launches = phase_full()
    print(json.dumps({"kernels": [{
        "name": "rasterize",
        "route": "cuda",
        "source": "ag2video_torch/csrc/rasterize.cu",
        "replaces": "ag2video_tpu/ops/pallas/rasterize_kernel.py:33",
        "launches": launches,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
