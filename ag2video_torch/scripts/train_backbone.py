"""Train the synthetic-calibrated fidelity backbone (port of
scripts/train_backbone.py).

Trains eval/backbone.py's small CNN on REAL rendered synthetic frames
(labels are free: per-object shape x color presence + box-center grid
occupancy), evaluates it on held-out frames in BOTH domains (128^2 renders
area-pooled to 64, and run-resolution renders resized to 64: the val
pass's own input path), and saves the frozen weights in the JAX package's
asset format, which the trainer's use_gt val pass and scripts.eval_fidelity
of either package read.

    python -m ag2video_torch.scripts.train_backbone --out <path>.npz
    python -m ag2video_torch.scripts.train_backbone --device cpu --steps 3

The JAX CLI's flags and last JSON line, plus `--device` (default: the CUDA
card, which raises without one; `cpu` for the CPU). The default `--out` is
the committed asset, assets/synthetic_backbone.npz, as in the JAX CLI.
"""

from __future__ import annotations

import argparse
import json
import logging
from typing import Optional, Sequence

import numpy as np

log = logging.getLogger("train_backbone")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--batch_size", type=int, default=256)
    p.add_argument("--lr", type=float, default=2e-3)
    p.add_argument("--n_videos", type=int, default=4000)
    p.add_argument("--frames_per_video", type=int, default=2)
    p.add_argument("--n_val_videos", type=int, default=256)
    p.add_argument("--image_size", type=str, default="256,256",
                   help="run resolution for the domain-calibration set")
    p.add_argument("--frames_per_action", type=int, default=4)
    p.add_argument("--number_of_objects", type=int, default=7)
    p.add_argument("--max_objects", type=int, default=12)
    p.add_argument("--max_actions", type=int, default=4)
    p.add_argument("--synthetic_dynamics", type=str, default="linear")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", type=str, default="")
    p.add_argument("--device", type=str, default=None,
                   help="torch device; default the CUDA card (cpu: the CPU)")
    return p


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Train, calibrate and save -> the printed JSON line's dict."""
    import torch

    from ag2video_torch.eval.backbone import (DEFAULT_WEIGHTS, _device,
                                              _resize64, eval_backbone,
                                              make_frame_dataset,
                                              save_backbone, train_backbone)

    args = build_parser().parse_args(argv)
    device = _device(args.device, "train_backbone")

    class _Cfg:  # the fields make_frame_dataset reads
        frames_per_action = args.frames_per_action
        number_of_objects = args.number_of_objects
        max_objects = args.max_objects
        max_actions = args.max_actions
        synthetic_dynamics = args.synthetic_dynamics
        seed = args.seed

    cfg = _Cfg()
    log.info("rendering %d train videos...", args.n_videos)
    # Rendered at 128^2 and area-downsampled to 64: the antialiased edges
    # of the val pass's inputs (run-resolution frames area-pooled by
    # _resize64).
    tr = make_frame_dataset(cfg, args.n_videos, "train",
                            frames_per_video=args.frames_per_video,
                            seed=args.seed, render_size=(128, 128))
    log.info("train frames: %s", tr[0].shape)
    params, hist = train_backbone(*tr, steps=args.steps,
                                  batch_size=args.batch_size, lr=args.lr,
                                  seed=args.seed, log=log, device=device)

    # Calibration 1: held-out frames in the training domain (128 -> 64).
    va = make_frame_dataset(cfg, args.n_val_videos, "val",
                            frames_per_video=args.frames_per_video,
                            seed=args.seed + 1, render_size=(128, 128))
    acc_64 = eval_backbone(params, *va, device=device)
    log.info("held-out (128^2 -> area 64 renders): %s", acc_64)

    # Calibration 2: run-resolution renders through the val pass's input
    # path (_resize64 on the device, what FidelityScore applies).
    size = tuple(int(s) for s in args.image_size.split(","))
    vb = make_frame_dataset(cfg, args.n_val_videos, "val",
                            frames_per_video=args.frames_per_video,
                            seed=args.seed + 1, image_size=size)
    small = np.concatenate([
        _resize64(torch.as_tensor(vb[0][i:i + 64]).to(device)).cpu().numpy()
        for i in range(0, vb[0].shape[0], 64)])
    acc_hi = eval_backbone(params, small, vb[1], vb[2], device=device)
    log.info("held-out (%s renders -> resize64, the val-pass domain): %s",
             size, acc_hi)

    meta = {"steps": args.steps, "train_frames": int(tr[0].shape[0]),
            "acc_direct64": acc_64, "acc_runres_resize64": acc_hi,
            "image_size": list(size), "dynamics": args.synthetic_dynamics,
            "history": hist}
    path = save_backbone(params, args.out or DEFAULT_WEIGHTS, meta=meta)
    log.info("saved %s", path)
    result = {"path": path, "acc_direct64": acc_64,
              "acc_runres_resize64": acc_hi}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    main()
