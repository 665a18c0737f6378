"""Standalone evaluation CLI (port of scripts/evaluate.py).

  - image FID between two image dirs (evaluation/fid/fid_score.py:253)
  - video FID/PRD between clip dirs (evaluation/video/score.py)
  - LPIPS over paired {'image','box'} pkl videos
    (evaluation/PerceptualSimilarity/compute_dists_videos.py) or image dirs
    (compute_dists_dirs.py)
  - Inception Score over an image dir

    python -m ag2video_torch.scripts.evaluate image_fid  DIR_A DIR_B
    python -m ag2video_torch.scripts.evaluate video_fid  GEN_DIR REF_DIR [--backbone tsm]
    python -m ag2video_torch.scripts.evaluate video_prd  GEN_DIR REF_DIR
    python -m ag2video_torch.scripts.evaluate lpips_videos GEN_DIR REF_DIR
    python -m ag2video_torch.scripts.evaluate lpips_dirs DIR_A DIR_B
    python -m ag2video_torch.scripts.evaluate is IMG_DIR

The JAX CLI's arguments, plus `--device` (default: the CUDA card, which
raises without one; `cpu` for the CPU); it prints the same one JSON line
with the same keys. The networks load the JAX package's assets
(assets/inception_v3.npz, lpips_alex.npz, tsm.npz, resnext3d.npz) when
present; without them they hold seeded random weights, logged, and the
scores are comparable only within one configuration (and not with the JAX
CLI's random-init scores). The image modes read PNG/JPEG files with PIL,
imported when they run. TF32 is left as the caller set it.
"""

from __future__ import annotations

import argparse
import glob
import json
import logging
import os

import numpy as np

log = logging.getLogger("evaluate")


def _load_images(directory, size=(299, 299), limit=None, mode="images"):
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(f"evaluate {mode}: reading image files needs "
                          f"PIL, which does not import here") from e

    from ag2video_torch.data.transforms import IMG_MEAN, IMG_STD

    paths = sorted(
        p for ext in ("*.png", "*.jpg", "*.jpeg")
        for p in glob.glob(os.path.join(directory, ext)))
    if limit:
        paths = paths[:limit]
    out = []
    for p in paths:
        img = Image.open(p).convert("RGB").resize(size[::-1])
        # ImageNet normalization — what the ported torchvision InceptionV3
        # weights expect (and what the train-time IS path feeds).
        arr = np.asarray(img, np.float32) / 255.0
        out.append((arr - IMG_MEAN) / IMG_STD)
    return np.stack(out)


def _inception_pool3(imgs, batch_size=16, device=None):
    import torch

    from ag2video_torch.eval.inception import (inception_v3,
                                               load_inception_params)

    model, random_init = inception_v3(load_inception_params(), device)
    if random_init:
        log.warning("InceptionV3 has RANDOM weights (no assets/"
                    "inception_v3.npz) — scores comparable only "
                    "within this configuration")
    dev = next(model.parameters()).device
    feats, probs = [], []
    with torch.no_grad():
        for i in range(0, len(imgs), batch_size):
            x = torch.as_tensor(np.asarray(imgs[i:i + batch_size],
                                           np.float32)).to(dev)
            logits, pool3 = model(x)
            feats.append(pool3.cpu().numpy())
            probs.append(torch.softmax(logits, dim=-1).cpu().numpy())
    return np.concatenate(feats), np.concatenate(probs)


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("mode", choices=["image_fid", "video_fid", "video_prd",
                                    "lpips_videos", "lpips_dirs", "is"])
    p.add_argument("path_a")
    p.add_argument("path_b", nargs="?")
    p.add_argument("--backbone", default="tsm", choices=["tsm", "resnext"])
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)
    from ag2video_torch.eval.layers import eval_device

    dev = eval_device(args.device, "evaluate")

    if args.mode == "image_fid":
        from ag2video_torch.eval.fid import fid_from_features

        fa, _ = _inception_pool3(_load_images(args.path_a, limit=args.limit,
                                              mode=args.mode), device=dev)
        fb, _ = _inception_pool3(_load_images(args.path_b, limit=args.limit,
                                              mode=args.mode), device=dev)
        result = {"image_fid": fid_from_features(fa, fb)}
    elif args.mode == "video_fid":
        from ag2video_torch.eval.video_score import compute_frechet_distance

        result = {"video_fid": compute_frechet_distance(
            args.path_a, args.path_b, args.backbone, device=dev)}
    elif args.mode == "video_prd":
        from ag2video_torch.eval.prd import prd_to_max_f_beta_pair
        from ag2video_torch.eval.video_score import compute_precision_recall

        prec, rec = compute_precision_recall(args.path_a, args.path_b,
                                             args.backbone, device=dev)
        f8, f8inv = prd_to_max_f_beta_pair(prec, rec)
        result = {"prd_f8": f8, "prd_f1_8": f8inv}
    elif args.mode == "lpips_videos":
        import pickle

        from ag2video_torch.eval.lpips import LPIPS

        lp = LPIPS(device=dev)
        if lp.random_init:
            log.warning("LPIPS has RANDOM backbone weights")
        dists = []
        gen_pkls = sorted(glob.glob(os.path.join(args.path_a, "*.pkl")))
        for gp in gen_pkls[: args.limit]:
            rp = os.path.join(args.path_b, os.path.basename(gp))
            if not os.path.exists(rp):
                continue
            with open(gp, "rb") as f:
                a = np.asarray(pickle.load(f)["image"], np.float32)
            with open(rp, "rb") as f:
                b = np.asarray(pickle.load(f)["image"], np.float32)
            T = min(len(a), len(b))
            dists.append(lp.video_pair_distance(a[:T], b[:T]))
        result = {"lpips": float(np.mean(dists)), "n_pairs": len(dists)}
    elif args.mode == "lpips_dirs":
        from ag2video_torch.eval.lpips import LPIPS

        lp = LPIPS(device=dev)
        a = _load_images(args.path_a, size=(64, 64), limit=args.limit,
                         mode=args.mode)
        b = _load_images(args.path_b, size=(64, 64), limit=args.limit,
                         mode=args.mode)
        n = min(len(a), len(b))
        result = {"lpips": float(np.mean(lp(a[:n], b[:n]))), "n_pairs": n}
    else:  # is
        from ag2video_torch.eval.fid import inception_score_from_probs

        _, probs = _inception_pool3(_load_images(args.path_a,
                                                 limit=args.limit,
                                                 mode=args.mode), device=dev)
        m, s = inception_score_from_probs(probs, splits=5)
        result = {"inception_mean": m, "inception_std": s}

    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
