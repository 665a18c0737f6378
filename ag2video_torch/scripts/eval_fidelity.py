"""Offline fidelity scoring of checkpoints (port of scripts/eval_fidelity.py).

For each `itr_<t>/` checkpoint of a run, generates frames on the val split
conditioned on GT boxes (use_gt=True: pixel quality apart from layout error,
the reference's train-time Inception contract, scripts/train.py:175,247)
and reports feature-FID(generated, real) and presence accuracy under the
synthetic-calibrated backbone (eval/backbone.py). Control rows calibrate
the scale: real-vs-real (the floor) and noise-vs-real (the ceiling).

    python -m ag2video_torch.scripts.eval_fidelity --run_dir output/run1 \
        [--checkpoints all|full|latest] [--num_samples 64] [--batch_size 4]

The JAX CLI's flags, plus `--device` (default: the CUDA card, which raises
without one; `cpu` for the CPU). Writes `fidelity.json` (`--out`, default
`<run_dir>/fidelity.json`), creating its directory, and prints the
checkpoint rows as one JSON line.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

log = logging.getLogger("eval_fidelity")


def list_checkpoints(run_dir: str, which: str) -> List[Tuple[int, str]]:
    """The port's `itr_<t>/` checkpoints of `run_dir`, oldest first, as
    (t, path): all, only the full ones, or the newest."""
    from ag2video_torch.train import checkpoint as ckpt_lib

    if which == "latest":
        path = ckpt_lib.latest_checkpoint(run_dir)
        return [] if path is None else [
            (int(os.path.basename(path)[len("itr_"):]), path)]
    paths = []
    for name in os.listdir(run_dir):
        m = re.fullmatch(r"itr_(\d+)", name)
        path = os.path.join(run_dir, name)
        if m and ckpt_lib.is_port_checkpoint(path):
            paths.append((int(m.group(1)), path))
    paths.sort()
    if which == "full":
        paths = [(t, p) for t, p in paths
                 if not ckpt_lib.is_light_checkpoint(p)]
    return paths


def score_checkpoint(path, cfg, vocab, loader, scorer, num_samples,
                     device=None) -> Dict[str, float]:
    """FID and presence accuracy of one checkpoint's use_gt frames on
    `loader`'s first `num_samples` clips."""
    from ag2video_torch.eval.backbone import presence_labels
    from ag2video_torch.inference.generate import GenerationSession

    sess = GenerationSession(os.path.dirname(path), checkpoint=path,
                             device=device).load()
    scorer.clean()
    ncond = cfg.n_frames_G - 1
    n = 0
    for batch in loader.epoch(0):
        imgs_pred, _ = sess.generate(batch, use_gt=True)
        fake = imgs_pred[:, ncond:]
        T = fake.shape[1]
        objs = np.asarray(batch.objs)
        pres = presence_labels({"shape": objs[..., 0],
                                "color": objs[..., 1]})
        scorer.add_fake(fake.reshape((-1,) + fake.shape[2:]),
                        presence=np.repeat(pres, T, axis=0))
        real = np.asarray(batch.imgs)[:, ncond:]
        scorer.add_real(real.reshape((-1,) + real.shape[2:]))
        n += batch.imgs.shape[0]
        if n >= num_samples:
            break
    return scorer.compute()


def control_rows(cfg, loader, scorer, num_samples) -> Dict[str, Dict]:
    """real-vs-real (floor) and noise-vs-real (ceiling) on the same val
    frames: the scale FID numbers should be read against."""
    from ag2video_torch.eval.backbone import presence_labels

    frames, press = [], []
    n = 0
    ncond = cfg.n_frames_G - 1
    for batch in loader.epoch(0):
        f = np.asarray(batch.imgs)[:, ncond:]
        objs = np.asarray(batch.objs)
        pres = presence_labels({"shape": objs[..., 0],
                                "color": objs[..., 1]})
        press.append(np.repeat(pres, f.shape[1], axis=0))
        frames.append(f.reshape((-1,) + f.shape[2:]))
        n += batch.imgs.shape[0]
        if n >= num_samples:
            break
    frames = np.concatenate(frames)
    press = np.concatenate(press)
    half = frames.shape[0] // 2

    scorer.clean()
    scorer.add_fake(frames[:half], presence=press[:half])
    scorer.add_real(frames[half:])
    rr = scorer.compute()

    rng = np.random.RandomState(0)
    noise = rng.randn(*frames[:half].shape).astype(np.float32)
    scorer.clean()
    scorer.add_fake(noise, presence=press[:half])
    scorer.add_real(frames[half:])
    nz = scorer.compute()
    return {"real_vs_real": rr, "noise_vs_real": nz}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--run_dir", required=True)
    p.add_argument("--checkpoints", default="all",
                   choices=["all", "full", "latest"])
    p.add_argument("--partition", default="val")
    p.add_argument("--num_samples", type=int, default=64)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--backbone", default="")
    p.add_argument("--out", default="")
    p.add_argument("--device", type=str, default=None,
                   help="torch device; default the CUDA card (cpu: the CPU)")
    return p


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    """Score the run's checkpoints -> the results written to fidelity.json."""
    from ag2video_torch.config import Config
    from ag2video_torch.data.registry import Loader, get_dataset
    from ag2video_torch.eval.backbone import (DEFAULT_WEIGHTS, FidelityScore,
                                              load_backbone)

    args = build_parser().parse_args(argv)
    loaded = load_backbone(args.backbone or DEFAULT_WEIGHTS)
    if loaded is None:
        raise SystemExit("no backbone asset: assets/synthetic_backbone.npz "
                         "(or --backbone) is needed")
    params, meta = loaded
    log.info("backbone meta: %s", {k: v for k, v in meta.items()
                                   if k != "history"})
    scorer = FidelityScore(params, device=args.device)

    cfg, vocab = Config.load_run_args(args.run_dir)
    cfg = cfg.replace(batch_size=args.batch_size)
    ds = get_dataset(cfg.dataset, args.partition, cfg)
    loader = Loader(ds, cfg, shuffle=False, drop_last=False)

    results = {"controls": control_rows(cfg, loader, scorer,
                                        args.num_samples)}
    log.info("controls: %s", results["controls"])

    rows = []
    for t, path in list_checkpoints(args.run_dir, args.checkpoints):
        m = score_checkpoint(path, cfg, vocab, loader, scorer,
                             args.num_samples, device=args.device)
        m["step"] = t
        rows.append(m)
        log.info("itr_%d: %s", t, m)
    results["checkpoints"] = rows

    out = args.out or os.path.join(args.run_dir, "fidelity.json")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(results, f, indent=1)
    log.info("wrote %s", out)
    print(json.dumps(results["checkpoints"]))
    return results


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    main()
