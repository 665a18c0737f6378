"""Layout-quality evaluation: graph model vs the rule-based baseline (port
of scripts/eval_iou.py).

The working version of the reference's broken `scripts/test_iou.py` (which
imports a nonexistent RuleBasedModel). Loads a run, rolls out boxes from
frame-0 seeds on the val/test split, and reports avg IoU / IoU@0.5 /
IoU@0.3 for both the learned graph model and the rule baseline
(models/rule_baseline.py); `--sweep composition` scores zero-shot composed
and timing-shifted action graphs against the rule oracle, `--sweep horizon`
rollouts at 2x / 4x the training clip length.

    python -m ag2video_torch.scripts.eval_iou --checkpoint output/run1 \
        [--partition val] [--sweep composition|horizon] [--device cpu]

The JAX CLI's arguments and JSON keys; `--device` (default: the CUDA
card, which raises without one; `cpu` for the CPU) replaces its
`--platform`. `--checkpoint` is a run directory (with run_args.json) or
an `itr_*` path inside one.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
from typing import Optional, Sequence

import numpy as np
import torch

log = logging.getLogger("eval_iou")


def _on(sess, *arrays):
    """numpy arrays -> tensors on the session model's device."""
    dev = next(sess.model.parameters()).device
    return tuple(torch.as_tensor(np.array(a)).to(dev) for a in arrays)


def _rule(sess, batch, actions):
    """The rule baseline's boxes for `batch` under `actions` (numpy)."""
    from ag2video_torch.models.rule_baseline import rule_based_boxes

    objs, trip, acts, boxes = _on(sess, batch.objs, batch.triplets,
                                  np.asarray(actions, np.float32),
                                  batch.boxes)
    return rule_based_boxes(objs, trip, acts, boxes,
                            sess.vocab).cpu().numpy()


def _iou(sess, pred, want, mask):
    """iou_stats of numpy boxes -> 4 floats."""
    from ag2video_torch.ops.metrics import iou_stats

    return np.array([float(s) for s in iou_stats(*_on(sess, pred, want,
                                                      mask))])


def composition_variants(batch, vocab):
    """Zero-shot composition variants of a batch's action tensor
    (reference timing-shift contract scripts/test.py:249-275). Returns
    ({name: (B, A, 7) actions}, {"composed": n, "simultaneous": n}).

    On the LINEAR synthetic dynamics the rule baseline is the analytic
    oracle for ANY action tensor, so rule_based_boxes(variant) gives the
    expected layout and IoU(model rollout, rule rollout) measures whether
    the model executes the recomposed program."""
    pad_act = vocab["action_name_to_idx"]["__padding__"]
    slide = vocab["action_name_to_idx"]["_slide"]
    a0 = np.asarray(batch.actions, np.float32).copy()
    real = a0[..., 1] != pad_act                       # (B, A)

    out = {"original": a0}
    b = a0.copy()                                      # test.py:249-251
    b[..., 3] = np.where(real, 0.0, b[..., 3])
    b[..., 4] = np.where(real, 3.0, b[..., 4])
    out["timing_before"] = b
    c = a0.copy()                                      # test.py:263-265
    c[..., 3] = np.where(real, -2.0, c[..., 3])
    c[..., 4] = np.where(real, 1.0, c[..., 4])
    out["timing_after"] = c

    # Composed multi-action graph: a NEW _slide row (never seen with this
    # sample) on an un-acted real object, into a padding slot.
    d = a0.copy()
    objs = np.asarray(batch.objs)
    counts = {"composed": 0, "simultaneous": 0}
    for i in range(d.shape[0]):
        slots = np.where(~real[i])[0]
        n_real_obj = int((objs[i, :, 0] != 0).sum())
        acted = {int(s) for s in a0[i][real[i]][:, 0]}
        free_objs = [o for o in range(n_real_obj) if o not in acted]
        if len(slots) and free_objs:
            d[i, slots[0]] = [free_objs[0], slide, free_objs[0],
                              0.0, 1.0, 0.15, 0.15]
            counts["composed"] += 1
    out["composed"] = d

    # Simultaneous composition: a SECOND _slide on an already-acted object
    # with a fully overlapping window but a different target; the rule
    # oracle mixes concurrent movers' targets by progress.
    e = a0.copy()
    for i in range(e.shape[0]):
        slots = np.where(~real[i])[0]
        rows = np.where(real[i])[0]
        if len(slots) and len(rows):
            subj = float(a0[i, rows[0], 0])
            e[i, slots[0]] = [subj, slide, subj, 0.0, 1.0, 0.85, 0.2]
            counts["simultaneous"] += 1
    out["simultaneous"] = e
    return out, counts


def _frame_mask(batch, boxes):
    mask = (np.asarray(batch.objs)[..., 0] != 0)[:, None, :]
    return np.broadcast_to(mask, np.asarray(boxes)[:, 1:].shape[:-1])


def run_composition_sweep(sess, loader, num_samples):
    """Per variant: model rollout under the modified actions vs the
    analytic (rule) expectation under the SAME actions."""
    totals = {}
    n = 0
    composed_n = {"composed": 0, "simultaneous": 0}
    for batch in loader.epoch(0):
        variants, nc = composition_variants(batch, sess.vocab)
        for k, v in nc.items():
            composed_n[k] += v
        mask = _frame_mask(batch, batch.boxes)
        gt = np.asarray(batch.boxes)
        for name, acts in variants.items():
            expected = _rule(sess, batch, acts)
            # layout_only: box IoU never reads pixels.
            _, pred = sess.generate(batch, actions=acts, layout_only=True)
            pred = np.clip(pred, 0.0, 1.0)
            pairs = {"model_vs_expected": (pred, expected)}
            if name == "original":
                pairs["model_vs_gt"] = (pred, gt)
                pairs["rule_vs_gt"] = (expected, gt)
            for tag, (x, y) in pairs.items():
                key = f"{name}/{tag}"
                totals[key] = totals.get(key, np.zeros(4)) + _iou(
                    sess, x[:, 1:], y[:, 1:], mask)
        n += batch.imgs.shape[0]
        if n >= num_samples:
            break

    result = {}
    for key, t in sorted(totals.items()):
        d = max(t[3], 1.0)
        result[key] = {"avg_iou": round(t[0] / d, 4),
                       "iou@0.5": round(t[1] / d, 4),
                       "iou@0.3": round(t[2] / d, 4)}
    result["n_videos"] = n
    result["n_composed"] = composed_n
    return result


def extended_batch(batch, factor: int):
    """A batch whose time axis is `factor` x longer: triplets tile (they
    are constant per frame), boxes keep only the frame-0 seed, imgs repeat
    frame 0 (the no-use_gt rollout reads nothing past the seed). The action
    clock normalizes rel to the clip length, so the original actions run in
    slow motion over the whole extended clip."""
    f = int(factor)
    trip = np.repeat(np.asarray(batch.triplets), f, axis=1)[
        :, :f * batch.triplets.shape[1]]
    T2 = trip.shape[1]
    boxes = np.zeros(
        (batch.boxes.shape[0], T2) + batch.boxes.shape[2:], np.float32)
    boxes[:, 0] = np.asarray(batch.boxes)[:, 0]
    imgs = np.broadcast_to(
        np.asarray(batch.imgs)[:, :1],
        (batch.imgs.shape[0], T2) + batch.imgs.shape[2:]).copy()
    return dataclasses.replace(batch, imgs=imgs, boxes=boxes, triplets=trip)


def run_horizon_sweep(sess, loader, num_samples, factors=(2, 4),
                      gifs_dir=None, gifs_n=2):
    """Long-horizon rollout beyond training length (the reference's
    extended-clock contract, scripts/test.py:251). Two regimes per factor k:

      slowmo_kx — original actions on a k*F-frame rollout: the action
        executes over the whole window at 1/k the per-frame velocity;
      hold_kx   — extend_horizon(actions, k) on a k*F rollout: the action
        completes at frame F, then every object must HOLD still.

    Scored against the rule oracle at the same T', with the per-frame IoU
    trajectory."""
    from ag2video_torch.inference.actions import extend_horizon
    from ag2video_torch.utils.vis import plot_vid, save_gif

    totals = {}
    per_frame = {}
    n = 0
    for batch in loader.epoch(0):
        variants = [("baseline_1x", batch, np.asarray(batch.actions))]
        for k in factors:
            ext = extended_batch(batch, k)
            variants.append((f"slowmo_{k}x", ext, np.asarray(ext.actions)))
            held = np.stack([extend_horizon(a, float(k))
                             for a in np.asarray(ext.actions)])
            variants.append((f"hold_{k}x", ext, held))
        if gifs_dir and n == 0:
            # Full pixel synthesis for the first gifs_n videos per variant.
            for name, b, acts in variants:
                imgs_pred, boxes_pred = sess.generate(b, actions=acts)
                for i in range(min(gifs_n, imgs_pred.shape[0])):
                    fn = os.path.join(gifs_dir, name,
                                      f"{b.video_ids[i]}.gif")
                    save_gif(plot_vid(imgs_pred[i],
                                      np.clip(boxes_pred[i], 0, 1)), fn)
                    log.info("wrote %s", fn)
        for name, b, acts in variants:
            expected = _rule(sess, b, acts)
            _, pred = sess.generate(b, actions=acts, layout_only=True)
            pred = np.clip(pred, 0.0, 1.0)
            mask = _frame_mask(batch, b.boxes)
            totals[name] = totals.get(name, np.zeros(4)) + _iou(
                sess, pred[:, 1:], expected[:, 1:], mask)
            # Per-frame mean IoU: where does coherence degrade?
            T = pred.shape[1]
            pf = np.zeros(T - 1)
            for t in range(1, T):
                s = _iou(sess, pred[:, t:t + 1], expected[:, t:t + 1],
                         mask[:, :1])
                pf[t - 1] = s[0] / max(s[3], 1.0)
            per_frame[name] = per_frame.get(name, np.zeros(T - 1)) + pf
        n += batch.imgs.shape[0]
        if n >= num_samples:
            break

    n_batches = max(1, int(np.ceil(n / batch.imgs.shape[0])))
    result = {}
    for key, t in sorted(totals.items()):
        d = max(t[3], 1.0)
        result[key] = {"avg_iou": round(t[0] / d, 4),
                       "iou@0.5": round(t[1] / d, 4),
                       "iou@0.3": round(t[2] / d, 4),
                       "per_frame_iou": [round(v / n_batches, 4)
                                         for v in per_frame[key]]}
    result["n_videos"] = n
    return result


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--partition", default="val", choices=["val", "test"])
    p.add_argument("--num_samples", type=int, default=64)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--gifs_dir", default=None,
                   help="horizon sweep: also write full-pixel GIFs of the "
                        "first videos per variant here")
    p.add_argument("--sweep", default=None,
                   choices=[None, "composition", "horizon"],
                   help="composition: score zero-shot composed/timing-"
                        "shifted action graphs against the analytic "
                        "expectation (linear synthetic only); horizon: "
                        "rollouts at 2x/4x the training clip length "
                        "(slow-motion + execute-then-hold regimes)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device; default the CUDA card (cpu: the CPU)")
    return p


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Score a run -> the printed JSON's dict."""
    from ag2video_torch.data.registry import Loader, get_dataset
    from ag2video_torch.inference.generate import GenerationSession

    args = build_parser().parse_args(argv)
    run_dir = args.checkpoint
    if not os.path.exists(os.path.join(run_dir, "run_args.json")):
        run_dir = os.path.dirname(args.checkpoint)
    sess = GenerationSession(run_dir, checkpoint=args.checkpoint,
                             overrides={"batch_size": args.batch_size},
                             device=args.device).load()
    ds = get_dataset(sess.cfg.dataset, args.partition, sess.cfg)
    loader = Loader(ds, sess.cfg, batch_size=args.batch_size, shuffle=False,
                    drop_last=False)

    # The eval contract: sweep numbers are only comparable across runs
    # when the video set AND the eval batch are identical.
    contract = {"partition": args.partition, "num_samples": args.num_samples,
                "batch_size": args.batch_size,
                "checkpoint": os.path.abspath(args.checkpoint)}
    if args.sweep is not None:
        if args.sweep == "composition":
            result = run_composition_sweep(sess, loader, args.num_samples)
        else:
            result = run_horizon_sweep(sess, loader, args.num_samples,
                                       gifs_dir=args.gifs_dir)
        result["eval_contract"] = contract
        print(json.dumps(result, indent=2))
        return result

    totals = {"model": np.zeros(4), "rule": np.zeros(4)}
    n = 0
    for batch in loader.epoch(0):
        _, boxes_pred = sess.generate(batch, layout_only=True)
        boxes_pred = np.clip(boxes_pred, 0.0, 1.0)
        rule_pred = _rule(sess, batch, batch.actions)
        mask = _frame_mask(batch, batch.boxes)
        gt = np.asarray(batch.boxes)[:, 1:]
        for name, pred in (("model", boxes_pred), ("rule", rule_pred)):
            totals[name] += _iou(sess, pred[:, 1:], gt, mask)
        n += batch.imgs.shape[0]
        if n >= args.num_samples:
            break

    result = {}
    for name, t in totals.items():
        d = max(t[3], 1.0)
        result[name] = {"avg_iou": t[0] / d, "iou@0.5": t[1] / d,
                        "iou@0.3": t[2] / d}
    result["n_videos"] = n
    print(json.dumps(result, indent=2))
    return result


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    main()
