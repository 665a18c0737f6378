"""Action-distribution metrics over a classifier's predictions (a copy of
ag2video_tpu/eval/action_metrics.py, held to it by
tests/test_torch_copies.py; numpy and scipy).

Reference: evaluation/fid.py:10-93 — per-sample KL to the marginal
(inception-style I-score), intra/inter entropies (overall and per action
class), row-normalized confusion matrix, and per-class FID over classifier
features.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
from scipy import stats

from ag2video_torch.eval.fid import frechet_distance


def kl_discrete(p: np.ndarray, q: np.ndarray) -> float:
    """D(P||Q), ignoring zero-mass support of q (reference fid.py:10-21)."""
    p = np.asarray(p, float)
    q = np.asarray(q, float)
    keep = q != 0
    p, q = p[keep], q[keep]
    with np.errstate(divide="ignore", invalid="ignore"):
        return float(np.sum(np.where(p != 0, p * np.log(p / q), 0.0)))


def quant(pred_dist: np.ndarray, action_set: Sequence[str]
          ) -> Tuple[float, float, float, Dict[str, float]]:
    """(I_score, mean intra-entropy, inter-entropy, per-class intra-entropy)
    (reference quant, fid.py:24-54)."""
    overall = np.mean(pred_dist, axis=0)
    pred_class = np.argmax(pred_dist, axis=1)

    klds, intra, per_class = [], [], {}
    for i in range(len(pred_dist)):
        e = float(stats.entropy(pred_dist[i]))
        klds.append(kl_discrete(pred_dist[i], overall))
        intra.append(e)
        cls = action_set[pred_class[i] % len(action_set)]
        per_class.setdefault(cls, []).append(e)

    i_score = float(np.exp(np.mean(klds)))
    per_class = {k: float(np.mean(v)) for k, v in per_class.items()}
    return i_score, float(np.mean(intra)), float(stats.entropy(overall)), per_class


def confusion_matrix(num_classes: int, pred_cat: np.ndarray,
                     gt_cat: np.ndarray) -> np.ndarray:
    """Row-normalized (percent) confusion matrix (reference fid.py:57-65)."""
    m = np.zeros((num_classes, num_classes))
    for p, g in zip(pred_cat, gt_cat):
        m[g, p] += 1
    totals = m.sum(axis=1, keepdims=True)
    return np.where(totals > 0, m / totals * 100.0, 0.0)


def per_class_fid(train_feature: np.ndarray, test_feature: np.ndarray,
                  train_cat: np.ndarray, test_cat: np.ndarray,
                  full: bool = True) -> float:
    """Mean per-class Frechet distance between feature sets (reference
    get_fid, fid.py:77-93 — which comments out the covariance term; `full`
    restores the real FID, full=False reproduces the mean-only variant)."""
    distances = []
    for cls in np.unique(test_cat):
        tr = train_feature[train_cat == cls]
        te = test_feature[test_cat == cls]
        if len(tr) < 2 or len(te) < 2:
            continue
        if full:
            mu1, s1 = tr.mean(0), np.cov(tr, rowvar=False)
            mu2, s2 = te.mean(0), np.cov(te, rowvar=False)
            distances.append(frechet_distance(mu1, s1, mu2, s2))
        else:
            distances.append(float(np.linalg.norm(te.mean(0) - tr.mean(0)) ** 2))
    return float(np.mean(distances)) if distances else float("nan")
