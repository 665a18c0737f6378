"""Precision-Recall Distributions (PRD) for generative models (a copy of
ag2video_tpu/eval/prd.py, held to it by tests/test_torch_copies.py; numpy
and scipy).

Reference: evaluation/video/metrics/precision_recall_distributions.py
(vendored from compare_gan; Sajjadi et al. 2018). Computes PRD curves from
cluster-histogram distributions of real/generated embeddings.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def compute_prd(eval_dist: np.ndarray, ref_dist: np.ndarray,
                num_angles: int = 1001, epsilon: float = 1e-10
                ) -> Tuple[np.ndarray, np.ndarray]:
    """PRD curve from two discrete distributions over the same support."""
    if not (epsilon > 0 and epsilon < 0.1):
        raise ValueError("epsilon must be in (0, 0.1]")
    if not (num_angles >= 10 and num_angles <= 1_000_000):
        raise ValueError("num_angles must be in [10, 1e6]")

    angles = np.linspace(epsilon, np.pi / 2 - epsilon, num=num_angles)
    slopes = np.tan(angles)

    slopes_2d = np.expand_dims(slopes, 1)
    ref_dist_2d = np.expand_dims(ref_dist, 0)
    eval_dist_2d = np.expand_dims(eval_dist, 0)

    precision = np.minimum(ref_dist_2d * slopes_2d, eval_dist_2d).sum(axis=1)
    recall = precision / slopes
    return np.clip(precision, 0, 1), np.clip(recall, 0, 1)


def _cluster_into_bins(eval_data: np.ndarray, ref_data: np.ndarray,
                       num_clusters: int, seed: int = 0):
    """K-means histogram binning of joint embeddings."""
    from scipy.cluster.vq import kmeans2

    data = np.vstack([eval_data, ref_data]).astype(np.float64)
    _, labels = kmeans2(data, num_clusters, minit="++", seed=seed)
    eval_labels = labels[:len(eval_data)]
    ref_labels = labels[len(eval_data):]
    eval_bins = np.histogram(eval_labels, bins=num_clusters,
                             range=[0, num_clusters], density=True)[0]
    ref_bins = np.histogram(ref_labels, bins=num_clusters,
                            range=[0, num_clusters], density=True)[0]
    return eval_bins / max(eval_bins.sum(), 1e-12), \
        ref_bins / max(ref_bins.sum(), 1e-12)


def prd_from_embedding(eval_data: np.ndarray, ref_data: np.ndarray,
                       num_clusters: int = 20, num_angles: int = 1001,
                       num_runs: int = 10, seed: int = 0):
    """PRD from embeddings, averaged over clustering runs (reference
    compute_precision_recall, video/score.py)."""
    precisions, recalls = [], []
    for i in range(num_runs):
        e_bins, r_bins = _cluster_into_bins(eval_data, ref_data,
                                            num_clusters, seed + i)
        p, r = compute_prd(e_bins, r_bins, num_angles)
        precisions.append(p)
        recalls.append(r)
    return np.mean(precisions, axis=0), np.mean(recalls, axis=0)


def prd_to_max_f_beta_pair(precision: np.ndarray, recall: np.ndarray,
                           beta: float = 8.0) -> Tuple[float, float]:
    """(F_beta, F_1/beta) summary (compare_gan convention)."""
    b2 = beta ** 2
    f_beta = np.max((1 + b2) * precision * recall /
                    (b2 * precision + recall + 1e-12))
    f_beta_inv = np.max((1 + 1 / b2) * precision * recall /
                        (precision / b2 + recall + 1e-12))
    return float(f_beta), float(f_beta_inv)
