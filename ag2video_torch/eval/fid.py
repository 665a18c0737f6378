"""Frechet distance, Inception Score math and the feature cache (a copy of
ag2video_tpu/eval/fid.py, held equal to it by tests/test_torch_eval.py and
tests/test_torch_copies.py; numpy and scipy). One call differs:
`linalg.sqrtm` is called without `disp=False`, which newer scipy no longer
accepts; the square root it returns is the same.

Reference: evaluation/fid/fid_score.py (TTUR image FID),
evaluation/video/metrics/frechet_distance.py:5-65 and
inception_score.py:4-12 (video metrics), evaluation/video/score.py:23-102
(the .npy feature-cache contract next to generated dirs).
"""

from __future__ import annotations

import os
from typing import Callable, Tuple

import numpy as np
from scipy import linalg


def compute_statistics(features: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(mu, sigma) of (N, D) features."""
    mu = np.mean(features, axis=0)
    sigma = np.cov(features, rowvar=False)
    return mu, sigma


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """FID between two Gaussians (reference fid_score.py TTUR math)."""
    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    diff = mu1 - mu2

    # sqrtm without `disp` (newer scipy removed it; the matrix is the same)
    covmean = linalg.sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            raise ValueError(
                f"Imaginary component {np.max(np.abs(covmean.imag))}")
        covmean = covmean.real

    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2)
                 - 2 * np.trace(covmean))


def fid_from_features(f1: np.ndarray, f2: np.ndarray) -> float:
    m1, s1 = compute_statistics(f1)
    m2, s2 = compute_statistics(f2)
    return frechet_distance(m1, s1, m2, s2)


def inception_score_from_probs(probs: np.ndarray,
                               splits: int = 5) -> Tuple[float, float]:
    """Split-KL IS (reference evaluation/inception.py:35-49)."""
    N = probs.shape[0]
    scores = []
    for i in range(splits):
        part = probs[i * N // splits:(i + 1) * N // splits]
        if part.shape[0] == 0:
            continue
        py = np.mean(part, axis=0, keepdims=True)
        kl = part * (np.log(part + 1e-12) - np.log(py + 1e-12))
        scores.append(np.exp(np.mean(np.sum(kl, axis=1))))
    return float(np.mean(scores)), float(np.std(scores))


def cached_features(
    directory: str,
    extractor: Callable[[], np.ndarray],
    cache_name: str = "features.npy",
    force: bool = False,
) -> np.ndarray:
    """The reference's feature-cache contract: features saved as .npy next
    to the generated/reference dir (video/score.py:27-31)."""
    path = os.path.join(directory, cache_name)
    if os.path.exists(path) and not force:
        return np.load(path)
    feats = np.asarray(extractor())
    np.save(path, feats)
    return feats
