"""ImageNet normalisation of frames (the part of
ag2video_tpu/data/transforms.py that generation and the synthetic dataset
need, held equal to it by
tests/test_torch_copies.py). The clip transforms come with the dataset
loaders (ROADMAP)."""

from __future__ import annotations

import numpy as np

IMG_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMG_STD = np.array([0.229, 0.224, 0.225], np.float32)


def denormalize(img: np.ndarray) -> np.ndarray:
    """ImageNet-normalized -> [0, 1] (reference data/utils.py deprocess)."""
    return np.clip(np.asarray(img) * IMG_STD + IMG_MEAN, 0.0, 1.0)
