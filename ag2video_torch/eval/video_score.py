"""Video FID / PRD over directories of generated and reference clips (port
of ag2video_tpu/eval/video_score.py).

Reference: evaluation/video/score.py:23-102 — extract clip features with a
video backbone, cache them as .npy next to each directory
(`features_{backbone}.npy`, the JAX package's file), then compute the
Frechet distance / precision-recall.

`load_clip` is a copy of the JAX function (tests/test_torch_copies.py):
`.pkl` clips ({'image': (T, H, W, 3)} or the bare array) are read with
pickle and min-max scaled per frame to [0, 1]; `.gif` / `.mp4` / `.avi`
need `imageio`, imported only when such a file is read (the card machine
has none, so there only `.pkl` clips are read); frames go through
`cv2.resize`. The backbone runs on `device` (None: the CUDA card, which
raises without one).
"""

from __future__ import annotations

import glob
import logging
import os
import pickle
from typing import List, Optional, Tuple

import numpy as np
import torch

from ag2video_torch.eval.fid import cached_features, fid_from_features
from ag2video_torch.eval.layers import eval_device, load_variables
from ag2video_torch.eval.prd import prd_from_embedding
from ag2video_torch.eval.video_backbones import (BACKBONES,
                                                 load_backbone_params)

log = logging.getLogger(__name__)


def load_clip(path: str, n_frames: int = 16,
              size: Tuple[int, int] = (112, 112)) -> Optional[np.ndarray]:
    """Load a clip from .gif/.mp4/.avi/.pkl into (T, H, W, 3) float32 in
    [0, 1], uniformly resampled to n_frames."""
    frames: List[np.ndarray] = []
    if path.endswith(".pkl"):
        with open(path, "rb") as f:
            data = pickle.load(f)
        arr = np.asarray(data["image"] if isinstance(data, dict) else data)
        frames = [arr[t] for t in range(arr.shape[0])]
        frames = [(f - f.min()) / max(f.max() - f.min(), 1e-6) for f in frames]
    else:
        import imageio

        try:
            reader = imageio.get_reader(path)
            frames = [np.asarray(f, np.float32) / 255.0 for f in reader]
        except Exception as e:
            log.warning("failed to read %s: %s", path, e)
            return None
    if not frames:
        return None
    idx = np.linspace(0, len(frames) - 1, n_frames).astype(int)
    frames = [frames[i] for i in idx]
    import cv2

    frames = [cv2.resize(np.asarray(f, np.float32), size[::-1])
              for f in frames]
    clip = np.stack(frames)
    if clip.ndim == 3:
        clip = np.repeat(clip[..., None], 3, axis=-1)
    return clip[..., :3]


class VideoFeatureExtractor:
    """Backbone wrapper with the .npy cache contract. `params`: the asset's
    tree (load_backbone_params' default asset when None, else seeded random
    weights: `random_init`)."""

    def __init__(self, backbone: str = "tsm", params=None,
                 n_frames: int = 16, size=(112, 112), batch_size: int = 8,
                 device=None):
        device = eval_device(device, "VideoFeatureExtractor")
        self.backbone = backbone
        self.n_frames = n_frames
        self.size = size
        self.batch_size = batch_size
        if params is None:
            params = load_backbone_params(backbone)
        self.model, self.random_init = load_variables(
            BACKBONES[backbone](), params, device)
        self.device = device

    def features(self, clips: np.ndarray) -> np.ndarray:
        """(B, T, H, W, 3) clips -> (B, 2048) features."""
        v = torch.as_tensor(np.asarray(clips, np.float32)).to(self.device)
        with torch.no_grad():
            return self.model(v).cpu().numpy()

    def extract_dir(self, directory: str, force: bool = False) -> np.ndarray:
        def compute():
            paths = sorted(
                p for ext in ("*.gif", "*.mp4", "*.avi", "*.pkl")
                for p in glob.glob(os.path.join(directory, ext)))
            feats = []
            batch: List[np.ndarray] = []

            def flush():
                if not batch:
                    return
                feats.append(self.features(np.stack(batch)))
                batch.clear()

            for p in paths:
                clip = load_clip(p, self.n_frames, self.size)
                if clip is None:
                    continue
                batch.append(clip)
                if len(batch) == self.batch_size:
                    flush()
            flush()
            if not feats:
                raise ValueError(f"no readable clips in {directory}")
            return np.concatenate(feats, axis=0)

        return cached_features(
            directory, compute, f"features_{self.backbone}.npy", force)


def _extractor(backbone: str, params, device) -> VideoFeatureExtractor:
    ex = VideoFeatureExtractor(backbone, params, device=device)
    if ex.random_init:
        log.warning("video backbone %s has RANDOM weights — scores are "
                    "only comparable within this configuration", backbone)
    return ex


def compute_frechet_distance(gen_dir: str, ref_dir: str,
                             backbone: str = "tsm", params=None,
                             device=None) -> float:
    """Video FID between two clip directories (reference video/score.py:43)."""
    ex = _extractor(backbone, params, device)
    return fid_from_features(ex.extract_dir(gen_dir), ex.extract_dir(ref_dir))


def compute_precision_recall(gen_dir: str, ref_dir: str,
                             backbone: str = "tsm", params=None,
                             num_clusters: int = 20, device=None):
    """Video PRD between two clip directories (reference video/score.py)."""
    ex = _extractor(backbone, params, device)
    return prd_from_embedding(
        ex.extract_dir(gen_dir), ex.extract_dir(ref_dir),
        num_clusters=num_clusters)
