"""LPIPS perceptual distance, net-lin over AlexNet features (port of
ag2video_tpu/eval/lpips.py).

Reference: evaluation/PerceptualSimilarity/ (vendored richzhang code):
PerceptualLoss('net-lin','alex') — AlexNet conv features, per-layer unit
normalization, learned 1x1 linear calibration weights, spatial mean, layer
sum. Weights load from `assets/lpips_alex.npz` (flat `conv{i}_kernel` HWIO,
`conv{i}_bias`, `lin{i}`; scripts/port_torch_weights.py) when present;
otherwise uniform `1/c` calibration weights over seeded random features
(`random_init`: comparable only within one configuration, and not equal to
the JAX package's random-init distances).
"""

from __future__ import annotations

import os
from typing import List

import numpy as np
import torch
from torch import nn

from ag2video_torch.eval.layers import (Conv, eval_device, load_variables,
                                        max_pool)

DEFAULT_WEIGHTS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "assets", "lpips_alex.npz",
)

# LPIPS input scaling (richzhang ScalingLayer).
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


class AlexNetFeatures(nn.Module):
    """torchvision AlexNet feature extractor, returning the 5 conv-relu
    stages LPIPS taps (explicit conv pads, VALID 3x3 stride-2 max pools)."""

    def __init__(self):
        super().__init__()
        self.conv0 = Conv(3, 64, (11, 11), 4, ((2, 2), (2, 2)))
        self.conv1 = Conv(64, 192, (5, 5), 1, ((2, 2), (2, 2)))
        self.conv2 = Conv(192, 384, (3, 3))
        self.conv3 = Conv(384, 256, (3, 3))
        self.conv4 = Conv(256, 256, (3, 3))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        outs = []
        for i in range(5):
            if i in (1, 2):
                x = max_pool(x, (3, 3), (2, 2))
            x = torch.relu(getattr(self, f"conv{i}")(x))
            outs.append(x)
        return outs


def _unit_normalize(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    norm = torch.sqrt(torch.sum(x ** 2, dim=-1, keepdim=True))
    return x / (norm + eps)


class LPIPS:
    """lpips(x, y) over (N, H, W, 3) images in [-1, 1]; `device`: None means
    the CUDA card, which raises without one."""

    CHANNELS = (64, 192, 384, 256, 256)

    def __init__(self, weights_path: str = DEFAULT_WEIGHTS, device=None):
        device = eval_device(device, "LPIPS")
        self.lin_weights = [np.ones((c,), np.float32) / c
                            for c in self.CHANNELS]
        params = None
        if os.path.exists(weights_path):
            with np.load(weights_path) as data:
                params = {f"conv{i}": {"kernel": data[f"conv{i}_kernel"],
                                       "bias": data[f"conv{i}_bias"]}
                          for i in range(5)}
                self.lin_weights = [np.asarray(data[f"lin{i}"], np.float32)
                                    for i in range(5)]
        self.net, self.random_init = load_variables(
            AlexNetFeatures(), None if params is None else {"params": params},
            device)
        self.device = device
        self._shift = torch.from_numpy(_SHIFT).to(device)
        self._scale = torch.from_numpy(_SCALE).to(device)
        self._lins = [torch.from_numpy(w).to(device)
                      for w in self.lin_weights]

    def distance(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """(N,) distances of two (N, H, W, 3) tensors on the device."""
        fx = self.net((x - self._shift) / self._scale)
        fy = self.net((y - self._shift) / self._scale)
        total = 0.0
        for f1, f2, w in zip(fx, fy, self._lins):
            d = (_unit_normalize(f1) - _unit_normalize(f2)) ** 2
            # learned 1x1 conv == channel-weighted sum; then spatial mean.
            total = total + torch.mean(torch.sum(d * w, dim=-1), dim=(1, 2))
        return total

    def __call__(self, x, y) -> np.ndarray:
        x = torch.as_tensor(np.asarray(x, np.float32)).to(self.device)
        y = torch.as_tensor(np.asarray(y, np.float32)).to(self.device)
        with torch.no_grad():
            return self.distance(x, y).cpu().numpy()

    def video_pair_distance(self, vid_a: np.ndarray, vid_b: np.ndarray) -> float:
        """Mean per-frame LPIPS between two (T, H, W, 3) videos (reference
        compute_dists_videos.py)."""
        return float(np.mean(self(vid_a, vid_b)))
