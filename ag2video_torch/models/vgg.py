"""VGG19 feature extractor for the perceptual loss (port of
ag2video_tpu/models/vgg.py).

torchvision's VGG19 sliced at relu1_1 / relu2_1 / relu3_1 / relu4_1 /
relu5_1, channels-last, in fp32. Its weights are the JAX package's asset,
`assets/vgg19.npz` (HWIO `conv_{i}_kernel` and `conv_{i}_bias`, read with
numpy), when it is there; otherwise seeded random weights with flax's
initialisers, as the JAX trainer falls back to (the loss then works as a
random-projection feature loss). The weights are frozen.
"""

from __future__ import annotations

import logging
import os
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ag2video_torch.models.layers import Conv
from ag2video_torch.weights import from_flax

log = logging.getLogger(__name__)

# Channels per conv layer, 'M' = 2x2 max pool (VGG19 'E' config).
VGG19_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
             512, 512, 512, 512, "M", 512, 512, 512, 512, "M"]
# Features after the relu following these convs (0-based):
# relu1_1, relu2_1, relu3_1, relu4_1, relu5_1.
SLICE_AFTER_CONV = (0, 2, 4, 8, 12)

DEFAULT_WEIGHTS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "assets", "vgg19.npz")

RANDOM_WEIGHTS_WARNING = (
    "VGG perceptual loss is running on RANDOM weights (no "
    "assets/vgg19.npz): measured training-neutral at 256^2 "
    "(RESULTS.md) but costs ~4%% step time — pass --no_vgg_loss 1 "
    "to drop it, or port weights via scripts/port_torch_weights.py")


class VGG19Features(nn.Module):
    """x (N, H, W, 3) -> [relu1_1, relu2_1, relu3_1, relu4_1, relu5_1]."""

    def __init__(self):
        super().__init__()
        cin, i = 3, 0
        for c in VGG19_CFG:
            if c == "M":
                continue
            if i > max(SLICE_AFTER_CONV):
                break
            setattr(self, f"conv_{i}", Conv(cin, c, 3, dtype=torch.float32))
            cin, i = c, i + 1
        self.n_convs = i
        self.requires_grad_(False)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        outs, i = [], 0
        x = x.float()
        for c in VGG19_CFG:
            if i == self.n_convs:
                break
            if c == "M":
                x = F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2) \
                    .permute(0, 2, 3, 1)
                continue
            x = torch.relu(getattr(self, f"conv_{i}")(x))
            if i in SLICE_AFTER_CONV:
                outs.append(x)
            i += 1
        return outs


def load_vgg19_arrays(path: str = DEFAULT_WEIGHTS) -> Optional[dict]:
    """The asset as flax params {conv_i: {kernel, bias}}, or None."""
    if not os.path.exists(path):
        return None
    params = {}
    with np.load(path) as data:
        i = 0
        while f"conv_{i}_kernel" in data:
            params[f"conv_{i}"] = {"kernel": data[f"conv_{i}_kernel"],
                                   "bias": data[f"conv_{i}_bias"]}
            i += 1
    return params or None


def vgg19_from_arrays(arrays: dict) -> VGG19Features:
    """A VGG19Features holding the asset's convs (`load_vgg19_arrays`),
    strictly: every conv up to relu5_1. The asset's last three convs
    (scripts/port_torch_weights.py keeps all 16) lie past the last tapped
    slice and are not read, as the JAX module never reads them."""
    model = VGG19Features()
    return from_flax({"params": {f"conv_{i}": arrays[f"conv_{i}"]
                                 for i in range(model.n_convs)}}, model)
