"""Video feature backbones for video FID / PRD (port of
ag2video_tpu/eval/video_backbones.py).

Reference: evaluation/video/inception.py:36-146 extracts clip features with
either ResNeXt-101 (3D, Kinetics->UCF101; Hara et al. resnext.py) or TSM
(ResNet-50 with temporal shift; TSM/ops/temporal_shift.py). Both are
channels-last here as in the JAX package (videos (B, T, H, W, C)), in fp32,
with the flax modules' names (`layer{stage}_{block}/conv{j}`, `bn{j}`,
`downsample_conv`, `downsample_bn`; BatchNorm eps 1e-5, flax's default).
Pretrained Kinetics weights load from `assets/tsm.npz` /
`assets/resnext3d.npz` (scripts/port_torch_weights.py --net tsm|resnext3d)
when present; otherwise the extractor holds seeded random weights
(`random_init`: comparable only within one configuration, and not equal to
the JAX package's random-init features).

flax's 'SAME' at stride 2 pads (0, 1) on an even size (TSM's `conv2`, the
grouped 3-D `conv2`) and (2, 3) for ResNeXt's 7-wide stem; the 3-D max pool
pads with -inf (eval/layers.py).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ag2video_torch.eval.layers import Conv, max_pool
from ag2video_torch.models.normalization import BatchNorm
from ag2video_torch.weights import read_asset

_ASSETS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "assets")
DEFAULT_WEIGHTS = {
    "tsm": os.path.join(_ASSETS, "tsm.npz"),
    "resnext": os.path.join(_ASSETS, "resnext3d.npz"),
}


def load_backbone_params(backbone: str, path: Optional[str] = None):
    """Ported Kinetics weights from the .npz asset
    (scripts/port_torch_weights.py --net tsm|resnext3d), or None."""
    path = path or DEFAULT_WEIGHTS.get(backbone)
    if not path or not os.path.exists(path):
        return None
    return read_asset(path)


# ---------------------------------------------------------------- TSM
def temporal_shift(x: torch.Tensor, n_segments: int,
                   fold_div: int = 8) -> torch.Tensor:
    """Shift 1/fold_div channels one step back in time and 1/fold_div one
    step forward, zero-padded (reference TSM/ops/temporal_shift.py:11).

    x: (B*T, H, W, C) with T = n_segments.
    """
    BT, H, W, C = x.shape
    x = x.reshape(BT // n_segments, n_segments, H, W, C)
    fold = C // fold_div
    out = torch.zeros_like(x)
    out[:, :-1, ..., :fold] = x[:, 1:, ..., :fold]
    out[:, 1:, ..., fold:2 * fold] = x[:, :-1, ..., fold:2 * fold]
    out[..., 2 * fold:] = x[..., 2 * fold:]
    return out.reshape(BT, H, W, C)


class _Bottleneck(nn.Module):
    """The ResNet bottleneck of both backbones: 1-conv, k-conv (strided,
    grouped), 1-conv, each with BN, and a projection shortcut where the
    width or stride changes. forward's `n_segments` > 0 shifts the
    residual branch's input in time (TSM); the shortcut takes the unshifted
    input."""

    def __init__(self, cin: int, mid: int, out: int, kernel: Sequence[int],
                 stride: Tuple[int, ...], groups: int = 1):
        super().__init__()
        ones = (1,) * len(kernel)
        self.conv1 = Conv(cin, mid, ones, use_bias=False)
        self.bn1 = BatchNorm(mid)
        self.conv2 = Conv(mid, mid, kernel, stride, "SAME", use_bias=False,
                          groups=groups)
        self.bn2 = BatchNorm(mid)
        self.conv3 = Conv(mid, out, ones, use_bias=False)
        self.bn3 = BatchNorm(out)
        self.project = cin != out or any(s != 1 for s in stride)
        if self.project:
            self.downsample_conv = Conv(cin, out, ones, stride,
                                        use_bias=False)
            self.downsample_bn = BatchNorm(out)

    def forward(self, x: torch.Tensor, n_segments: int = 0) -> torch.Tensor:
        inp = x
        if n_segments:
            x = temporal_shift(x, n_segments)
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        if self.project:
            inp = self.downsample_bn(self.downsample_conv(inp))
        return torch.relu(inp + y)


class TSMResNet50(nn.Module):
    """TSN/ResNet-50 with temporal shift (reference TSM/ops/models.py:14).

    forward(video (B, T, H, W, 3)) -> (B, 2048) clip features (per-frame
    features averaged over time, the TSN consensus). The shift runs over
    the clip's own T."""

    PLAN = ((64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2))

    def __init__(self):
        super().__init__()
        self.conv1 = Conv(3, 64, (7, 7), 2, ((3, 3), (3, 3)), use_bias=False)
        self.bn1 = BatchNorm(64)
        cin = 64
        self.blocks = []
        for stage, (width, blocks, stride) in enumerate(self.PLAN):
            for b in range(blocks):
                s = stride if b == 0 else 1
                name = f"layer{stage + 1}_{b}"
                setattr(self, name, _Bottleneck(cin, width, width * 4,
                                                (3, 3), (s, s)))
                self.blocks.append(name)
                cin = width * 4

    def forward(self, video: torch.Tensor) -> torch.Tensor:
        B, T, H, W, C = video.shape
        x = video.reshape(B * T, H, W, C)
        x = torch.relu(self.bn1(self.conv1(x)))
        x = max_pool(x, (3, 3), (2, 2), ((1, 1), (1, 1)))
        for name in self.blocks:
            x = getattr(self, name)(x, T)
        feat = x.mean(dim=(1, 2))                    # (B*T, 2048)
        return feat.reshape(B, T, -1).mean(dim=1)   # TSN consensus


# ------------------------------------------------------------ ResNeXt3D
class ResNeXt3D101(nn.Module):
    """ResNeXt-101 (3D, cardinality 32) clip-feature extractor.

    forward(video (B, T, H, W, 3)) -> (B, 2048) global-average-pooled
    features. `layers` (3, 4, 23, 3) as in the Kinetics backbone the
    reference downloads (video/inception.py:36-44); the tests cut it."""

    PLAN = ((128, 256, (1, 1, 1)), (256, 512, (2, 2, 2)),
            (512, 1024, (2, 2, 2)), (1024, 2048, (2, 2, 2)))

    def __init__(self, cardinality: int = 32,
                 layers: Sequence[int] = (3, 4, 23, 3)):
        super().__init__()
        self.conv1 = Conv(3, 64, (7, 7, 7), (1, 2, 2), "SAME",
                          use_bias=False)
        self.bn1 = BatchNorm(64)
        cin = 64
        self.blocks = []
        for stage, ((mid, out, stride), blocks) in enumerate(
                zip(self.PLAN, layers)):
            for b in range(blocks):
                name = f"layer{stage + 1}_{b}"
                setattr(self, name, _Bottleneck(
                    cin, mid, out, (3, 3, 3),
                    stride if b == 0 else (1, 1, 1), groups=cardinality))
                self.blocks.append(name)
                cin = out

    def forward(self, video: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.bn1(self.conv1(video)))
        x = max_pool(x, (3, 3, 3), (2, 2, 2), "SAME")
        for name in self.blocks:
            x = getattr(self, name)(x)
        return x.mean(dim=(1, 2, 3))  # (B, 2048)


BACKBONES = {"tsm": TSMResNet50, "resnext": ResNeXt3D101}
