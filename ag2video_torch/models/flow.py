"""Optical-flow generator (port of ag2video_tpu/models/flow.py).

Encoder (one stride-1 + n_downsample_F stride-2 NormConvs) -> n_blocks_F
residual blocks -> nearest-upsample decoder; heads: flow (2 ch, scaled by
flow_multiplier, returned fp32) and weight (1 ch sigmoid, unused by the
generator). The stride-2 convs pad flax-'SAME' style, (0, 1) on even sizes
(layers.conv2d_nhwc).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ag2video_torch.models.layers import Conv, leaky_relu_02, upsample_nearest
from ag2video_torch.models.normalization import BatchNorm, NormConv, SNConv


class FlowResBlock(nn.Module):
    """BN -> lrelu -> spectral conv, twice; identity shortcut."""

    def __init__(self, features: int, norm: str = "spectralsyncbatch",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        spectral = "spectral" in norm
        sub = norm.replace("spectral", "")
        if "batch" in sub:
            self.bn_0 = BatchNorm(features, dtype=dtype)
            self.bn_1 = BatchNorm(features, dtype=dtype)
        elif sub in ("", "none"):
            self.bn_0 = self.bn_1 = None
        else:
            raise NotImplementedError(
                f"FlowResBlock norm {norm!r} is not ported yet (ROADMAP)")
        self.conv_0 = SNConv(features, features, 3, spectral=spectral,
                             dtype=dtype)
        self.conv_1 = SNConv(features, features, 3, spectral=spectral,
                             dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dx = x if self.bn_0 is None else self.bn_0(x)
        dx = self.conv_0(leaky_relu_02(dx))
        dx = dx if self.bn_1 is None else self.bn_1(dx)
        dx = self.conv_1(leaky_relu_02(dx))
        return x + dx


class FlowsGenerator(nn.Module):
    """Reference FlowsGenerator (flows_generator.py:13-68)."""

    def __init__(self, in_features: int, nff: int = 32, n_blocks_F: int = 6,
                 n_downsample_F: int = 3, norm_F: str = "spectralsyncbatch",
                 flow_multiplier: float = 20.0, flow_deconv: bool = False,
                 nf_max: int = 1024, dtype: Optional[torch.dtype] = None):
        super().__init__()
        if flow_deconv:
            raise NotImplementedError(
                "flow_deconv (ConvTranspose decoder) is not ported yet "
                "(ROADMAP)")
        nd = n_downsample_F
        ch = [min(nf_max, nff * (2 ** i)) for i in range(nd + 1)]
        self.nd, self.n_blocks = nd, n_blocks_F
        self.flow_multiplier = flow_multiplier
        self.down_0 = NormConv(in_features, nff, norm_F, 3, dtype=dtype)
        for i in range(nd):
            setattr(self, f"down_{i + 1}",
                    NormConv(ch[i], ch[i + 1], norm_F, 3, stride=2,
                             dtype=dtype))
        for i in range(n_blocks_F):
            setattr(self, f"res_{i}", FlowResBlock(ch[nd], norm_F, dtype))
        for j, i in enumerate(reversed(range(nd))):
            setattr(self, f"up_{j}",
                    NormConv(ch[i + 1], ch[i], norm_F, 3, dtype=dtype))
        self.conv_flow = Conv(ch[0], 2, 3, dtype=dtype)
        self.conv_w = Conv(ch[0], 1, 3, dtype=dtype)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, H, W, C) -> (weight (B, H, W, 1), flow (B, H, W, 2) fp32)."""
        x = leaky_relu_02(self.down_0(x))
        for i in range(self.nd):
            x = leaky_relu_02(getattr(self, f"down_{i + 1}")(x))
        for i in range(self.n_blocks):
            x = getattr(self, f"res_{i}")(x)
        for j in range(self.nd):
            x = leaky_relu_02(getattr(self, f"up_{j}")(upsample_nearest(x)))
        flow = self.conv_flow(x) * self.flow_multiplier
        weight = torch.sigmoid(self.conv_w(x))
        return weight, flow.float()
