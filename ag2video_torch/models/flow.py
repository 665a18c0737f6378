"""Optical-flow generator (port of ag2video_tpu/models/flow.py).

Encoder (one stride-1 + n_downsample_F stride-2 NormConvs) -> n_blocks_F
residual blocks -> decoder; heads: flow (2 ch, scaled by flow_multiplier,
returned fp32) and weight (1 ch sigmoid, unused by the generator). The
stride-2 convs pad flax-'SAME' style, (0, 1) on even sizes
(layers.conv2d_nhwc). The decoder's `up_{j}` is a nearest x2 upsample and a
stride-1 NormConv, or with `flow_deconv` a stride-2 transposed NormConv
(flax's ConvTranspose, layers.ConvTranspose). With skip_first, the
stride-1 NormConv `down_0` does not exist: the caller applied the first
conv and its leaky-relu (the factorized frontend's `flow_down_0`) and
passes the (B, H, W, nff) result.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ag2video_torch.models.layers import Conv, leaky_relu_02, upsample_nearest
from ag2video_torch.models.normalization import (BatchNorm, GroupNorm,
                                                 NormConv, SNConv)


class FlowResBlock(nn.Module):
    """norm -> lrelu -> spectral conv, twice; identity shortcut. The norm is
    BatchNorm ('batch' in the norm string), the instance norm ('instance')
    or none."""

    def __init__(self, features: int, norm: str = "spectralsyncbatch",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        spectral = "spectral" in norm
        sub = norm.replace("spectral", "")
        if "batch" in sub:
            self.bn_0 = BatchNorm(features, dtype=dtype)
            self.bn_1 = BatchNorm(features, dtype=dtype)
        elif "instance" in sub:
            self.bn_0 = GroupNorm(None, dtype=dtype)
            self.bn_1 = GroupNorm(None, dtype=dtype)
        else:
            self.bn_0 = self.bn_1 = None
        self.conv_0 = SNConv(features, features, 3, spectral=spectral,
                             dtype=dtype)
        self.conv_1 = SNConv(features, features, 3, spectral=spectral,
                             dtype=dtype)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        dx = x if self.bn_0 is None else self.bn_0(x, train)
        dx = self.conv_0(leaky_relu_02(dx), train)
        dx = dx if self.bn_1 is None else self.bn_1(dx, train)
        dx = self.conv_1(leaky_relu_02(dx), train)
        return x + dx


class FlowsGenerator(nn.Module):
    """Reference FlowsGenerator (flows_generator.py:13-68)."""

    def __init__(self, in_features: int, nff: int = 32, n_blocks_F: int = 6,
                 n_downsample_F: int = 3, norm_F: str = "spectralsyncbatch",
                 flow_multiplier: float = 20.0, flow_deconv: bool = False,
                 nf_max: int = 1024, skip_first: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        nd = n_downsample_F
        ch = [min(nf_max, nff * (2 ** i)) for i in range(nd + 1)]
        self.nd, self.n_blocks = nd, n_blocks_F
        self.flow_multiplier = flow_multiplier
        self.skip_first, self.flow_deconv = skip_first, flow_deconv
        if not skip_first:
            self.down_0 = NormConv(in_features, nff, norm_F, 3, dtype=dtype)
        for i in range(nd):
            setattr(self, f"down_{i + 1}",
                    NormConv(ch[i], ch[i + 1], norm_F, 3, stride=2,
                             dtype=dtype))
        for i in range(n_blocks_F):
            setattr(self, f"res_{i}", FlowResBlock(ch[nd], norm_F, dtype))
        for j, i in enumerate(reversed(range(nd))):
            setattr(self, f"up_{j}",
                    NormConv(ch[i + 1], ch[i], norm_F, 3,
                             stride=2 if flow_deconv else 1,
                             transpose=flow_deconv, dtype=dtype))
        self.conv_flow = Conv(ch[0], 2, 3, dtype=dtype)
        self.conv_w = Conv(ch[0], 1, 3, dtype=dtype)

    def forward(self, x: torch.Tensor, train: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, H, W, C) -> (weight (B, H, W, 1), flow (B, H, W, 2) fp32);
        with skip_first, x is the (B, H, W, nff) output of the first conv."""
        if not self.skip_first:
            x = leaky_relu_02(self.down_0(x, train))
        for i in range(self.nd):
            x = leaky_relu_02(getattr(self, f"down_{i + 1}")(x, train))
        for i in range(self.n_blocks):
            x = getattr(self, f"res_{i}")(x, train)
        for j in range(self.nd):
            if not self.flow_deconv:
                x = upsample_nearest(x)
            x = leaky_relu_02(getattr(self, f"up_{j}")(x, train))
        flow = self.conv_flow(x) * self.flow_multiplier
        weight = torch.sigmoid(self.conv_w(x))
        return weight, flow.float()
