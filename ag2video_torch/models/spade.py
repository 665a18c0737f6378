"""SPADE generator stack (port of ag2video_tpu/models/spade.py).

Channels-last like the JAX package. Each resblock fuses the conditioning
convs of its 2-3 SPADE norms, which all read the same seg level: one
(seg_nc -> k*nhidden) shared conv and one (nhidden -> 2C) gamma|beta conv
per norm, with the kernels concatenated exactly as the JAX block does
(spade.py:72-87). The generator builds the conditioning pyramid once by
successive nearest halving (spade.py:130-143).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ag2video_torch.models.layers import (Conv, conv2d_nhwc, leaky_relu_02,
                                          resize_nearest, upsample_nearest)
from ag2video_torch.models.normalization import SPADE, SNConv


class SPADEResnetBlock(nn.Module):
    """Reference SPADEResnetBlock (architecture.py:21-68) with fused
    conditioning: norm -> actvn -> conv twice, plus a norm -> 1x1 conv
    learned shortcut when fin != fout."""

    def __init__(self, fin: int, fout: int, label_nc: int,
                 norm_G: str = "spectralspadesyncbatch3x3",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        fmiddle = min(fin, fout)
        spectral = "spectral" in norm_G
        spade_cfg = norm_G.replace("spectral", "")
        self.shortcut = fin != fout
        self.dtype = dtype
        if self.shortcut:
            self.norm_s = SPADE(spade_cfg, fin, label_nc, dtype)
            self.conv_s = SNConv(fin, fout, 1, use_bias=False,
                                 spectral=spectral, dtype=dtype)
        self.norm_0 = SPADE(spade_cfg, fin, label_nc, dtype)
        self.conv_0 = SNConv(fin, fmiddle, 3, spectral=spectral, dtype=dtype)
        self.norm_1 = SPADE(spade_cfg, fmiddle, label_nc, dtype)
        self.conv_1 = SNConv(fmiddle, fout, 3, spectral=spectral, dtype=dtype)

    def forward(self, x: torch.Tensor, seg: torch.Tensor,
                train: bool = False) -> torch.Tensor:
        norms = [self.norm_0, self.norm_1]
        if self.shortcut:
            norms.append(self.norm_s)
        seg_r = resize_nearest(seg, tuple(x.shape[-3:-1]))
        actv = torch.relu(conv2d_nhwc(
            seg_r,
            torch.cat([n.mlp_shared.weight for n in norms], 0),
            torch.cat([n.mlp_shared.bias for n in norms], 0),
            dtype=self.dtype))
        nh = self.norm_0.nhidden
        # Each norm's gamma | beta, kept whole for SPADE.denorm.
        gbs = [conv2d_nhwc(actv[..., i * nh:(i + 1) * nh],
                           *n.gamma_beta_kernels(), dtype=self.dtype)
               for i, n in enumerate(norms)]

        x_s = x
        if self.shortcut:
            x_s = self.conv_s(self.norm_s.denorm(x, gbs[2], train), train)
        dx = self.conv_0(self.norm_0.denorm(x, gbs[0], train, act=True),
                         train)
        dx = self.conv_1(self.norm_1.denorm(dx, gbs[1], train, act=True),
                         train)
        return x_s + dx


class SPADEGenerator(nn.Module):
    """Reference SPADEGenerator (spade_generator.py:8-81)."""

    def __init__(self, label_nc: int, ngf: int = 64,
                 norm_G: str = "spectralspadesyncbatch3x3",
                 num_upsampling_layers: str = "normal",
                 aspect_ratio: float = 1.0,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        nf = ngf
        self.num_upsampling_layers = num_upsampling_layers
        self.aspect_ratio = aspect_ratio
        self.fc = Conv(label_nc, 16 * nf, 3, dtype=dtype)
        blocks = [("head_0", 16 * nf, 16 * nf),
                  ("G_middle_0", 16 * nf, 16 * nf),
                  ("G_middle_1", 16 * nf, 16 * nf),
                  ("up_0", 16 * nf, 8 * nf),
                  ("up_1", 8 * nf, 4 * nf),
                  ("up_2", 4 * nf, 2 * nf),
                  ("up_3", 2 * nf, 1 * nf)]
        if num_upsampling_layers == "most":
            blocks.append(("up_4", 1 * nf, nf // 2))
        for name, fin, fout in blocks:
            setattr(self, name,
                    SPADEResnetBlock(fin, fout, label_nc, norm_G, dtype))
        self.conv_img = Conv(blocks[-1][2], 3, 3, dtype=dtype)

    def latent_size(self, out_hw: Tuple[int, int]) -> Tuple[int, int]:
        n_up = {"normal": 5, "more": 6, "most": 7}[self.num_upsampling_layers]
        sw = out_hw[1] // (2 ** n_up)
        sh = round(sw / self.aspect_ratio)
        return sh, sw

    def forward(self, layout: torch.Tensor,
                train: bool = False) -> torch.Tensor:
        H, W = layout.shape[-3], layout.shape[-2]
        sh, sw = self.latent_size((H, W))

        levels = {(H, W): layout}
        h, w = H, W
        while h % 2 == 0 and w % 2 == 0 and (h > sh or w > sw):
            h, w = h // 2, w // 2
            levels[(h, w)] = resize_nearest(levels[(2 * h, 2 * w)], (h, w))

        def seg_at(hw):
            seg = levels.get(tuple(hw))
            return seg if seg is not None else resize_nearest(layout, hw)

        def block(x, name):
            return getattr(self, name)(x, seg_at(x.shape[-3:-1]), train)

        x = self.fc(seg_at((sh, sw)))
        x = block(x, "head_0")
        x = upsample_nearest(x)
        x = block(x, "G_middle_0")
        if self.num_upsampling_layers in ("more", "most"):
            x = upsample_nearest(x)
        x = block(x, "G_middle_1")
        for name in ("up_0", "up_1", "up_2", "up_3"):
            x = upsample_nearest(x)
            x = block(x, name)
        if self.num_upsampling_layers == "most":
            x = upsample_nearest(x)
            x = block(x, "up_4")
        return torch.tanh(self.conv_img(leaky_relu_02(x)))
