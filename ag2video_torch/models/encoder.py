"""VAE image encoder (port of ag2video_tpu/models/encoder.py; reference
models/spade_models/networks/encoder.py).

Upstream registers `ConvEncoder` but never instantiates it; nothing in the
default training graph uses it, in either package. The input is resized to
256x256 (bilinear, antialiased when it shrinks, as `jax.image.resize`
does), then six stride-2 3x3 NormConvs of widths nf x (1, 2, 4, 8, 8, 8)
with leaky-relu(0.2) between them (the first conv's input is not
activated) and after the last, a flatten in NHWC order, and two Dense heads
-> (mu, logvar) of width z_dim. Pair with `losses.perceptual.kld_loss`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ag2video_torch.models.layers import Dense, leaky_relu_02
from ag2video_torch.models.normalization import NormConv
from ag2video_torch.ops.sampling import resize_bilinear

WIDTHS = (1, 2, 4, 8, 8, 8)


class ConvEncoder(nn.Module):
    """Image (B, H, W, 3) -> (mu, logvar) style posterior (reference
    encoder.py:14-57)."""

    def __init__(self, nf: int = 64, z_dim: int = 256,
                 norm: str = "spectralinstance",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        c = 3  # RGB
        for i, w in enumerate(WIDTHS):
            setattr(self, f"layer{i + 1}", NormConv(c, nf * w, norm, 3, 2,
                                                    dtype=dtype))
            c = nf * w
        # 256 / 2**6 = 4: a 4x4 map of 8 * nf channels.
        self.fc_mu = Dense(4 * 4 * c, z_dim, dtype=dtype)
        self.fc_var = Dense(4 * 4 * c, z_dim, dtype=dtype)

    def forward(self, x: torch.Tensor, train: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        B, H, W, _ = x.shape
        if (H, W) != (256, 256):
            x = resize_bilinear(x.float(), (256, 256)).to(x.dtype)
        for i in range(len(WIDTHS)):
            if i:
                x = leaky_relu_02(x)
            x = getattr(self, f"layer{i + 1}")(x, train)
        x = leaky_relu_02(x).reshape(B, -1)
        return self.fc_mu(x), self.fc_var(x)


def reparameterize(generator: torch.Generator, mu: torch.Tensor,
                   logvar: torch.Tensor) -> torch.Tensor:
    """z = mu + exp(logvar / 2) * eps, eps ~ N(0, 1) drawn from `generator`
    (on its device)."""
    eps = torch.randn(mu.shape, generator=generator, device=generator.device)
    return mu + torch.exp(0.5 * logvar) * eps.to(mu.device, mu.dtype)
