"""VGG perceptual loss (port of ag2video_tpu/losses/perceptual.py;
reference loss.py:102-118): a 5-slice weighted L1 on VGG19 relu{1..5}_1
features with weights [1/32, 1/16, 1/8, 1/4, 1]; videos are folded
(B*T) first. The target's features carry no gradient. Beside it, the
VAE's KL divergence and the masked L1 (reference loss.py:122-135)."""

from __future__ import annotations

from typing import Callable, List

import torch

VGG_WEIGHTS = (1.0 / 32, 1.0 / 16, 1.0 / 8, 1.0 / 4, 1.0)


def kld_loss(mu: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    """VAE KL divergence, summed (reference KLDLoss, loss.py:122-124)."""
    return -0.5 * torch.sum(1 + logvar - mu ** 2 - torch.exp(logvar))


def masked_l1_loss(x: torch.Tensor, target: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
    """L1 of the masked images, averaged over ALL elements, the masked-out
    ones included (reference MaskedL1Loss, loss.py:127-135)."""
    return torch.mean(torch.abs(x * mask - target * mask))


def vgg_loss(vgg_features: Callable[[torch.Tensor], List[torch.Tensor]],
             x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x, y: (B, T, H, W, 3) videos (or (N, H, W, 3) images)."""
    if x.dim() == 5:
        x = x.reshape(-1, *x.shape[2:])
        y = y.reshape(-1, *y.shape[2:])
    fx = vgg_features(x)
    with torch.no_grad():
        fy = vgg_features(y)
    loss = 0.0
    for w, a, b in zip(VGG_WEIGHTS, fx, fy):
        loss = loss + w * (a.float() - b.float()).abs().mean()
    return loss
