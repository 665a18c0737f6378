"""GAN losses (port of ag2video_tpu/losses/gan.py): the reference GANLoss
(models/spade_models/networks/loss.py:16-98), hinge / ls / original (BCE) /
w, with the multiscale-discriminator list-of-lists convention (the last
tensor of each scale is its patch logits; scale losses are averaged)."""

from __future__ import annotations

from typing import List, Sequence

import torch


def bce_with_logits(x: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Numerically stable BCE-with-logits, mean-reduced, in the JAX
    package's form."""
    loss = torch.clamp(x, min=0) - x * target + torch.log1p(
        torch.exp(-x.abs()))
    return loss.mean()


def gan_loss(logits: torch.Tensor, target_is_real: bool,
             for_discriminator: bool, mode: str = "hinge") -> torch.Tensor:
    """Single-tensor GAN loss (reference loss.py:57-82), in fp32."""
    x = logits.float()
    if mode == "original":
        return bce_with_logits(x, torch.full_like(
            x, 1.0 if target_is_real else 0.0))
    if mode == "ls":
        return ((x - (1.0 if target_is_real else 0.0)) ** 2).mean()
    if mode == "hinge":
        if for_discriminator:
            if target_is_real:
                return -torch.clamp(x - 1, max=0.0).mean()
            return -torch.clamp(-x - 1, max=0.0).mean()
        assert target_is_real, "generator hinge loss must aim for real"
        return -x.mean()
    if mode == "w":
        return -x.mean() if target_is_real else x.mean()
    raise ValueError(f"Unexpected gan_mode {mode}")


def multiscale_gan_loss(preds: Sequence[List[torch.Tensor]],
                        target_is_real: bool, for_discriminator: bool,
                        mode: str = "hinge") -> torch.Tensor:
    """List-of-lists discriminator outputs -> scalar (reference
    loss.py:84-96)."""
    total = 0.0
    for per_scale in preds:
        logits = per_scale[-1] if isinstance(per_scale, (list, tuple)) \
            else per_scale
        total = total + gan_loss(logits, target_is_real, for_discriminator,
                                 mode)
    return total / len(preds)
