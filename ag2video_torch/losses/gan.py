"""GAN losses (port of ag2video_tpu/losses/gan.py): the reference GANLoss
(models/spade_models/networks/loss.py:16-98), hinge / ls / original (BCE) /
w, with the multiscale-discriminator list-of-lists convention (the last
tensor of each scale is its patch logits; scale losses are averaged); the
functional gan / wgan / lsgan pairs with `get_gan_losses`, and the WGAN-GP
`gradient_penalty` (reference models/losses.py:21-160)."""

from __future__ import annotations

from typing import Callable, List, Sequence

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


# --- functional pairs (reference models/losses.py:21-145) ---

def gan_g_loss(scores_fake: torch.Tensor) -> torch.Tensor:
    f = scores_fake.reshape(-1)
    return bce_with_logits(f, torch.ones_like(f))


def gan_d_loss(scores_real: torch.Tensor,
               scores_fake: torch.Tensor) -> torch.Tensor:
    r = scores_real.reshape(-1)
    f = scores_fake.reshape(-1)
    return bce_with_logits(r, torch.ones_like(r)) + bce_with_logits(
        f, torch.zeros_like(f))


def wgan_g_loss(scores_fake: torch.Tensor) -> torch.Tensor:
    return -scores_fake.mean()


def wgan_d_loss(scores_real: torch.Tensor,
                scores_fake: torch.Tensor) -> torch.Tensor:
    return scores_fake.mean() - scores_real.mean()


def lsgan_g_loss(scores_fake: torch.Tensor) -> torch.Tensor:
    return ((torch.sigmoid(scores_fake.reshape(-1)) - 1.0) ** 2).mean()


def lsgan_d_loss(scores_real: torch.Tensor,
                 scores_fake: torch.Tensor) -> torch.Tensor:
    r = torch.sigmoid(scores_real.reshape(-1))
    f = torch.sigmoid(scores_fake.reshape(-1))
    return ((r - 1.0) ** 2).mean() + (f ** 2).mean()


def _penalty_at(x_hat: torch.Tensor,
                f: Callable[[torch.Tensor], torch.Tensor],
                gamma: float) -> torch.Tensor:
    """The penalty at the interpolates `x_hat` (N, ...): the input gradient
    of sum_n mean(f(x_hat)[n]), its per-sample norm (1e-12 under the root),
    and mean((norm - gamma)^2) / gamma^2. The gradient keeps its graph, so
    the penalty trains f (and whatever x_hat came from) as jax.grad does."""
    create_graph = torch.is_grad_enabled()
    N = x_hat.shape[0]
    with torch.enable_grad():
        if not x_hat.requires_grad:
            x_hat = x_hat.detach().requires_grad_(True)
        s = f(x_hat)
        if s.dim() > 1:
            s = s.reshape(N, -1).mean(dim=1)
        grad_x, = torch.autograd.grad(s.sum(), x_hat,
                                      create_graph=create_graph)
    norms = torch.sqrt((grad_x.reshape(N, -1) ** 2).sum(dim=1) + 1e-12)
    return ((norms - gamma) ** 2).mean() / (gamma * gamma)


def gradient_penalty(x_real: torch.Tensor, x_fake: torch.Tensor,
                     f: Callable[[torch.Tensor], torch.Tensor],
                     generator: torch.Generator,
                     gamma: float = 1.0) -> torch.Tensor:
    """WGAN-GP style penalty (reference models/losses.py:148-160) at
    eps * x_real + (1 - eps) * x_fake, one eps per sample drawn from a
    normal distribution (as the JAX package draws it) with `generator` (on
    its device). `f` maps images to scores."""
    N = x_real.shape[0]
    eps = torch.randn((N,) + (1,) * (x_real.dim() - 1), generator=generator,
                      device=generator.device)
    eps = eps.to(x_real.device, x_real.dtype)
    return _penalty_at(eps * x_real + (1 - eps) * x_fake, f, gamma)


def get_gan_losses(gan_type: str):
    """(g_loss, d_loss) pair by name (reference losses.py:21-36)."""
    table = {
        "gan": (gan_g_loss, gan_d_loss),
        "wgan": (wgan_g_loss, wgan_d_loss),
        "lsgan": (lsgan_g_loss, lsgan_d_loss),
    }
    if gan_type not in table:
        raise ValueError(f'Unrecognized GAN type "{gan_type}"')
    return table[gan_type]
