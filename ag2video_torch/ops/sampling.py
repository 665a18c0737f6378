"""General bilinear grid sampling, channels-last (port of
ag2video_tpu/ops/sampling.py).

The JAX package computes it with XLA gathers (no Pallas kernel), so the
port uses `F.grid_sample` on a channels-first view with the same semantics:
torch's own, which the JAX function reproduces (align_corners True or
False; 'zeros' padding, where a corner outside the image weighs zero, or
'border' padding, where the coordinate is clamped to the image).

`resize_bilinear` is `jax.image.resize(method='bilinear')` (InceptionV3's
input and ConvEncoder's). It lives here, in a module that imports nothing
of the package but the leaf `ops.constants`, so that `models` and `eval`
can both import it in either order; `eval.inception` re-exports it.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ag2video_torch.ops.constants import cached


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """jax.image.resize(method='bilinear') of (N, H, W, C): half-pixel
    centres and, when downsampling, the triangle kernel widened to the
    factor (antialiasing), as torch's antialiased bilinear weights it."""
    y = F.interpolate(x.movedim(-1, 1), size=tuple(size), mode="bilinear",
                      align_corners=False, antialias=True)
    return y.movedim(1, -1)


def linspace01(n: int, device=None) -> torch.Tensor:
    """`jnp.linspace(0.0, 1.0, n)` in fp32 as XLA computes it: i times the
    rounded reciprocal of n - 1, the last point exactly 1 (an ulp away
    from `torch.linspace` at some points; the crop grids and the masks'
    0.5 threshold are held to the JAX package exactly). Built once per n
    and device (ops/constants.py)."""
    return cached(("linspace01", n), device, lambda: _linspace01(n, device))


def _linspace01(n: int, device) -> torch.Tensor:
    if n == 1:
        return torch.zeros(1, device=device)
    r = torch.tensor(1.0, device=device) / torch.tensor(float(n - 1),
                                                         device=device)
    out = torch.arange(n, dtype=torch.float32, device=device) * r
    out[-1] = 1.0
    return out


def grid_sample_2d(img: torch.Tensor, grid: torch.Tensor, *,
                   align_corners: bool = False,
                   padding_mode: str = "zeros") -> torch.Tensor:
    """Bilinear sample `img` at `grid` locations.

    img: (..., H, W, C); grid: (..., Ho, Wo, 2) in [-1, 1], last axis (x,
    y), with the same leading dims as img. Returns (..., Ho, Wo, C) in
    img.dtype.

    The sampling runs in fp32 (a bf16 grid would move a 256-pixel
    coordinate by up to half a pixel). A NaN coordinate gives a NaN pixel,
    as in the JAX function; `F.grid_sample` on the CPU turns one into an
    index out of bounds, so such points are sampled at the centre and set
    to NaN afterwards (as ops.warp.resample does).
    """
    if padding_mode not in ("zeros", "border"):
        raise ValueError(f"padding_mode {padding_mode!r} not supported")
    *lead, H, W, C = img.shape
    *glead, Ho, Wo, two = grid.shape
    if two != 2 or tuple(lead) != tuple(glead):
        raise ValueError(f"img {tuple(img.shape)} and grid "
                         f"{tuple(grid.shape)} do not match")
    x = img.reshape(-1, H, W, C).permute(0, 3, 1, 2).float()
    g = grid.reshape(-1, Ho, Wo, 2).float()
    nan = torch.isnan(g).any(-1, keepdim=True)
    g = torch.where(nan, torch.zeros_like(g), g)
    out = F.grid_sample(x, g, mode="bilinear", padding_mode=padding_mode,
                        align_corners=align_corners).permute(0, 2, 3, 1)
    out = torch.where(nan, torch.full_like(out, float("nan")), out)
    return out.to(img.dtype).reshape(*lead, Ho, Wo, C)
