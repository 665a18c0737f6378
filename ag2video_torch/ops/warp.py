"""Optical-flow warping (port of ag2video_tpu/ops/warp.py).

The JAX package computes the warp in XLA (ops/sampling.py gathers, no
Pallas kernel), so the port uses `F.grid_sample` with the same semantics:
bilinear, border padding, align_corners=False. The sampling grid is built
exactly as `flow_grid` builds it: identity linspace grid plus the pixel-unit
flow divided by ((W-1)/2, (H-1)/2).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ag2video_torch.ops.constants import cached


def flow_grid(flow: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 2) pixel flow -> (..., H, W, 2) sampling grid in [-1, 1].
    The identity grid and the scale are built once per (H, W) and device
    (ops/constants.py)."""
    H, W = flow.shape[-3], flow.shape[-2]
    dev = flow.device

    def base():
        xs = torch.linspace(-1.0, 1.0, W, dtype=torch.float32, device=dev)
        ys = torch.linspace(-1.0, 1.0, H, dtype=torch.float32, device=dev)
        return torch.stack([xs[None, :].expand(H, W),
                            ys[:, None].expand(H, W)], dim=-1)

    scale = cached(("warp_scale", H, W), dev, lambda: torch.tensor(
        [(W - 1.0) / 2.0, (H - 1.0) / 2.0], dtype=torch.float32, device=dev))
    return cached(("warp_base", H, W), dev, base) + flow.float() / scale


def resample(image: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Warp `image` (B, H, W, C) by `flow` (B, H, W, 2) in pixel units.

    A NaN flow gives a NaN pixel, as in the JAX package (a step with a
    non-finite loss is then skipped). `F.grid_sample` on the CPU turns a
    NaN coordinate into an index out of bounds, so such coordinates are
    sampled at the centre and their pixels set to NaN afterwards."""
    grid = flow_grid(flow)
    nan = torch.isnan(grid).any(-1, keepdim=True)
    grid = torch.where(nan, torch.zeros_like(grid), grid)
    out = F.grid_sample(image.permute(0, 3, 1, 2), grid.to(image.dtype),
                        mode="bilinear", padding_mode="border",
                        align_corners=False).permute(0, 2, 3, 1)
    return torch.where(nan, torch.full_like(out, float("nan")), out)
