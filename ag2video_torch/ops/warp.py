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


def flow_grid(flow: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 2) pixel flow -> (..., H, W, 2) sampling grid in [-1, 1]."""
    H, W = flow.shape[-3], flow.shape[-2]
    dev = flow.device
    xs = torch.linspace(-1.0, 1.0, W, dtype=torch.float32, device=dev)
    ys = torch.linspace(-1.0, 1.0, H, dtype=torch.float32, device=dev)
    base = torch.stack([xs[None, :].expand(H, W), ys[:, None].expand(H, W)],
                       dim=-1)
    scale = torch.tensor([(W - 1.0) / 2.0, (H - 1.0) / 2.0],
                         dtype=torch.float32, device=dev)
    return base + flow.float() / scale


def resample(image: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Warp `image` (B, H, W, C) by `flow` (B, H, W, 2) in pixel units."""
    grid = flow_grid(flow)
    out = F.grid_sample(image.permute(0, 3, 1, 2), grid.to(image.dtype),
                        mode="bilinear", padding_mode="border",
                        align_corners=False)
    return out.permute(0, 2, 3, 1)
