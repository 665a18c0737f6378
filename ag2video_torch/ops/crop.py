"""Differentiable box crops, ROI-align style (port of
ag2video_tpu/ops/crop.py).

A box's crop is a bilinear sample (align_corners=True, zeros padding) over
the grid spanned by the box's corners in [-1, 1]. Every (frame, object)
slot is cropped; illegal slots (an all-zero box or a masked object) are
zeroed, and the mask is returned for the losses to weight by.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ag2video_torch.ops.boxes import xywh_to_xyxy
from ag2video_torch.ops.sampling import grid_sample_2d, linspace01


def crop_grid(bbox: torch.Tensor, HH: int, WW: int) -> torch.Tensor:
    """xywh boxes (..., 4) -> sampling grids (..., HH, WW, 2) in fp32."""
    corners = xywh_to_xyxy(bbox.float()) * 2.0 - 1.0
    x0, y0, x1, y1 = corners.unbind(-1)
    tw = linspace01(WW, bbox.device)
    th = linspace01(HH, bbox.device)
    X = x0[..., None] * (1 - tw) + x1[..., None] * tw  # (..., WW)
    Y = y0[..., None] * (1 - th) + y1[..., None] * th  # (..., HH)
    lead = X.shape[:-1]
    return torch.stack([X[..., None, :].expand(*lead, HH, WW),
                        Y[..., :, None].expand(*lead, HH, WW)], dim=-1)


def crop_bbox(feats: torch.Tensor, bbox: torch.Tensor, HH: int,
              WW: Optional[int] = None) -> torch.Tensor:
    """Crop feats (..., H, W, C) by xywh boxes (..., 4) -> (..., HH, WW, C)."""
    if WW is None:
        WW = HH
    return grid_sample_2d(feats, crop_grid(bbox, HH, WW), align_corners=True,
                          padding_mode="zeros")


def crop_bbox_batch(imgs: torch.Tensor, bbox: torch.Tensor, HH: int,
                    WW: Optional[int] = None,
                    mask: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Crop every object from every frame.

    imgs (B, T, H, W, C); bbox (B, T, O, 4) xywh; mask (B, O) object
    validity, combined with the all-zero-box test. Returns crops (B, T, O,
    HH, WW, C) with illegal slots zeroed, and the legality mask (B, T, O).

    The O grids of a frame are stacked along the grid's rows, so one
    sample of each frame serves all its objects: the frames are not copied
    O times.
    """
    if WW is None:
        WW = HH
    B, T, H, W, C = imgs.shape
    O = bbox.shape[2]
    legal = (bbox != 0).any(-1)  # (B, T, O)
    if mask is not None:
        legal = legal & (mask[:, None, :] > 0)
    grid = crop_grid(bbox, HH, WW).reshape(B, T, O * HH, WW, 2)
    crops = grid_sample_2d(imgs, grid, align_corners=True,
                           padding_mode="zeros")
    crops = crops.reshape(B, T, O, HH, WW, C)
    return crops * legal[..., None, None, None].to(crops.dtype), legal
