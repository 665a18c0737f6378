"""IoU metrics (port of ag2video_tpu/ops/metrics.py; reference
models/metrics.py:27-67).

Mask-aware: the reference strips dummy and padded boxes with boolean
indexing (models/utils.py:105-110); here a `mask` weights masked sums, so
the shapes stay fixed.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ag2video_torch.ops.boxes import xywh_to_xyxy


def iou_xywh(bbox_pred: torch.Tensor, bbox_gt: torch.Tensor) -> torch.Tensor:
    """Elementwise (aligned-pair) IoU of xywh boxes; any leading dims.
    Thresholds are left to the caller (reference `jaccard`,
    models/metrics.py:34-50)."""
    p = xywh_to_xyxy(bbox_pred)
    g = xywh_to_xyxy(bbox_gt)
    max_xy = torch.minimum(p[..., 2:], g[..., 2:])
    min_xy = torch.maximum(p[..., :2], g[..., :2])
    wh = torch.clamp(max_xy - min_xy, min=0)
    inter = wh[..., 0] * wh[..., 1]
    area_p = (p[..., 2] - p[..., 0]) * (p[..., 3] - p[..., 1])
    area_g = (g[..., 2] - g[..., 0]) * (g[..., 3] - g[..., 1])
    union = area_p + area_g - inter
    return inter / union


def iou_stats(bbox_pred: torch.Tensor, bbox_gt: torch.Tensor,
              mask: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                         torch.Tensor]:
    """(sum_iou, count@0.5, count@0.3, n_valid) over the masked boxes (the
    accumulation of the reference val loop, scripts/train.py:180-197)."""
    iou = iou_xywh(bbox_pred, bbox_gt)
    if mask is None:
        mask = torch.ones_like(iou)
    mask = mask.to(iou.dtype)
    iou = torch.where(mask > 0, iou, torch.zeros_like(iou))
    return (iou.sum(), ((iou > 0.5) * mask).sum(),
            ((iou > 0.3) * mask).sum(), mask.sum())


def iou_masks(masks_pred: torch.Tensor, masks_gt: torch.Tensor
              ) -> torch.Tensor:
    """Binary-mask IoU (reference models/metrics.py:53-67)."""
    mp = masks_pred.float()
    mg = masks_gt.float()
    inter = (mp * mg).sum()
    union = (mp + mg).sum() - inter
    return inter / union
