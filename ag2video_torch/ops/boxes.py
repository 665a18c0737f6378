"""Bounding-box coordinate transforms (port of ag2video_tpu/ops/boxes.py).

Boxes are [x0, y0, w, h] ("xywh") or corner format [x0, y0, x1, y1]
("xyxy"), normalized to [0, 1] image coordinates, over any leading dims.
"""

from __future__ import annotations

import torch


def xywh_to_xyxy(boxes: torch.Tensor) -> torch.Tensor:
    """[x0, y0, w, h] -> [x0, y0, x1, y1] (reference models/metrics.py:20-24)."""
    x0, y0, w, h = boxes.unbind(-1)
    return torch.stack([x0, y0, x0 + w, y0 + h], -1)


def centers_to_extents(boxes: torch.Tensor) -> torch.Tensor:
    """[xc, yc, w, h] -> [x0, y0, x1, y1] (reference models/box_utils.py:83-102)."""
    xc, yc, w, h = boxes.unbind(-1)
    x0 = xc - w / 2
    y0 = yc - h / 2
    return torch.stack([x0, y0, x0 + w, y0 + h], -1)


def extents_to_centers(boxes: torch.Tensor) -> torch.Tensor:
    """[x0, y0, x1, y1] -> [xc, yc, w, h] (reference models/box_utils.py:105-124)."""
    x0, y0, x1, y1 = boxes.unbind(-1)
    return torch.stack([0.5 * (x0 + x1), 0.5 * (y0 + y1), x1 - x0, y1 - y0],
                       -1)


def apply_box_transform(anchors: torch.Tensor,
                        transforms: torch.Tensor) -> torch.Tensor:
    """Apply [tx, ty, tw, th] deltas to [xc, yc, w, h] anchors
    (reference models/box_utils.py:24-52)."""
    xa, ya, wa, ha = anchors.unbind(-1)
    tx, ty, tw, th = transforms.unbind(-1)
    return torch.stack([xa + tx * wa, ya + ty * ha, wa * torch.exp(tw),
                        ha * torch.exp(th)], -1)


def remove_small_boxes_mask(boxes: torch.Tensor,
                            min_size: float = 0.0) -> torch.Tensor:
    """Mask of boxes with both extents > min_size (reference
    models/utils.py:54-63, as a mask instead of indices)."""
    return (boxes[..., 2] > min_size) & (boxes[..., 3] > min_size)


def invert_box_transform(anchors: torch.Tensor,
                         boxes: torch.Tensor) -> torch.Tensor:
    """Deltas that map anchors -> boxes, both [xc, yc, w, h] (reference
    models/box_utils.py:55-80)."""
    xa, ya, wa, ha = anchors.unbind(-1)
    x, y, w, h = boxes.unbind(-1)
    return torch.stack([(x - xa) / wa, (y - ya) / ha,
                        torch.log(w) - torch.log(wa),
                        torch.log(h) - torch.log(ha)], -1)
