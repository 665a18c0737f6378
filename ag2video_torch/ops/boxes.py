"""Bounding-box coordinate transforms (port of ag2video_tpu/ops/boxes.py:14-40).

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
