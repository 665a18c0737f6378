"""Tensor ops: box transforms, IoU, the box rasterizer (CUDA kernel +
plain version), the mask rasterizers, grid sampling, box crops and the
flow warp. The SPADE norm's fused eval chain (CUDA kernel + plain
version) is `ops.denorm`, the factorized frontend conv's `ops.objconv`.
Inside `plain()` all three ops take their plain versions on the card too
(ops/_kernels.py holds that switch and the one rule of dispatch)."""

from ag2video_torch.ops._kernels import plain  # noqa: F401
from ag2video_torch.ops.boxes import (  # noqa: F401
    apply_box_transform, centers_to_extents, extents_to_centers,
    invert_box_transform, xywh_to_xyxy)
from ag2video_torch.ops.metrics import iou_masks, iou_xywh  # noqa: F401
from ag2video_torch.ops.sampling import grid_sample_2d  # noqa: F401
from ag2video_torch.ops.rasterize import (  # noqa: F401
    KERNEL_LAUNCHES, PLAIN_CALLS, box_coverage, boxes_to_layout,
    boxes_to_layout_batch, boxes_to_mask, masks_to_layout)
from ag2video_torch.ops.warp import flow_grid, resample  # noqa: F401
from ag2video_torch.ops.crop import crop_bbox, crop_bbox_batch  # noqa: F401
