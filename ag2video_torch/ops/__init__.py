"""Tensor ops: the box rasterizer (CUDA kernel + plain version) and the
flow warp."""

from ag2video_torch.ops.rasterize import (  # noqa: F401
    KERNEL_LAUNCHES, PLAIN_CALLS, box_coverage, boxes_to_layout_batch)
from ag2video_torch.ops.warp import flow_grid, resample  # noqa: F401
