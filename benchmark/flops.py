"""Operations and bytes of the work, counted by the benchmark.

`model_flops` counts the plain reference's forward with
`torch.utils.flop_counter.FlopCounterMode` on the meta device: the
operations of the model at the cell's shapes, whatever the program
implements them with, at no device cost. `rasterize_bytes_flops` is the
least traffic of one dense-layout rasterization: each input read once and
the bf16 layout written once, and its multiply-adds.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode


def model_flops(reference_cls, config, batch: Dict[str, np.ndarray]) -> int:
    """FLOPs of one forward of `reference_cls(config)` on `batch`."""
    with torch.device("meta"):
        model = reference_cls(config)
    t = {k: torch.empty(v.shape, dtype=torch.float32 if v.dtype.kind == "f"
                        else torch.long, device="meta")
         for k, v in batch.items()}
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        model(t["imgs"], t["objs"], t["triplets"], t["actions"], t["boxes"])
    return int(counter.get_total_flops())


def rasterize_bytes_flops(N: int, O: int, D: int, H: int, W: int
                          ) -> Tuple[int, int]:
    """(bytes, flops) of rasterizing N layouts of O boxes into (H, W, D)
    bf16: bf16 vectors, fp32 boxes and mask read once, the layout written
    once; one multiply-add per object, pixel and channel."""
    read = N * O * D * 2 + N * O * 4 * 4 + N * O * 4
    written = N * H * W * D * 2
    return read + written, 2 * N * H * W * O * D
