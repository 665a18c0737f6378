"""Device constants, built once per (name, sizes, device) and reused.

The frame loop's warp grid and scale, the rasterizer's pixel centres and
XLA's linspace are small tensors that every call needs. Built on the card,
each took a copy of a Python value from pageable host memory, and such a
copy waits for the card to drain its stream. So each is built once, by the
ops that built it on every call before (the same values, bit for bit), and
the cached tensor is reused. `BUILDS` counts the builds: a warmed call
builds none. The cached tensors are shared: read them, never write them.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch


class LaunchCount:
    """A plain counter of kernel launches (or plain-version calls, or
    constant builds)."""

    def __init__(self) -> None:
        self.n = 0

    def reset(self) -> None:
        self.n = 0


# Constants built, counted where the cache misses.
BUILDS = LaunchCount()
_CACHE: Dict[Tuple, torch.Tensor] = {}


def cached(key: Tuple, device, build: Callable[[], torch.Tensor]
           ) -> torch.Tensor:
    """The tensor cached under `key` (its name and sizes; each constant
    has one dtype) on `device`, built by `build()` on a miss. A normal
    tensor even under inference_mode, so that autograd may save it for a
    later backward."""
    full = key + (None if device is None else torch.device(device),)
    t = _CACHE.get(full)
    if t is None:
        with torch.inference_mode(False), torch.no_grad():
            t = build()
        _CACHE[full] = t
        BUILDS.n += 1
    return t
