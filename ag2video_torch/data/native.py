"""ctypes binding of the port's host library, csrc/host.cpp (the port of
ag2video_tpu/data/native.py and native/agtpu_host.cpp).

The library is compiled by g++ at first use (ops/_kernels.py) and a failed
build raises with the compiler's output: there is no numpy stand-in on the
data path. `ctypes.CDLL` releases the interpreter lock for each call, so the
loader threads decode and resize while the trainer dispatches. The numpy
versions below (`*_plain`) are the tests' references.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np

from ag2video_torch.ops._kernels import host_library


def library() -> ctypes.CDLL:
    """The loaded host library, its C signatures typed."""
    return host_library().lib


def version() -> int:
    return library().agtpu_version()


def clip_resize_normalize(
    frames_u8: np.ndarray,
    out_size: Tuple[int, int],
    mean: np.ndarray,
    std: np.ndarray,
    n_threads: int = 4,
) -> np.ndarray:
    """(T, H, W, 3) uint8 -> (T, outH, outW, 3) float32: half-pixel
    bilinear resize, then (x / 255 - mean) / std per channel."""
    frames_u8 = np.ascontiguousarray(frames_u8, np.uint8)
    if frames_u8.ndim != 4 or frames_u8.shape[-1] != 3:
        raise ValueError(f"want (T, H, W, 3) frames, got {frames_u8.shape}")
    T, H, W, _ = frames_u8.shape
    oh, ow = out_size
    mean = np.ascontiguousarray(mean, np.float32)
    std = np.ascontiguousarray(std, np.float32)
    if mean.shape != (3,) or std.shape != (3,):
        raise ValueError("mean and std need 3 channels")
    out = np.empty((T, oh, ow, 3), np.float32)
    library().agtpu_clip_resize_normalize(
        frames_u8.ctypes.data, T, H, W, out.ctypes.data, oh, ow,
        mean.ctypes.data, std.ctypes.data, n_threads)
    return out


def pad_boxes(boxes: np.ndarray, o_cap: int,
              pad_value: float = -1.0) -> np.ndarray:
    """(T, O, 4) -> (T, o_cap, 4) padded with pad_value."""
    boxes = np.ascontiguousarray(boxes, np.float32)
    if boxes.ndim != 3 or boxes.shape[-1] != 4:
        raise ValueError(f"want (T, O, 4) boxes, got {boxes.shape}")
    T, O, _ = boxes.shape
    out = np.empty((T, o_cap, 4), np.float32)
    library().agtpu_pad_boxes(boxes.ctypes.data, T, O, out.ctypes.data,
                              o_cap, pad_value)
    return out


def png_unfilter(data: bytes, height: int, row_bytes: int,
                 bpp: int) -> np.ndarray:
    """A PNG image's inflated IDAT stream (`height` rows of a filter-type
    byte and `row_bytes` filtered bytes) -> (height, row_bytes) uint8."""
    if len(data) != height * (row_bytes + 1):
        raise ValueError(f"PNG data holds {len(data)} bytes, want "
                         f"{height} rows of 1 + {row_bytes}")
    src = np.frombuffer(data, np.uint8)
    out = np.empty((height, row_bytes), np.uint8)
    bad = library().agtpu_png_unfilter(src.ctypes.data, height, row_bytes,
                                       bpp, out.ctypes.data)
    if bad:
        raise ValueError(f"PNG row {bad - 1} has an unknown filter type "
                         f"{src[(bad - 1) * (row_bytes + 1)]}")
    return out


# ----------------------------------------------------------------------
# Plain versions (the tests' references)

def resize_normalize_plain(frames_u8, out_size, mean, std) -> np.ndarray:
    """The JAX package's numpy fallback: the same geometry in float64
    coordinates and float32 pixels."""
    T, H, W, _ = frames_u8.shape
    oh, ow = out_size
    fy = (np.arange(oh) + 0.5) * (H / oh) - 0.5
    fx = (np.arange(ow) + 0.5) * (W / ow) - 0.5
    y0 = np.floor(fy).astype(int)
    x0 = np.floor(fx).astype(int)
    ty = (fy - y0)[None, :, None, None]
    tx = (fx - x0)[None, None, :, None]
    y0c, y1c = np.clip(y0, 0, H - 1), np.clip(y0 + 1, 0, H - 1)
    x0c, x1c = np.clip(x0, 0, W - 1), np.clip(x0 + 1, 0, W - 1)
    f = frames_u8.astype(np.float32) / 255.0
    top = f[:, y0c][:, :, x0c] * (1 - tx) + f[:, y0c][:, :, x1c] * tx
    bot = f[:, y1c][:, :, x0c] * (1 - tx) + f[:, y1c][:, :, x1c] * tx
    out = top * (1 - ty) + bot * ty
    return ((out - mean) / std).astype(np.float32)


def pad_boxes_plain(boxes: np.ndarray, o_cap: int,
                    pad_value: float = -1.0) -> np.ndarray:
    boxes = np.asarray(boxes, np.float32)
    out = np.full((boxes.shape[0], o_cap, 4), pad_value, np.float32)
    out[:, :min(boxes.shape[1], o_cap)] = boxes[:, :o_cap]
    return out


def png_unfilter_plain(data: bytes, height: int, row_bytes: int,
                       bpp: int) -> np.ndarray:
    """`png_unfilter` as a loop over rows and bytes (PNG specification,
    section 9)."""
    src = np.frombuffer(data, np.uint8).reshape(height, row_bytes + 1)
    out = np.zeros((height, row_bytes), np.int64)
    for y in range(height):
        kind, row = int(src[y, 0]), src[y, 1:].astype(np.int64)
        up = out[y - 1] if y else np.zeros(row_bytes, np.int64)
        for i in range(row_bytes):
            a = out[y, i - bpp] if i >= bpp else 0
            b = up[i]
            c = up[i - bpp] if i >= bpp else 0
            if kind == 0:
                pred = 0
            elif kind == 1:
                pred = a
            elif kind == 2:
                pred = b
            elif kind == 3:
                pred = (a + b) // 2
            elif kind == 4:
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            else:
                raise ValueError(f"unknown PNG filter type {kind}")
            out[y, i] = (row[i] + pred) & 0xFF
    return out.astype(np.uint8)
