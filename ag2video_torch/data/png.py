"""PNG frames without PIL: a reader for the CATER frame cache and a writer
that fabricates one.

`read_png` parses the chunks (IHDR, the IDAT chunks joined, IEND; each CRC
checked), inflates the stream with `zlib` and undoes the per-row filters in
the host library (data/native.py), all three with the interpreter lock
released; the Python work is per chunk, never per row. It reads 8-bit gray,
RGB and RGBA images without interlacing, and returns what PIL's
`Image.open(path).convert("RGB")` returns: (H, W, 3) uint8, gray
replicated, alpha dropped. Any other PNG raises.

`write_png` is the encoder, vectorised in numpy: every predictor is a
function of the known pixels. It cycles the five filter types row by row so
that a reader is exercised on all of them.

`read_frame` reads a `.png` with `read_png` and any other file with PIL,
imported when it is called.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from ag2video_torch.data import native

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# Colour type -> samples per pixel: gray, RGB, RGBA.
CHANNELS = {0: 1, 2: 3, 6: 4}
COLOUR_TYPE = {v: k for k, v in CHANNELS.items()}


def read_png(path) -> np.ndarray:
    """An 8-bit gray, RGB or RGBA PNG -> (H, W, 3) uint8 RGB."""
    with open(path, "rb") as f:
        data = memoryview(f.read())
    if data[:8] != SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    header, idat, pos = None, [], 8
    while True:
        if pos + 12 > len(data):
            raise ValueError(f"{path}: truncated PNG (no IEND chunk)")
        length, kind = struct.unpack_from(">I4s", data, pos)
        if pos + 12 + length > len(data):
            raise ValueError(f"{path}: truncated {kind!r} chunk")
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack_from(">I", data, pos + 8 + length)
        if zlib.crc32(body, zlib.crc32(kind)) != crc:
            raise ValueError(f"{path}: bad CRC in the {kind!r} chunk")
        pos += 12 + length
        if kind == b"IHDR":
            if length != 13:
                raise ValueError(f"{path}: IHDR of {length} bytes")
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None or not idat:
        raise ValueError(f"{path}: PNG without IHDR or IDAT")
    width, height, depth, colour, compression, filtering, interlace = header
    if depth != 8 or colour not in CHANNELS or compression or filtering \
            or interlace:
        raise ValueError(
            f"{path}: unsupported PNG (bit depth {depth}, colour type "
            f"{colour}, interlace {interlace}); read_png takes 8-bit gray, "
            f"RGB or RGBA without interlacing")
    ch = CHANNELS[colour]
    raw = native.png_unfilter(zlib.decompress(b"".join(idat)), height,
                              width * ch, ch)
    img = raw.reshape(height, width, ch)
    if ch == 1:
        return np.repeat(img, 3, axis=2)
    if ch == 4:
        return np.ascontiguousarray(img[..., :3])
    return img


def _filter_rows(raw: np.ndarray, bpp: int) -> np.ndarray:
    """(H, row_bytes) uint8 -> (H, 1 + row_bytes): row y filtered with type
    y % 5 (None, Sub, Up, Average, Paeth) behind its type byte."""
    x = raw.astype(np.int16)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    pred = np.stack([np.zeros_like(x), a, b, (a + b) // 2, paeth])
    kinds = np.arange(x.shape[0]) % 5
    out = (x - pred[kinds, np.arange(x.shape[0])]) & 0xFF
    return np.concatenate([kinds[:, None], out], axis=1).astype(np.uint8)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(body, zlib.crc32(kind))))


def write_png(path, img: np.ndarray) -> None:
    """Write (H, W) or (H, W, 1 | 3 | 4) uint8 as an 8-bit gray, RGB or
    RGBA PNG."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"write_png takes uint8 pixels, not {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or img.shape[2] not in COLOUR_TYPE:
        raise ValueError(f"write_png takes (H, W[, 1|3|4]), not {img.shape}")
    height, width, ch = img.shape
    rows = _filter_rows(img.reshape(height, width * ch), ch)
    ihdr = struct.pack(">IIBBBBB", width, height, 8, COLOUR_TYPE[ch], 0, 0, 0)
    with open(path, "wb") as f:
        f.write(SIGNATURE + _chunk(b"IHDR", ihdr)
                + _chunk(b"IDAT", zlib.compress(rows.tobytes()))
                + _chunk(b"IEND", b""))


def read_frame(path) -> np.ndarray:
    """A frame file -> (H, W, 3) uint8 RGB: PNG without PIL, any other
    format through PIL."""
    if str(path).lower().endswith(".png"):
        return read_png(path)
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(f"reading {path} needs PIL (Pillow): only PNG "
                          f"frames are read without it") from e
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))
