"""An animated-GIF writer in numpy and the standard library, so that the
port writes its videos where imageio is missing.

The file is GIF89a with one global 256-colour palette, fixed and the same
for every file: the 6 x 7 x 6 lattice of red, green and blue levels spread
evenly over 0..255 (252 colours; the last 4 entries repeat black and are
never chosen). Each pixel takes the nearest palette colour, channel by
channel, which on a lattice is the nearest colour in RGB. The worst error
per channel is MAX_ERROR = 25 (red and blue, 51 between levels; green 21).
`quantize_frames` gives the frames a decoder reads back.

Each frame is one full-size image after a graphics control extension with
its delay, round(100 / fps) hundredths of a second (imageio's
`duration=1000 / fps` milliseconds: 25 at fps 4), and the file loops for
ever (a NETSCAPE2.0 extension with loop count 0). The pixels are coded by
LZW at a variable code width of 9 to 12 bits (code size 8), with a clear
code each time the decoder's table is full. The encoder codes runs only,
so that numpy computes every code at once: a run of one colour x takes
the literal x and then, code by code, the entry the decoder is about to
define (x x, then x x x, ...: 1 + 2 + ... + k pixels in k codes), and a
remainder of r pixels the entry of r x's it has defined already. A pixel
unlike its neighbour costs one code, so noise takes 9 to 12 bits a pixel
where a dictionary coder's matches would take fewer; a flat frame takes
about sqrt(2n) codes for n pixels.
"""

from __future__ import annotations

import struct
from typing import Sequence, Tuple

import numpy as np

LEVELS = (6, 7, 6)   # red, green, blue levels of the palette lattice
MIN_CODE_SIZE = 8
MAX_CODES = 4096     # 12-bit codes
CLEAR = 1 << MIN_CODE_SIZE
FIRST = CLEAR + 2    # the first code the table defines
# Codes between two clears: the decoder defines an entry with each code
# but the first, so after SEGMENT codes its table ends at MAX_CODES - 2
# and the encoder's, one entry ahead, is full.
SEGMENT = MAX_CODES - FIRST


def _channel_levels(n: int) -> np.ndarray:
    return np.round(np.arange(n) * 255.0 / (n - 1)).astype(np.int32)


def _nearest_level(n: int) -> np.ndarray:
    """The index of the nearest of `n` levels for each value 0..255 (ties:
    the lower level)."""
    levels = _channel_levels(n)
    return np.abs(np.arange(256)[:, None] - levels[None]).argmin(1)


_LUTS = [_nearest_level(n) for n in LEVELS]
_STRIDES = (LEVELS[1] * LEVELS[2], LEVELS[2], 1)


def _palette() -> np.ndarray:
    r, g, b = np.meshgrid(*[_channel_levels(n) for n in LEVELS],
                          indexing="ij")
    colours = np.stack([r.ravel(), g.ravel(), b.ravel()], -1)
    out = np.zeros((256, 3), np.uint8)
    out[:len(colours)] = colours
    return out


PALETTE = _palette()
MAX_ERROR = int(max(np.abs(np.arange(256) - _channel_levels(n)[lut]).max()
                    for n, lut in zip(LEVELS, _LUTS)))


def _as_frames(frames: Sequence[np.ndarray]) -> np.ndarray:
    """The frames as one (T, H, W, 3) uint8 array; raises on anything
    else."""
    arr = np.stack([np.asarray(f) for f in frames])
    if arr.dtype != np.uint8 or arr.ndim != 4 or arr.shape[-1] != 3 or \
            arr.shape[1] < 1 or arr.shape[2] < 1:
        raise ValueError(f"GIF frames: want (H, W, 3) uint8 frames, got "
                         f"{arr.dtype} {arr.shape[1:]}")
    if arr.shape[1] > 0xFFFF or arr.shape[2] > 0xFFFF or \
            arr.shape[1] * arr.shape[2] > _tri(SEGMENT):
        raise ValueError(f"GIF frames of {arr.shape[1:3]}: at most 65535 a "
                         f"side and {_tri(SEGMENT)} pixels (the longest run "
                         f"one table can code)")
    return arr


def palette_indices(frames: Sequence[np.ndarray]) -> np.ndarray:
    """(T, H, W) uint8 palette indices of the nearest colours."""
    arr = _as_frames(frames)
    idx = np.zeros(arr.shape[:3], np.int32)
    for c in range(3):
        idx += _LUTS[c][arr[..., c]] * _STRIDES[c]
    return idx.astype(np.uint8)


def quantize_frames(frames: Sequence[np.ndarray]) -> np.ndarray:
    """(T, H, W, 3) uint8: the frames as a decoder reads them back."""
    return PALETTE[palette_indices(frames)]


def _tri(k):
    return k * (k + 1) // 2


def _run_codes(lengths):
    """The codes a run of each length takes: k for the largest k with
    1 + ... + k <= length, one more for a remainder."""
    k = ((np.sqrt(8.0 * np.asarray(lengths) + 1) - 1) // 2).astype(np.int64)
    k -= _tri(k) > lengths          # the float root, corrected both ways
    k += _tri(k + 1) <= lengths
    return k + (_tri(k) < lengths)


def _pieces(values: np.ndarray, lengths: np.ndarray
            ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The runs cut so that each stretch between two clears takes at most
    SEGMENT codes -> (value, length, stretch) of each piece. A run cut at a
    clear goes on as a new run: with b codes left, its piece takes
    1 + ... + b pixels."""
    cum = np.concatenate([[0], np.cumsum(_run_codes(lengths))])
    out_v, out_l, out_s = [], [], []
    r, head, seg = 0, int(lengths[0]), 0
    while r < len(lengths):
        c = int(_run_codes(head))   # at most SEGMENT: see _as_frames
        # the head, then every whole run that fits, then a piece of the next
        j = int(np.searchsorted(cum, cum[r + 1] + SEGMENT - c, "right")) - 1
        left = SEGMENT - c - int(cum[j] - cum[r + 1])
        v = values[r:j]
        ln = np.concatenate([[head], lengths[r + 1:j]])
        if j < len(lengths) and left > 0:
            v = np.append(v, values[j])
            ln = np.append(ln, _tri(left))
            head = int(lengths[j]) - _tri(left)
        else:
            head = int(lengths[j]) if j < len(lengths) else 0
        out_v.append(v)
        out_l.append(ln)
        out_s.append(np.full(len(v), seg))
        r, seg = j, seg + 1
    return (np.concatenate(out_v), np.concatenate(out_l).astype(np.int64),
            np.concatenate(out_s))


def _width(code_index: np.ndarray) -> np.ndarray:
    """The width of the code at each index after a clear: the bit length of
    the largest code the decoder may receive then, FIRST - 1 + index (at
    least 9 bits, at most 12)."""
    return 9 + np.searchsorted([512, 1024, 2048], FIRST - 1 + code_index,
                               "right")


def lzw_codes(indices: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """GIF LZW of one image's palette indices (any shape, C order) ->
    (codes, widths) as int64 arrays: a clear code, the codes, a clear code
    after every SEGMENT codes, the end code."""
    idx = np.asarray(indices, np.uint8).ravel()
    starts = np.flatnonzero(np.concatenate([[True], idx[1:] != idx[:-1]]))
    values, lengths, seg = _pieces(
        idx[starts].astype(np.int64),
        np.diff(np.append(starts, idx.size)).astype(np.int64))
    ncode = _run_codes(lengths)
    k = ncode - (_tri(ncode) != lengths)     # the codes of 1 + ... + k
    rem = lengths - _tri(k)
    # each piece's first code index after its clear
    end = np.cumsum(ncode)
    seg_first = np.flatnonzero(np.concatenate([[True], seg[1:] != seg[:-1]]))
    seg_base = np.repeat(end[seg_first] - ncode[seg_first],
                         np.diff(np.append(seg_first, len(seg))))
    first = end - ncode - seg_base
    # every code: its piece and its place j in the piece
    piece = np.repeat(np.arange(len(values)), ncode)
    j = np.arange(int(end[-1])) - np.repeat(end - ncode, ncode)
    i = first[piece]
    codes = np.where(j == 0, values[piece], FIRST + i + j - 1)
    last = j == k[piece]                     # a remainder's code
    r = rem[piece]
    codes = np.where(last, np.where(r == 1, values[piece], FIRST + i + r - 2),
                     codes)
    widths = _width(i + j)
    # a clear before each stretch, the end code after the last
    per_seg = np.bincount(seg, ncode)
    seg_start = np.concatenate([[0], np.cumsum(per_seg)[:-1]]).astype(
        np.int64)
    marks = np.append(seg_start, int(end[-1]))
    mark_codes = np.append(np.full(len(seg_start), CLEAR), CLEAR + 1)
    mark_widths = np.concatenate([[MIN_CODE_SIZE + 1],
                                  _width(per_seg.astype(np.int64))])
    return (np.insert(codes, marks, mark_codes),
            np.insert(widths, marks, mark_widths))


def pack_codes(codes: np.ndarray, widths: np.ndarray) -> bytes:
    """The codes least significant bit first, each in its width."""
    codes = np.asarray(codes, np.int64)
    widths = np.asarray(widths, np.int64)
    offset = np.cumsum(widths) - widths
    shifted = codes << (offset & 7)          # at most 7 + 12 bits
    nbytes = int(-(-int(offset[-1] + widths[-1]) // 8))
    out = np.zeros(nbytes + 2, np.int64)
    for b in range(3):                       # the bits never overlap: add
        out += np.bincount((offset >> 3) + b, (shifted >> (8 * b)) & 0xFF,
                           minlength=nbytes + 2).astype(np.int64)
    return out[:nbytes].astype(np.uint8).tobytes()


def _sub_blocks(data: bytes) -> bytes:
    out = bytearray()
    for i in range(0, len(data), 255):
        chunk = data[i:i + 255]
        out.append(len(chunk))
        out += chunk
    out.append(0)
    return bytes(out)


def encode_gif(frames: Sequence[np.ndarray], fps: float = 4) -> bytes:
    """The bytes of a looping GIF of `frames` ((H, W, 3) uint8 each) at
    `fps` frames per second."""
    idx = palette_indices(frames)
    T, H, W = idx.shape
    delay = int(round(100 / fps))
    out = bytearray(b"GIF89a")
    # Logical screen: a global table of 2^(7+1) colours, 8 bits a channel.
    out += struct.pack("<HHBBB", W, H, 0xF7, 0, 0)
    out += PALETTE.tobytes()
    out += b"\x21\xff\x0bNETSCAPE2.0\x03\x01" + struct.pack("<H", 0) + \
        b"\x00"
    for t in range(T):
        out += b"\x21\xf9\x04\x00" + struct.pack("<H", delay) + b"\x00\x00"
        out += b"\x2c" + struct.pack("<HHHHB", 0, 0, W, H, 0)
        out.append(MIN_CODE_SIZE)
        out += _sub_blocks(pack_codes(*lzw_codes(idx[t])))
    out += b"\x3b"
    return bytes(out)


def write_gif(path: str, frames: Sequence[np.ndarray], fps: float = 4
              ) -> str:
    """Write `encode_gif(frames, fps)` to `path` -> path."""
    data = encode_gif(frames, fps)
    with open(path, "wb") as f:
        f.write(data)
    return path
