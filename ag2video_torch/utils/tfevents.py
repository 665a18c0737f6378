"""Minimal TensorBoard event-file writer (a copy of
ag2video_tpu/utils/tfevents.py, held byte for byte equal to it by
tests/test_torch_eval.py; no TF/tensorboard dependency).

The reference logs scalars through tensorboardX's SummaryWriter
(reference scripts/train.py:353, models/utils.py:78-81) so runs are
browsable in TensorBoard. Neither tensorflow nor tensorboard is available
in this environment, but the on-disk format is small and stable: a
TFRecord stream of serialized `tensorflow.Event` protos, each framed as

    uint64  length          (little-endian)
    uint32  masked_crc32c(length bytes)
    bytes   data
    uint32  masked_crc32c(data)

with the Event/Summary protos hand-encoded here (protobuf wire format is
just tag-prefixed varints/fixed-width scalars/length-delimited bytes).
Files written by this module load in stock TensorBoard.

Proto schema subset used (tensorflow/core/util/event.proto,
tensorflow/core/framework/summary.proto):

    Event   { double wall_time=1; int64 step=2; string file_version=3;
              Summary summary=5; }
    Summary { repeated Value value=1; }
    Value   { string tag=1; float simple_value=2; }
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Dict, Optional

# ---------------------------------------------------------------- crc32c
# CRC-32C (Castagnoli, poly 0x1EDC6F41 reflected = 0x82F63B78), the
# checksum TFRecord framing requires; zlib.crc32 is plain CRC-32 and does
# NOT match. Table-driven; plenty fast for scalar logging volumes.

_CRC_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ 0x82F63B78 if _c & 1 else _c >> 1
    _CRC_TABLE.append(_c)


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ _CRC_TABLE[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    """TFRecord masks the raw CRC so checksums of checksums stay valid."""
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ------------------------------------------------------- protobuf encode

def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _f64(field: int, v: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", v)      # wire type 1: 64-bit


def _f32(field: int, v: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", v)      # wire type 5: 32-bit


def _int(field: int, v: int) -> bytes:
    return _key(field, 0) + _varint(v & 0xFFFFFFFFFFFFFFFF)


def _bytes(field: int, v: bytes) -> bytes:
    return _key(field, 2) + _varint(len(v)) + v


def _summary_value(tag: str, value: float) -> bytes:
    return _bytes(1, tag.encode()) + _f32(2, float(value))


def encode_scalar_event(step: int, scalars: Dict[str, float],
                        wall_time: Optional[float] = None) -> bytes:
    summary = b"".join(_bytes(1, _summary_value(k, v))
                       for k, v in scalars.items())
    return (_f64(1, wall_time if wall_time is not None else time.time())
            + _int(2, int(step)) + _bytes(5, summary))


def encode_file_version_event(wall_time: Optional[float] = None) -> bytes:
    return (_f64(1, wall_time if wall_time is not None else time.time())
            + _bytes(3, b"brain.Event:2"))


def frame_record(data: bytes) -> bytes:
    header = struct.pack("<Q", len(data))
    return (header + struct.pack("<I", masked_crc32c(header))
            + data + struct.pack("<I", masked_crc32c(data)))


# --------------------------------------------------------------- writer

class TFEventsWriter:
    """Append-only scalar event stream TensorBoard can read.

    File name follows the convention TensorBoard globs for:
    events.out.tfevents.<unix_time>.<hostname>.
    """

    def __init__(self, output_dir: str):
        os.makedirs(output_dir, exist_ok=True)
        # pid suffix (as tensorboardX does): two writers created in the
        # same second on one host must not append to the same file — a
        # mid-stream file_version event is nonstandard.
        name = "events.out.tfevents.%d.%s.%d" % (
            int(time.time()), socket.gethostname() or "host", os.getpid())
        self.path = os.path.join(output_dir, name)
        self._f = open(self.path, "ab")
        self._f.write(frame_record(encode_file_version_event()))
        self._f.flush()

    def write_scalars(self, step: int, scalars: Dict[str, float],
                      wall_time: Optional[float] = None) -> None:
        clean = {k: float(v) for k, v in scalars.items()}
        if not clean:
            return
        self._f.write(frame_record(
            encode_scalar_event(step, clean, wall_time=wall_time)))
        self._f.flush()

    def close(self) -> None:
        self._f.close()
