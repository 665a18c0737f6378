#!/usr/bin/env python3
"""Export a run's metrics.jsonl to a TensorBoard event file (the twin of
tools/jsonl_to_tfevents.py, over the port's utils/tfevents.py).

Runs recorded before the tfevents tee existed, or with it disabled, can be
made TensorBoard-browsable after the fact:

    python3 torch_tools/jsonl_to_tfevents.py <run_dir> [...] [--force]

Each <run_dir> must contain metrics.jsonl (the MetricsWriter stream); an
events.out.tfevents.* file is written next to it, keeping each row's step
and wall time. A run directory that already holds an event file is skipped
unless --force is given (TensorBoard merges the files of one directory, so
a second file would show every scalar twice). `read_events(path)` reads an
event file's scalars back.
"""

from __future__ import annotations

import glob
import json
import os
import struct
import sys
from typing import List, Tuple

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from ag2video_torch.utils.tfevents import (TFEventsWriter,  # noqa: E402
                                           masked_crc32c)


def convert(run_dir: str, force: bool = False) -> str:
    src = os.path.join(run_dir, "metrics.jsonl")
    if not os.path.exists(src):
        raise FileNotFoundError(src)
    existing = glob.glob(os.path.join(run_dir, "events.out.tfevents.*"))
    if existing and not force:
        print(f"{run_dir}: skipped — event file(s) already present "
              f"({os.path.basename(existing[0])}); pass --force to convert "
              "anyway")
        return existing[0]
    writer = TFEventsWriter(run_dir)
    n = 0
    with open(src) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            step = int(rec.pop("step", n))
            # A wall time of 0 is kept: only an absent "time" falls back to
            # the conversion's clock.
            wall = rec.pop("time", None)
            wall = float(wall) if wall is not None else None
            # bool is an int subclass: boolean columns are left out rather
            # than exported as 0/1.
            scalars = {k: float(v) for k, v in rec.items()
                       if isinstance(v, (int, float))
                       and not isinstance(v, bool)}
            if scalars:
                writer.write_scalars(step, scalars, wall_time=wall)
                n += 1
    writer.close()
    print(f"{run_dir}: {n} rows -> {writer.path}")
    return writer.path


def _fields(buf: bytes):
    """Yield (field number, wire type, value) of a protobuf message: an int
    for varints, bytes for 8-byte, 4-byte and length-delimited fields."""
    pos = 0
    while pos < len(buf):
        key, pos = _varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            value, pos = _varint(buf, pos)
        elif wire == 1:
            value, pos = buf[pos:pos + 8], pos + 8
        elif wire == 5:
            value, pos = buf[pos:pos + 4], pos + 4
        elif wire == 2:
            n, pos = _varint(buf, pos)
            value, pos = buf[pos:pos + n], pos + n
        else:
            raise ValueError(f"protobuf wire type {wire}")
        yield field, wire, value


def _varint(buf: bytes, pos: int):
    out = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return out, pos


def read_events(path: str) -> List[Tuple[int, float, str, float]]:
    """The scalars of an event file as (step, wall time, tag, value), in
    file order (the file-version record carries none); each record's
    length and data CRCs are checked."""
    with open(path, "rb") as f:
        data = f.read()
    out, pos = [], 0
    while pos < len(data):
        header = data[pos:pos + 8]
        (length,) = struct.unpack("<Q", header)
        payload = data[pos + 12:pos + 12 + length]
        crcs = struct.unpack("<II", data[pos + 8:pos + 12] +
                             data[pos + 12 + length:pos + 16 + length])
        if crcs != (masked_crc32c(header), masked_crc32c(payload)):
            raise ValueError(f"{path}: bad CRC at byte {pos}")
        pos += 16 + length
        step, wall, values = 0, 0.0, []
        for field, _, value in _fields(payload):
            if field == 1:
                (wall,) = struct.unpack("<d", value)
            elif field == 2:
                step = value
            elif field == 5:
                for f2, _, v in _fields(value):
                    if f2 != 1:
                        continue
                    tag, x = None, None
                    for f3, _, v3 in _fields(v):
                        if f3 == 1:
                            tag = v3.decode()
                        elif f3 == 2:
                            (x,) = struct.unpack("<f", v3)
                    values.append((tag, x))
        out.extend((step, wall, tag, x) for tag, x in values)
    return out


if __name__ == "__main__":
    argv = sys.argv[1:]
    force = "--force" in argv
    dirs = [a for a in argv if a != "--force"]
    if not dirs:
        sys.exit(__doc__)
    for d in dirs:
        convert(d, force=force)
