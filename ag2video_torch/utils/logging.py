"""Metrics logging (a copy of ag2video_tpu/utils/logging.py, held equal to it
by tests/test_torch_eval.py; reference: tensorboardX SummaryWriter +
console dumps, scripts/train.py:353, models/utils.py:78-81).

tensorboardX is not available here; scalars go to a JSONL stream
(`<output_dir>/metrics.jsonl`, one line per write) which is trivially
plottable and greppable, plus the console. A TensorBoard-readable
events.out.tfevents.* twin is written alongside by default
(utils/tfevents.py — pure-Python encoder, no TF dependency) so runs are
browsable with stock TensorBoard exactly like the reference's.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict, Optional

log = logging.getLogger(__name__)


class MetricsWriter:
    def __init__(self, output_dir: str, every: int = 1,
                 tfevents: bool = True):
        os.makedirs(output_dir, exist_ok=True)
        self.path = os.path.join(output_dir, "metrics.jsonl")
        self.every = every
        self._f = open(self.path, "a")
        self._tb = None
        if tfevents:
            from ag2video_torch.utils.tfevents import TFEventsWriter
            self._tb = TFEventsWriter(output_dir)

    def write(self, step: int, scalars: Dict[str, float]) -> None:
        if self.every > 1 and step % self.every != 0:
            return
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: float(v) for k, v in scalars.items()})
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self._tb is not None:
            self._tb.write_scalars(step, scalars)

    def close(self) -> None:
        self._f.close()
        if self._tb is not None:
            self._tb.close()
