"""Device milliseconds per iteration of the training step's D steps (the
program's `ag2v.train.d` spans: the discriminator on the detached frames
and the real ones, the backward, the NaN check and its Adam), launched
from any thread (benchmark/span_launches.py), summed over the traced
slice over its iterations."""

from benchmark import span_launches


def read(ctx, name):
    return span_launches.device_ms_per_call(ctx, "ag2v.train.d")
