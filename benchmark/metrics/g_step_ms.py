"""Device milliseconds per iteration of the training step's G step (the
program's `ag2v.train.g` span: the generator's forward, its losses against
the frozen discriminator, the backward, the NaN check and the generator's
Adam): the operations launched inside the span from any thread, the
backward's own thread included (benchmark/span_launches.py), summed over
the traced slice over its iterations."""

from benchmark import span_launches


def read(ctx, name):
    return span_launches.device_ms_per_call(ctx, "ag2v.train.g")
