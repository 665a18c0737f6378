"""Device milliseconds per iteration of the graph step (the program's
`ag2v.train.graph` span: the box rollout on the long clips, its loss, the
backward, the NaN check and the rollout's Adam), launched from any thread
(benchmark/span_launches.py), summed over the traced slice over its
iterations."""

from benchmark import span_launches


def read(ctx, name):
    return span_launches.device_ms_per_call(ctx, "ag2v.train.graph")
