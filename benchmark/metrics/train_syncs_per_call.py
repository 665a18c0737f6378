"""Host-blocking CUDA runtime calls (stream, device and event
synchronises, blocking `cudaMemcpy`) started inside the training step's
spans (`ag2v.train.upload`, `.g`, `.d`, `.graph`), from any thread, per
iteration of the traced slice. The NaN guard's finiteness checks are
among them."""

from benchmark import span_launches

SPANS = ("ag2v.train.upload", "ag2v.train.g", "ag2v.train.d",
         "ag2v.train.graph")


def read(ctx, name):
    return span_launches.syncs_per_call(ctx, SPANS)
