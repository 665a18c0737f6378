"""Stream milliseconds of one frame step (flow network, warp, frontend and
SPADE generator), per generated frame (CUDA events in forward hooks). Median over the spans
of the hooked calls; nothing where the program has no such module."""

from benchmark.stats import median


def read(ctx, name):
    spans = ctx.get("spans", {}).get("frame")
    return median(spans) if spans else None
