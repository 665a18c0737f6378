"""Stream milliseconds of one SPADE generator call, per generated frame
(CUDA events in forward hooks). Median over the spans
of the hooked calls; nothing where the program has no such module."""

from benchmark.stats import median


def read(ctx, name):
    spans = ctx.get("spans", {}).get("spade")
    return median(spans) if spans else None
