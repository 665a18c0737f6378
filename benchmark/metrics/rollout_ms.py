"""Stream milliseconds from the start of the first action-graph rollout to the
end of the second, per call (CUDA events in forward hooks). Median over the spans
of the hooked calls; nothing where the program has no such module."""

from benchmark.stats import median


def read(ctx, name):
    spans = ctx.get("spans", {}).get("rollout")
    return median(spans) if spans else None
