"""Host milliseconds from a call to its return, before any synchronise
(the enqueue cost): median over the window's calls."""

from benchmark.stats import median


def read(ctx, name):
    return median(ctx["host_s"]) * 1e3 if ctx.get("host_s") else None
