"""The rasterizer kernel's share of its roofline, in %: the least time of
its launches, max(bytes / HBM rate, flops / bf16 peak) with each input read
once and the bf16 layout written once (benchmark/flops.py), over the
kernels' summed time in the traced slice. Nothing where the cell does not
rasterize or the trace shows no such kernel."""

from benchmark import flops, peaks


def read(ctx, name):
    sl, shape = ctx.get("slice"), ctx.get("raster_shape")
    if sl is None or shape is None:
        return None
    seconds, launches = sl.seconds_of(r"rasterize")
    if launches == 0 or seconds <= 0:
        return None
    nbytes, nflops = flops.rasterize_bytes_flops(*shape)
    bound = max(nbytes / peaks.HBM_BYTES_PER_S, nflops / peaks.BF16_FLOPS)
    # The bound of one call's layouts (all B*T frames) times the calls.
    return 100.0 * bound * sl.calls / seconds
