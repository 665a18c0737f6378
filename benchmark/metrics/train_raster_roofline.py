"""The rasterizer kernel's share of its roofline over a training
iteration's launches, in %: the least time of each launch at its own shape
(`raster_shapes`, one iteration's, from the configuration), max(bytes /
HBM rate, flops / bf16 peak) with each input read once and the bf16 layout
written once (benchmark/flops.py), summed, times the slice's iterations,
over the kernels' summed time in the traced slice. Nothing where the cell
does not rasterize, or where the trace's launch count is not the
configuration's (the driver notes it)."""

from benchmark import flops, peaks


def read(ctx, name):
    sl, shapes = ctx.get("slice"), ctx.get("raster_shapes")
    if sl is None or not shapes:
        return None
    seconds, launches = sl.seconds_of(r"rasterize")
    if launches != len(shapes) * sl.calls or seconds <= 0:
        return None
    bound = 0.0
    for shape in shapes:
        nbytes, nflops = flops.rasterize_bytes_flops(*shape)
        bound += max(nbytes / peaks.HBM_BYTES_PER_S,
                     nflops / peaks.BF16_FLOPS)
    return 100.0 * bound * sl.calls / seconds
