"""Device kernels launched per call, from the traced slice."""


def read(ctx, name):
    sl = ctx.get("slice")
    if sl is None or not sl.kernels:
        return None
    return len(sl.kernels) / sl.calls
