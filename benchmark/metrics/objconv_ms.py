"""Device milliseconds per call of the fused factorized frontend conv
(ag2video_torch/csrc/objconv.cu, `ag_objconv_kernel`): its launches' summed
time in the traced slice over the slice's calls. Nothing where the trace
shows no such kernel (a program without it)."""


def read(ctx, name):
    sl = ctx.get("slice")
    if sl is None:
        return None
    seconds, launches = sl.seconds_of(r"ag_objconv_kernel")
    if launches == 0 or seconds <= 0:
        return None
    return seconds / sl.calls * 1e3
