"""The share of the traced slice in which no operation ran on the card, in
%: one minus the union of device intervals over the slice's length."""


def read(ctx, name):
    sl = ctx.get("slice")
    if sl is None or sl.window_s <= 0:
        return None
    return 100.0 * (1.0 - sl.busy_s / sl.window_s)
