"""The whole call's share of the card's bf16 peak, in %: the model's FLOPs
per call (FlopCounterMode over the plain reference at the cell's shapes,
benchmark/flops.py) times the calls of the untraced window, over the
window's seconds times 989e12."""

from benchmark import peaks


def read(ctx, name):
    if not ctx.get("flops_per_call") or not ctx.get("window_s"):
        return None
    return 100.0 * ctx["flops_per_call"] * ctx["calls"] / (
        ctx["window_s"] * peaks.BF16_FLOPS)
