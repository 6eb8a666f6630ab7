"""Percent of the card's bf16 peak that the traced window's rating
updates make of its host seconds: 6 (dim + 2) model operations per
update."""

from mfbench.peaks import BF16_FLOPS


def read(ctx):
    if not ctx.trace_epochs or ctx.trace_window_s <= 0:
        return None
    flops = ctx.trace_epochs * ctx.epoch_work["model_flops"]
    return 100.0 * flops / (ctx.trace_window_s * BF16_FLOPS)
