"""Percent of the least time the card could take for the traced window's
epochs and evals (``work/``, at the published HBM and bf16 peaks) in the
time any device operation ran in the window."""

from mfbench.peaks import least_seconds


def read(ctx):
    if ctx.trace is None or ctx.trace.busy_s <= 0 or not ctx.trace_epochs:
        return None
    w = ctx.epoch_work
    least = ctx.trace_epochs * least_seconds(w["bytes"], w["ops"])
    return 100.0 * least / ctx.trace.busy_s
