"""Percent of the least time the card could take for one AdaptReg epoch's
segment walks (``work/admf.py``: ``segment_bytes`` and ``segment_ops``, at
the published HBM and bf16 peaks) in the device time of the median
recorded epoch's walks: the summed device ms of its eight
``tmf.adreg_segment`` spans (each segment's validation rows gathered before
its walk, and the walk), recorded in the traced run's warm-up jobs after
the first (``algs/admf.py``). None where the program records no such
span."""

from mfbench.algs.admf import median_span_ms
from mfbench.peaks import least_seconds


def read(ctx):
    ms = median_span_ms(ctx, "tmf.adreg_segment")
    w = ctx.epoch_work
    if not ms or "segment_bytes" not in w:
        return None
    least = least_seconds(w["segment_bytes"], w["segment_ops"])
    return 100.0 * least / (ms / 1e3)
