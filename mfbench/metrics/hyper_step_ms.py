"""Device milliseconds of one AdaptReg epoch's hypergradient steps: the
median, over the recorded epochs, of the summed device ms of an epoch's
eight ``tmf.hyper_step`` spans (the K validation rows gathered after each
segment, the step and its clamp), recorded in the traced run's warm-up
jobs after the first (``algs/admf.py``). None where the program records
no such span."""

from mfbench.algs.admf import median_span_ms


def read(ctx):
    return median_span_ms(ctx, "tmf.hyper_step")
