"""Milliseconds of the per-epoch test eval (``models/mf.py: rmse``) in
the traced window: from the end of the training loop's device
synchronize to the harness's mark at the epoch line, averaged."""


def read(ctx):
    evals = ctx.trace.evals_s if ctx.trace is not None else []
    if not evals:
        return None
    return 1e3 * sum(evals) / len(evals)
