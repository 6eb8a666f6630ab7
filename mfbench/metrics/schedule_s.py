"""Seconds from the trainer's call to its epoch loop's start: the
schedule's runners, their plan builds and uploads (``train.loop``). The
loop's start is the first epoch line's host time less the elapsed time
it logs, so epoch 1's eval is counted in too."""


def read(ctx):
    return ctx.schedule_s
