"""Right-hand sides solved (the solve converged) over the whole window's
time; a run whose judged sample fails reads correct false beside it."""


def read(ctx):
    return ctx.solved / ctx.window_s if ctx.window_s > 0 and ctx.attempted else None
