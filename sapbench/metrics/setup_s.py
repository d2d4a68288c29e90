"""Seconds from the process's start to the first timed request: imports,
the kernels' build or load, the inputs and the warm-up requests."""


def read(ctx):
    return ctx.setup_s
