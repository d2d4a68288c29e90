"""Peak device memory allocated in the window less what the harness's own
inputs held before it (systems, right-hand-side buffer, sample slots): the
program's memory at its peak, a factorization held since set-up included."""


def read(ctx):
    return ctx.work_mem_bytes / 2**30 if ctx.work_mem_bytes > 0 else None
