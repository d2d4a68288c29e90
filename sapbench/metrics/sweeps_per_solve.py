"""BiCGStab(2) iterations (in quarters, as the program counts them) a
right-hand side, the mean over every right-hand side of the window."""


def read(ctx):
    its = [v for request in ctx.iterations for v in request]
    return sum(its) / len(its) if its else None
