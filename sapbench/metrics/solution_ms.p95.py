"""The 95th percentile (nearest rank) of every request's time in the
window, start to x ready on the device, in milliseconds."""


def read(ctx):
    return ctx.percentile(ctx.latencies_s, 95) * 1e3 if ctx.latencies_s else None
