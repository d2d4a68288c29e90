"""The solve stage's share of its roofline: for each traced request the
least time of the preconditioner applies and band matvecs of the whole
sweeps it ran (``sapbench/work.py``), summed, over the device time of the
operations inside the program's ``krylov`` spans."""

import math


def read(ctx):
    device_s = ctx.trace.stage_device_s.get("krylov", 0.0) if ctx.trace else 0.0
    if not ctx.spans.get("krylov") or ctx.peaks is None or device_s <= 0:
        return None
    c, w = ctx.cell.config, ctx.work
    bound = 0.0
    for its in ctx.iterations:
        sweeps = math.ceil(max(its))
        work = w.solve_work(c["n"], c["k"], c["p"], c["variant"], len(its), sweeps)
        bound += w.bound_s(work, ctx.peaks["float32_flops"], ctx.peaks["hbm_bytes_per_s"])
    return 100.0 * bound / device_s
