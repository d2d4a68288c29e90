"""The factor stage's share of its roofline: the least time its work could
take on the device (max of flops over peak float32 rate and bytes over
peak bandwidth; the count in ``sapbench/work.py`` does not depend on
which implementation ran) over the device time of the operations inside
the program's ``factor`` spans, summed over the traced requests."""


def read(ctx):
    spans = ctx.spans.get("factor")
    device_s = ctx.trace.stage_device_s.get("factor", 0.0) if ctx.trace else 0.0
    if not spans or ctx.peaks is None or device_s <= 0:
        return None
    c = ctx.cell.config
    one = ctx.work.bound_s(ctx.work.factor_work(c["n"], c["k"], c["p"], c["variant"]),
                           ctx.peaks["float32_flops"], ctx.peaks["hbm_bytes_per_s"])
    return 100.0 * one * len(spans) / device_s
