"""Host reads of device state a Krylov run, over the traced process: the
program's ``host_syncs`` counter over its ``solves`` counter
(``repro_torch.obs.trace.counters``), the set-up's and the warm-up's
requests included.  None where the program has no such counters or ran
no solve."""


def read(ctx):
    try:
        from repro_torch.obs.trace import counters
    except ImportError:
        return None
    c = counters()
    return c["host_syncs"] / c["solves"] if c.get("solves") else None
