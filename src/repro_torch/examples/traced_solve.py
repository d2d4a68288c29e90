"""Traced end-to-end solve: lifecycle spans -> stage tree + Perfetto trace.

Runs the full pipeline the source paper times stage-by-stage -- DB/CM
reordering, block-LU + SPIKE factorization, BiCGStab(2) iteration -- on a
shuffled sparse system in the non-dominant regime (d < 1, so ``auto``
resolves to variant E and the exact reduced system appears in the trace),
under an active :class:`repro_torch.obs.Tracer`.  Prints the merged stage
tree (with the card's time of each factor stage, ``device_s``: the stage
spans under ``factor`` no longer wait for the card, so their host times
are the launches'), the Krylov convergence history and the solver's
counters, then writes a Chrome/Perfetto trace_event JSON -- open it at
https://ui.perfetto.dev.

    PYTHONPATH=src python -m repro_torch.examples.traced_solve [--smoke] [--out DIR]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

from repro_torch.core import SaPOptions, factor, plan
from repro_torch.core.sparse import random_sparse
from repro_torch.examples import add_device_flag, resolve_device
from repro_torch.obs import Tracer, counters, use_tracer


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--smoke", action="store_true",
                    help="small system (CI smoke job)")
    ap.add_argument("--out", default=".",
                    help="directory for trace.json (default: cwd)")
    add_device_flag(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    n = 400 if args.smoke else 1024
    # d < 1: oscillatory / non-dominant, the regime where truncation fails
    # and the exact reduced system (variant E) must be solved.
    csr = random_sparse(n, avg_nnz_per_row=5.0, d=0.5, shuffle=True, seed=3)
    dense = csr.to_dense()
    xstar = np.random.default_rng(4).normal(size=n)
    b = torch.tensor(dense @ xstar, dtype=torch.float32, device=dev)
    opts = SaPOptions(p=8, variant="auto", tol=1e-8, maxiter=300)

    # factor and krylov wait for the card as they close; the factor's stage
    # spans are timed on the card by CUDA-event pairs (device_s)
    tracer = Tracer()
    before = counters()
    with use_tracer(tracer):
        fac = factor(plan(csr, opts, dev))
        res = fac.solve(b, record_history=True)
    steps = {k: v - before[k] for k, v in counters().items()}

    err = np.linalg.norm(res.x.cpu().numpy() - xstar) / np.linalg.norm(xstar)
    hist = res.history.cpu().numpy()
    track = hist[~np.isnan(hist)]
    print(f"variant={fac.variant}  converged={bool(res.converged)}  "
          f"iters={float(res.iterations):.2f}  relerr={err:.2e}")
    print(f"convergence history ({track.size} sweeps): "
          f"{track[0]:.3e} -> {track[-1]:.3e}")
    print(f"counters: {steps}")
    print()
    print(tracer.summary())
    print()
    for sp in tracer.find("factor")[0].children:
        dev_t = "not timed (CPU)" if sp.device_s is None else f"{sp.device_s * 1e3:.3f} ms"
        print(f"{sp.name:<16} host {sp.duration_s * 1e3:8.3f} ms   device {dev_t}")

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    path = tracer.export_chrome(str(out / "trace.json"))
    print(f"\nwrote {path}  (open at https://ui.perfetto.dev)")
    return 0 if bool(res.converged) else 1


if __name__ == "__main__":
    sys.exit(main())
