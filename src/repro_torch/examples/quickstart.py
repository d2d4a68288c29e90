"""Quickstart: the plan/factor/solve lifecycle of SaP on PyTorch.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch.core import (
    SaPOptions,
    factor,
    plan,
    plan_banded,
    solve_banded,
    solve_sparse,
)
from repro_torch.core.banded import band_to_dense, random_banded, random_rhs
from repro_torch.core.sparse import random_sparse
from repro_torch.examples import add_device_flag, resolve_device, sync


def _relerr(x, xstar) -> float:
    x = x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return float(np.linalg.norm(x - xstar) / np.linalg.norm(xstar))


def dense_banded_demo(dev: torch.device) -> dict:
    print("== dense banded: N=4096, K=16, d=1.0 (paper Sec 4.1) ==")
    n, k = 4096, 16
    band = torch.tensor(random_banded(n, k, d=1.0, seed=0), dtype=torch.float32, device=dev)
    dense = band_to_dense(band).cpu().numpy()
    xstar = np.random.default_rng(0).normal(size=n)
    b = torch.tensor(dense @ xstar, dtype=torch.float32, device=dev)

    results = {}
    for variant in ("C", "D"):
        fac = factor(plan_banded(band, SaPOptions(p=8, variant=variant, tol=1e-6), dev))
        res = results[variant] = fac.solve(b)
        print(
            f"  SaP-{variant}: iters={float(res.iterations):5.2f}  "
            f"relerr={_relerr(res.x, xstar):.2e}  converged={bool(res.converged)}"
        )
    return results


def amortization_demo(dev: torch.device):
    print("== factor once, solve many (the lifecycle win) ==")
    n, k, nrhs = 4096, 16, 16
    band = torch.tensor(random_banded(n, k, d=1.0, seed=2), dtype=torch.float32, device=dev)
    dense = band_to_dense(band).cpu().numpy()
    xs = np.random.default_rng(2).normal(size=(n, nrhs))
    bmat = torch.tensor(dense @ xs, dtype=torch.float32, device=dev)
    opts = SaPOptions(p=8, variant="C", tol=1e-6)

    t0 = time.perf_counter()
    for j in range(nrhs):
        solve_banded(band, bmat[:, j], opts, dev)  # re-plans + re-factors each call
    t_oneshot = time.perf_counter() - t0

    fac = factor(plan_banded(band, opts, dev))  # expensive stages paid once
    fac.solve_many(bmat)  # the warm call
    sync(dev)
    t0 = time.perf_counter()
    res = fac.solve_many(bmat)
    sync(dev)
    t_amortized = time.perf_counter() - t0

    err = np.abs(res.x.cpu().numpy() - xs).max()
    print(f"  one-shot x{nrhs}:      {t_oneshot*1e3:8.1f} ms")
    print(f"  factor-once x{nrhs}:   {t_amortized*1e3:8.1f} ms "
          f"({t_oneshot/t_amortized:.1f}x, maxerr={err:.1e})")


def sparse_demo(dev: torch.device):
    print("== sparse: scrambled banded provenance (paper Sec 4.3) ==")
    n = 2000
    csr = random_sparse(n, avg_nnz_per_row=6.0, d=1.2, shuffle=True, seed=1)
    xstar = random_rhs(n)
    b = csr.to_dense() @ xstar

    pl = plan(csr, SaPOptions(p=8, variant="C", tol=1e-8), dev)
    fac = factor(pl)
    res = fac.solve(torch.tensor(b, dtype=torch.float32))
    print(
        f"  K after DB+CM reordering: {pl.info['k_after_reorder']}  "
        f"iters={float(res.iterations):.2f}  relerr={_relerr(res.x, xstar):.2e}"
    )
    # float32, as the JAX package takes the script's float64 b (x64 off)
    sol2 = solve_sparse(csr, np.float32(b),
                        SaPOptions(p=8, variant="C", tol=1e-8, drop_tol=0.02), dev)
    print(f"  with 2% drop-off: K={sol2.k} iters={sol2.iterations:.2f} "
          f"relerr={_relerr(sol2.x, xstar):.2e}")


def run(device=None) -> dict:
    """The three demos; returns the dense demo's solve results by variant."""
    dev = resolve_device(device)
    dense = dense_banded_demo(dev)
    amortization_demo(dev)
    sparse_demo(dev)
    print("quickstart OK")
    return dense


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    add_device_flag(ap)
    args = ap.parse_args(argv)
    run(args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
