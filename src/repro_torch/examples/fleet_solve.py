"""Fleet solves: batched many-system factorization + the SolverEngine.

The paper's target workload is sequences of moderate banded systems
(implicit time integration: one Jacobian reused across many steps, many
independent scenarios in flight).  This example runs that workload two
ways:

1. the batched lifecycle -- ``batch_plan``/``batch_factor`` factor a
   whole fleet in one pass of each kernel, ``solve_batch`` solves it in
   one batched Krylov run;
2. the serving path -- heterogeneous requests through ``SolverEngine``:
   shape-bucketed, identity-padded, with an LRU factorization cache so
   repeated Jacobians skip straight to the Krylov stage.

    PYTHONPATH=src python -m repro_torch.examples.fleet_solve [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch.configs.sap_solver import fleet
from repro_torch.core import SaPOptions, batch_factor, batch_plan, factor, plan_banded
from repro_torch.core.banded import band_matvec, random_banded
from repro_torch.examples import add_device_flag, resolve_device, sync


def batched_lifecycle_demo(dev: torch.device):
    print("== batched lifecycle: 32 systems, one batched factor+solve ==")
    s, n, k = 32, 2048, 8
    opts = SaPOptions(p=8, variant="C", tol=1e-6, maxiter=200)
    bands = [torch.tensor(random_banded(n, k, d=1.0, seed=i), dtype=torch.float32, device=dev)
             for i in range(s)]
    rng = np.random.default_rng(0)
    xs = np.stack([rng.normal(size=n) for _ in range(s)])
    bmat = torch.stack([band_matvec(bands[i], torch.tensor(xs[i], dtype=torch.float32,
                                                           device=dev))
                        for i in range(s)])

    t0 = time.perf_counter()
    for i in range(s):  # the naive way: one lifecycle per system
        factor(plan_banded(bands[i], opts, dev)).solve(bmat[i])
        sync(dev)
    t_loop = time.perf_counter() - t0

    bfac = batch_factor(batch_plan(bands, opts, device=dev))  # the warm call
    res = bfac.solve_batch(bmat)
    sync(dev)
    t0 = time.perf_counter()
    bfac = batch_factor(batch_plan(bands, opts, device=dev))
    res = bfac.solve_batch(bmat)
    sync(dev)
    t_batched = time.perf_counter() - t0

    err = np.abs(res.x.cpu().numpy()[:, :n] - xs).max()
    print(f"  python loop   : {t_loop * 1e3:9.1f} ms")
    print(f"  batched       : {t_batched * 1e3:9.1f} ms "
          f"({t_loop / t_batched:.1f}x)  maxerr={err:.1e} "
          f"conv={bool(res.converged.all())}")


def engine_demo(dev: torch.device):
    print("== SolverEngine: heterogeneous fleet, cached factorizations ==")
    cfg = fleet()
    eng = cfg.to_engine(p=8, device=dev)
    rng = np.random.default_rng(1)
    # 4 distinct Jacobians of different (N, K), re-solved over 8 "time
    # steps" with fresh right-hand sides: 32 requests, 4 factorizations.
    mats = [np.float32(random_banded(1500 + 700 * i, 8 + 4 * (i % 2), d=1.1, seed=i))
            for i in range(4)]
    for _ in range(8):
        for band in mats:
            # float32, as the JAX package takes these float64 draws (x64 off)
            eng.submit_system(band, np.float32(rng.normal(size=band.shape[0])))
    done = eng.run_until_drained()
    conv = all(r.result.converged for r in done)
    buckets = sorted({r.result.bucket for r in done})
    print(f"  solved={len(done)} conv={conv} steps={eng.stats['steps']}")
    print(f"  factored={eng.stats['factored_systems']} "
          f"cache_hit_rate={eng.cache_hit_rate:.0%} "
          f"throughput={eng.systems_per_second:.1f} sys/s")
    print(f"  buckets (N', K', P): {buckets}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    add_device_flag(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    batched_lifecycle_demo(dev)
    engine_demo(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
