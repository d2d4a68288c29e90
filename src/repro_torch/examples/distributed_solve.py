"""Distributed SaP solve across a rank mesh (the paper's technique as a
first-class distributed workload; partitions span every mesh axis).

    PYTHONPATH=src python -m repro_torch.examples.distributed_solve [--ranks 8] [--device cpu]

Starts ``--ranks`` processes (one gloo group, every rank on the same
device: the card unless ``--device`` names another) on a (2, ranks // 2)
("data", "model") mesh, the counterpart of the JAX script's 8 host
devices.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from repro_torch.core import SaPOptions, factor, plan_banded
from repro_torch.core.banded import band_to_dense, oscillatory_banded, random_banded
from repro_torch.examples import add_device_flag, resolve_device


def _system(n: int, k: int, hard: bool):
    """(band, b, x*): the script's d=1.0 band, or its d=0.5 oscillatory one."""
    band = oscillatory_banded(n, k, d=0.5, seed=0) if hard else random_banded(n, k, d=1.0, seed=0)
    xstar = np.random.default_rng(0).normal(size=n)
    return band, band_to_dense(torch.from_numpy(band)).numpy() @ xstar, xstar


def _run(mesh, dsap, band, b, n: int) -> dict:
    """One ``solve_step_fn`` call on this rank's rows, float32 throughout;
    the whole x (float64, on every rank) and the global diagnostics."""
    from repro_torch.core.distributed import gather_x, solve_step_fn

    band_p, b_p, parts = dsap.shard_band(band, b)
    step = solve_step_fn(dsap, tol=1e-6, maxiter=300)
    res = step(band_p.float(), b_p.float(), parts["d"], parts["e"], parts["f"],
               parts["b_next"], parts["c_prev"])
    return {"x": gather_x(res.x, mesh, n).double().cpu().numpy(),
            "iterations": float(res.iterations), "converged": bool(res.converged),
            "variant": dsap.variant, "d_factor": dsap.d_factor}


def rank_solves(device: str, n: int, k: int) -> dict | None:
    """One rank: the mesh, then C, D and E on the d=1.0 band and "auto" on
    the d=0.5 one.  Rank 0 returns the results, the others None."""
    import torch.distributed as dist

    from repro_torch.core.distributed import build_dist_sap
    from repro_torch.launch.mesh import make_test_mesh

    if torch.device(device).type == "cpu":
        torch.set_num_threads(1)  # the ranks share the host's cores
    ndev = dist.get_world_size()
    mesh = make_test_mesh((2, ndev // 2), ("data", "model"), device=device)
    out = {"shape": dict(mesh.shape)}
    band, b, _ = _system(n, k, hard=False)
    for variant in ("C", "D", "E"):
        dsap = build_dist_sap(mesh, n, k, variant=variant, p_per_device=2)
        out[variant] = _run(mesh, dsap, band, b, n)
    # the hard regime (d = 0.5, non-decaying spikes): truncation breaks
    # down; "auto" estimates d from rank-local rows and picks the exact
    # coupling, whose reduced chain is swept by distributed cyclic
    # reduction in ~log2(P) permutation rounds -- never gathered.
    band_h, b_h, _ = _system(n, k, hard=True)
    dsap = build_dist_sap(mesh, n, k, variant="auto", p_per_device=2, band=band_h)
    out["auto"] = _run(mesh, dsap, band_h, b_h, n)
    return out if mesh.rank == 0 else None


def run(device=None, ranks: int = 8, n: int = 4096, k: int = 12) -> dict:
    """The distributed solves on ``ranks`` processes, then the
    single-process lifecycle reference; returns rank 0's results."""
    from repro_torch.examples import distributed_solve as this  # the ranks import it by name
    from repro_torch.launch.mesh import spawn_ranks

    dev = resolve_device(device)
    if ranks < 2 or ranks % 2:
        raise ValueError(f"--ranks must be even and at least 2, not {ranks}")
    got = spawn_ranks(this.rank_solves, ranks, args=(str(dev), n, k))[0]
    print(f"mesh: {got['shape']} ({ranks} ranks on {dev})")

    _, _, xstar = _system(n, k, hard=False)
    for variant in ("C", "D", "E"):
        res = got[variant]
        err = np.linalg.norm(res["x"] - xstar) / np.linalg.norm(xstar)
        print(
            f"  SaP-{variant}: P={ranks * 2} partitions"
            f"  iters={res['iterations']:5.2f}  relerr={err:.2e}"
            f"  converged={res['converged']}"
        )
    res = got["auto"]
    err = np.linalg.norm(res["x"] - xstar) / np.linalg.norm(xstar)
    print(
        f"  SaP-auto @ d=0.5 -> {res['variant']}"
        f" (d_factor={res['d_factor']:.3f})  iters={res['iterations']:5.2f}"
        f"  relerr={err:.2e}"
    )

    # single-process lifecycle reference: factor once, reuse the handle
    band, b, _ = _system(n, k, hard=False)
    fac = factor(plan_banded(torch.tensor(band, dtype=torch.float32),
                             SaPOptions(p=8, variant="C", tol=1e-6, maxiter=300), dev))
    ref = fac.solve(torch.tensor(b, dtype=torch.float32))
    err = np.linalg.norm(ref.x.cpu().numpy() - xstar) / np.linalg.norm(xstar)
    print(f"  lifecycle reference (1 process): iters={float(ref.iterations):5.2f}"
          f"  relerr={err:.2e}")
    print("distributed solve OK (preconditioner comms: neighbour permutations "
          "+ log-depth shift rounds for variant E)")
    return {**got, "reference": {"x": ref.x.double().cpu().numpy(),
                                 "iterations": float(ref.iterations)}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--ranks", type=int, default=8,
                    help="processes in the mesh (the JAX script's host device count)")
    add_device_flag(ap)
    args = ap.parse_args(argv)
    run(args.device, args.ranks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
