"""sap-solver -- the paper's own workload, as the port runs it.

Dense banded linear solve A x = b (paper Sec. 4.1): truncated-SPIKE (or
exact reduced system) preconditioner + BiCGStab(2), on one card.  The
configurations are the JAX package's (``repro/configs/sap_solver.py``),
copied field for field; ``to_sap_options`` / ``to_engine`` /
``to_service`` build the port's objects on ``device`` (default: the
card).

Shapes mirror the paper's experiments:
  * dense_200k  -- N=200,000  K=200  (paper Table 4.1 / 4.2 setting)
  * dense_1m    -- N=1,048,576 K=500 (paper Table 4.3 largest row)
  * dense_4m    -- N=4,194,304 K=200 (beyond-paper scale-out cell)
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    name: str
    n: int
    k: int
    # "C" truncated coupled | "D" decoupled | "E" exact reduced interface
    # chain (distributed cyclic reduction) | "auto" (C at d >= 1 else E)
    variant: str = "C"
    # reduced-chain solver for variant E: "chain" | "bcr" | "auto" (bcr
    # once the chain is long enough).
    reduced_solver: str = "auto"
    p_per_device: int = 1
    d: float = 1.0  # diagonal dominance of the generated test matrix
    tol: float = 1e-8
    maxiter: int = 200
    precond_dtype: str = "float32"
    # batching knobs (the fleet-serving path: repro_torch.serve.solver_engine).
    # max_batch caps the per-step system batch; fac_cache sizes the LRU of
    # cached factorizations (keyed by matrix fingerprint); bucket_rounding
    # controls how heterogeneous (N, K) requests share compiled shapes
    # ("pow2" = round up to powers of two, "exact" = identical shapes only).
    max_batch: int = 32
    fac_cache: int = 128
    bucket_rounding: str = "pow2"
    # admission / scheduling knobs (the async serving path:
    # repro_torch.serve.service.AsyncSolverService).  queue_cap bounds the
    # pending set before submit blocks or raises QueueFull; deadline_s is
    # the default per-request deadline (None = no deadline); the thrash
    # guard widens bucket_rounding "exact" -> "pow2" when the LRU sheds
    # more than thrash_ratio factorizations per solve over a window of
    # thrash_window solves.
    queue_cap: int = 256
    deadline_s: float | None = None
    thrash_window: int = 32
    thrash_ratio: float = 0.5
    # observability: upper bucket edges for the service's latency-style
    # histograms (time_in_queue_s).  None keeps the library default
    # (repro_torch.serve.metrics.DEFAULT_BOUNDS, 100us..60s); a deployment with
    # a tight latency envelope narrows these to get p99 resolution where
    # its traffic actually lands.
    hist_bounds: tuple[float, ...] | None = None
    # roofline cost accounting (repro_torch.obs.cost): flops / bytes /
    # roofline-seconds attribution on the engine, counted once per bucket
    # the first time it is seen.  Off by default -- serving deployments
    # that dashboard achieved-vs-roofline turn it on.
    cost_accounting: bool = False

    def to_sap_options(self, p: int):
        """Map this workload config onto the port's solver options."""
        from ..core.sap import SaPOptions

        return SaPOptions(
            p=p,
            variant=self.variant,
            reduced_solver=self.reduced_solver,
            tol=self.tol,
            maxiter=self.maxiter,
            precond_dtype=self.precond_dtype,
        )

    def to_engine(self, p: int, device=None):
        """Build the fleet-serving engine this workload config describes."""
        from ..serve.solver_engine import SolverEngine

        return SolverEngine(
            self.to_sap_options(p),
            max_batch=self.max_batch,
            cache_size=self.fac_cache,
            rounding=self.bucket_rounding,
            cost_accounting=self.cost_accounting,
            device=device,
        )

    def to_service(self, p: int, start: bool = True, device=None):
        """Build the async multi-tenant serving front end (futures +
        background drain + deadline/priority scheduling) this workload
        config describes."""
        from ..serve.service import AsyncSolverService

        return AsyncSolverService(
            self.to_sap_options(p),
            max_batch=self.max_batch,
            cache_size=self.fac_cache,
            rounding=self.bucket_rounding,
            queue_cap=self.queue_cap,
            default_deadline_s=self.deadline_s,
            thrash_window=self.thrash_window,
            thrash_ratio=self.thrash_ratio,
            hist_bounds=self.hist_bounds,
            cost_accounting=self.cost_accounting,
            start=start,
            device=device,
        )


@dataclasses.dataclass(frozen=True)
class SolverShape:
    name: str
    n: int
    k: int


SOLVER_SHAPES = {
    "dense_200k": SolverShape("dense_200k", 200_000, 200),
    "dense_1m": SolverShape("dense_1m", 1_048_576, 500),
    "dense_4m": SolverShape("dense_4m", 4_194_304, 200),
}


def full() -> SolverConfig:
    return SolverConfig(name="sap-solver", n=200_000, k=200)


def reduced() -> SolverConfig:
    return SolverConfig(name="sap-solver-reduced", n=512, k=8, maxiter=50)


def exact() -> SolverConfig:
    """The non-dominant regime (d < 1) where truncation breaks down and
    the exact reduced system -- solved in log-depth -- is required."""
    return SolverConfig(name="sap-solver-exact", n=200_000, k=200,
                        variant="E", d=0.5)


def service() -> SolverConfig:
    """The multi-tenant serving regime: concurrent clients with mixed
    priorities/deadlines through the async front end; variant is "auto"
    so the per-dominance-class overrides do the routing."""
    return SolverConfig(name="sap-solver-service", n=16_384, k=16,
                        variant="auto", tol=1e-6, max_batch=32,
                        fac_cache=256, queue_cap=512, deadline_s=30.0)


def fleet() -> SolverConfig:
    """The throughput regime: many moderate systems (implicit time
    integration), served batched with cached factorizations."""
    return SolverConfig(name="sap-solver-fleet", n=16_384, k=16,
                        tol=1e-6, max_batch=64, fac_cache=256)
