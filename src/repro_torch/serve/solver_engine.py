"""Batched linear-solver serving engine: bucketed fleets, cached factors.

The solver counterpart of :class:`repro_torch.serve.engine.ServeEngine`:
clients ``submit()`` independent banded systems (one matrix + one RHS
each) and the engine turns the pending queue into *batched* device work:

1. **Bucketing** -- each request's ``(N, K)`` rounds up to a shape bucket
   (:func:`repro_torch.core.batched.bucket_shape`); systems are
   identity-padded into the bucket so heterogeneous fleets share one
   stacked shape without approximation.

2. **Factorization cache** -- factorizations are cached in an LRU keyed
   by a *matrix fingerprint* (content hash of the band's host bytes + the
   bucket shape + the factor-relevant options).  Implicit time stepping
   re-solves against the same (or slowly refreshed) matrix every step:
   repeated fingerprints skip straight to the Krylov stage, paying
   factor-once economics across requests, not just across the RHS of one
   handle.

3. **Batched dispatch** -- every :meth:`SolverEngine.step` drains up to
   ``max_batch`` requests from ONE bucket, batch-factors the cache misses
   in a single pass (:func:`repro_torch.core.batched.batch_factor`: each
   kernel launched once for all of them), stacks cached + fresh
   factorizations, and runs one ``solve_batch``.

The engine is **thread-safe**: the pending queue, the LRU cache, and the
``stats`` dict each sit behind a lock, so an async drain thread
(:class:`repro_torch.serve.service.AsyncSolverService`) can run
:meth:`solve_prepared` while client threads keep ``submit()``-ing.  Device
solves run *outside* the locks -- host-side bookkeeping of incoming
requests overlaps in-flight device work.  Every outcome's ``x`` is a host
numpy array, so the device work of a step has finished when it returns.

Cache-hit and throughput counters live on :attr:`SolverEngine.stats`;
``cost_accounting=True`` adds roofline-predicted flops / bytes / seconds
per stage (:mod:`repro_torch.obs.cost`).  The JAX engine's compile
counters (``recompiles_total``, ``compile_seconds_total``) count XLA
compiles, which have no counterpart here.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import threading
import time
import warnings
from collections import OrderedDict, deque
from typing import Deque, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import batched
from ..core.batched import _host
from ..core.sap import SaPOptions, _tensor, resolve_variant
from ..device import resolve_device
from ..obs import cost as obs_cost
from ..obs.trace import span


def matrix_fingerprint(band) -> str:
    """Content hash of a band-storage matrix (shape + dtype + bytes).

    Host-side and cheap relative to a factorization; two requests carry
    the same fingerprint iff their band arrays are bit-identical, which
    is exactly the implicit-time-stepping reuse pattern (the Jacobian is
    refreshed every few steps, not every solve).  A tensor is hashed from
    its host bytes, so a band on the card and its numpy copy agree.
    """
    a = np.ascontiguousarray(_host(band))
    h = hashlib.blake2b(digest_size=16)
    h.update(str((a.shape, a.dtype.str)).encode())
    h.update(a.tobytes())
    return h.hexdigest()


def band_dominance(band) -> float:
    """Host-side degree of diagonal dominance (paper Eq. 2.11).

    The numpy twin of :func:`repro_torch.core.banded.diag_dominance_factor`:
    ``min_i |a_ii| / sum_{j!=i} |a_ij|`` with zero-off-diagonal rows
    dropping out of the minimum.  Runs on the submit path (no device
    round trip) to route requests to a dominance class before any
    factorization happens.
    """
    a = np.abs(np.asarray(_host(band), dtype=np.float64))
    k = (a.shape[1] - 1) // 2
    diag = a[:, k]
    off = a.sum(axis=1) - diag
    ratio = np.where(off > 0, diag / np.where(off > 0, off, 1.0), np.inf)
    return float(ratio.min()) if ratio.size else float("inf")


@dataclasses.dataclass
class SolveRequest:
    """One banded system A x = b submitted to the engine."""

    rid: int
    band: np.ndarray | torch.Tensor  # (N, 2K+1) band storage
    b: np.ndarray | torch.Tensor  # (N,) right-hand side
    fingerprint: Optional[str] = None  # filled by submit() if absent
    result: Optional["SolveOutcome"] = None

    @property
    def done(self) -> bool:
        """True once a SolveOutcome has been attached to this request."""
        return self.result is not None


@dataclasses.dataclass
class SolveOutcome:
    """Per-request result (device batch sliced back to the original N).

    ``resnorm`` is the *preconditioned* residual the Krylov iteration
    controlled; ``true_resnorm`` is ||b - A x|| / ||b|| against the
    request's own operator.  ``misconverged`` marks the silent-failure
    mode this engine guards against: the iteration reported
    ``converged`` but the true residual exceeds the guard threshold
    (``opts.check_true_residual``, default ``10 * tol``).  Requests that
    went through the escalation path carry ``escalated=True``; if even
    the escalated re-solve misconverges, ``converged`` is demoted to
    False rather than returning a silently-wrong answer.
    """

    x: np.ndarray
    iterations: float
    resnorm: float
    converged: bool
    cache_hit: bool
    bucket: Tuple[int, int, int]
    variant: str = ""  # SPIKE variant the batch actually solved with
    true_resnorm: float = float("nan")
    misconverged: bool = False
    escalated: bool = False
    # per-sweep Krylov residual track, NaN-padded (opts.record_history)
    history: Optional[np.ndarray] = None


def _opts_sig(opts: SaPOptions) -> tuple:
    """The option fields a cached factorization depends on.

    Part of the LRU key: two factorizations of the same matrix under
    different variants (or precond dtypes, partition counts...) have
    different structures and must never stack into one batch, so they
    live under distinct cache entries.
    """
    return (opts.p, opts.variant, opts.reduced_solver,
            opts.precond_dtype, opts.boost_eps,
            opts.fused_factor, opts.solver)


class SolverEngine:
    """Shape-bucketed, factorization-caching batched solve server.

    opts       : default solver options (p, variant, tol...); per-call
                 overrides ride :meth:`solve_prepared`
    max_batch  : per-step batch-size cap (one bucket per step)
    cache_size : LRU capacity in cached factorizations
    rounding   : bucket rounding policy ("pow2" | "exact")
    cost_accounting : also attribute roofline-predicted flops/bytes/
                 seconds to every step (:mod:`repro_torch.obs.cost`).  The
                 S=1 stage costs of a bucket are counted the first time it
                 is seen; per-batch accounting then scales them linearly by
                 batch size (and the Krylov cost by the sweeps the batch
                 actually ran), so the accumulated ``roofline_*`` totals
                 are a model, not a measurement.
    device     : where the factorizations live and the solves run
                 (default: the card)
    """

    def __init__(
        self,
        opts: Optional[SaPOptions] = None,
        max_batch: int = 32,
        cache_size: int = 128,
        rounding: str = "pow2",
        cost_accounting: bool = False,
        device=None,
    ):
        self.opts = opts or SaPOptions()
        self.max_batch = max_batch
        self.cache_size = cache_size
        self.rounding = rounding
        self.cost_accounting = cost_accounting
        self.device = resolve_device(device)
        # accumulated roofline predictions per stage (cost_accounting on)
        self._cost_totals: dict = {}
        self.queue: Deque[SolveRequest] = deque()
        self._next_rid = 0
        # (fingerprint, bucket, opts-sig) -> single-system factorization
        self._cache: OrderedDict = OrderedDict()
        # _lock guards cache + stats + opts (short critical sections);
        # _qlock guards the pending queue.  Device solves hold neither.
        self._lock = threading.RLock()
        self._qlock = threading.Lock()
        self.stats = {
            "submitted": 0,
            "solved": 0,
            "steps": 0,
            "cache_hits": 0,
            "cache_misses": 0,
            "factored_systems": 0,
            "evictions": 0,
            "misconverged": 0,
            "escalations": 0,
            # monotonic wall-clock split of solve_prepared: factor_seconds_total
            # is the device-synced batch-factoring of cache misses,
            # solve_seconds_total everything else (stacking, the batched
            # Krylov solve, unpadding); solve_seconds is their sum.
            "factor_seconds_total": 0.0,
            "solve_seconds_total": 0.0,
            "solve_seconds": 0.0,
            # high-water mark of the card's allocated bytes, sampled once
            # per step (0 on the CPU, where nothing lives on a card)
            "peak_device_bytes": 0,
        }

    # -- submission ---------------------------------------------------------

    def submit(self, req: SolveRequest) -> int:
        """Enqueue a prepared request; returns its rid.  Thread-safe."""
        if req.fingerprint is None:  # hash outside any lock (the slow part)
            req.fingerprint = matrix_fingerprint(req.band)
        with self._qlock:
            self.queue.append(req)
        self._bump("submitted")
        return req.rid

    def submit_system(self, band, b) -> int:
        """Convenience wrapper: wrap (band, b) in a request, return its rid."""
        with self._lock:
            rid = self._next_rid
            self._next_rid += 1
        self.submit(SolveRequest(rid=rid, band=band, b=b))
        return rid

    @property
    def pending(self) -> int:
        """Number of submitted requests not yet drained by a step()."""
        with self._qlock:
            return len(self.queue)

    # -- cache --------------------------------------------------------------

    def _cache_get(self, key):
        with self._lock:
            hit = self._cache.get(key)
            if hit is not None:
                self._cache.move_to_end(key)
            return hit

    def _cache_put(self, key, value):
        with self._lock:
            self._cache[key] = value
            self._cache.move_to_end(key)
            while len(self._cache) > self.cache_size:
                self._cache.popitem(last=False)
                self.stats["evictions"] += 1

    def _bump(self, key: str, n: float = 1) -> None:
        with self._lock:
            self.stats[key] += n

    @property
    def cached_factorizations(self) -> int:
        """Current number of factorizations held in the LRU cache."""
        with self._lock:
            return len(self._cache)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- the engine tick ----------------------------------------------------

    def step(self) -> List[SolveRequest]:
        """One tick: solve up to ``max_batch`` requests of one bucket.

        Picks the bucket with the most pending requests (largest batch =
        best amortization), factors its cache misses in one pass, then
        runs one batched solve.  Returns the completed requests.
        """
        with self._qlock:
            if not self.queue:
                return []
            shapes = [(r.band.shape[0], (r.band.shape[1] - 1) // 2) for r in self.queue]
            with self._lock:
                p, rounding = self.opts.p, self.rounding
            buckets = batched.bucket_by_shape(shapes, p, rounding)
            bucket, idxs = max(buckets.items(), key=lambda kv: len(kv[1]))
            idxs = set(idxs[: self.max_batch])
            batch = [r for i, r in enumerate(self.queue) if i in idxs]
            self.queue = deque(r for i, r in enumerate(self.queue) if i not in idxs)
        return self.solve_prepared(batch, bucket)

    def solve_prepared(
        self,
        batch: Sequence[SolveRequest],
        bucket: Tuple[int, int, int],
        opts: Optional[SaPOptions] = None,
        _escalated: bool = False,
    ) -> List[SolveRequest]:
        """Solve a pre-formed bucket of requests in one batched pass.

        The re-entrant core of :meth:`step`, also the entry point for the
        async service's drain thread: ``batch`` never touches the engine's
        own queue, so schedulers can form buckets however they like
        (priority, deadlines, dominance class) and hand them over with a
        per-bucket ``opts`` override.  An override must keep ``opts.p``
        consistent with the bucket's partition count.  Safe to call
        concurrently with ``submit``; concurrent calls serialize only on
        the short cache/stats critical sections, not the device solve.

        Every outcome carries the *true* residual ||b - A x|| / ||b||
        alongside the Krylov-controlled preconditioned ``resnorm``.
        Requests whose iteration claims convergence while the true
        residual exceeds the guard (``opts.check_true_residual``, default
        ``10 * tol``) are flagged misconverged and re-solved once through
        :meth:`_escalate` with a structurally exact bucket; ``_escalated``
        marks that inner pass (where a persistent misconvergence demotes
        ``converged`` instead of recursing again).
        """
        batch = list(batch)
        if not batch:
            return []
        nb, kb, _ = bucket
        with span(
            "engine.solve_prepared",
            bucket=f"{nb}x{kb}",
            batch=len(batch),
            escalated=_escalated,
        ) as sp:
            out = self._solve_prepared_impl(batch, bucket, opts, _escalated)
            if sp:
                sp.annotate(
                    variant=out[0].result.variant,
                    cache_hits=sum(1 for r in out if r.result.cache_hit),
                    cache_misses=sum(1 for r in out if not r.result.cache_hit),
                    escalations=sum(1 for r in out if r.result.escalated),
                    fingerprints=[r.fingerprint[:8] for r in out[:8]],
                )
                if self.cost_accounting:
                    try:
                        costs = self.stage_costs(bucket, variant=out[0].result.variant)
                        sp.annotate(cost={n: c.to_dict() for n, c in costs.items()})
                    except Exception:  # cost model must never fail a solve
                        pass
        return out

    def _solve_prepared_impl(
        self,
        batch: List[SolveRequest],
        bucket: Tuple[int, int, int],
        opts: Optional[SaPOptions],
        _escalated: bool,
    ) -> List[SolveRequest]:
        t0 = time.perf_counter()
        t_factor = 0.0
        nb, kb, _ = bucket
        for r in batch:
            if r.fingerprint is None:
                r.fingerprint = matrix_fingerprint(r.band)

        internal = opts is None
        with self._lock:
            eff = self.opts if internal else opts
        # "auto" resolves per batch from the worst (minimum) host-side
        # dominance estimate, *before* the cache lookup so the resolved
        # variant is part of the cache key.  The internal path stays
        # sticky: the first resolution pins self.opts so every later
        # step stacks structurally identical factorizations.
        if eff.variant == "auto":
            d_min = min(band_dominance(r.band) for r in batch)
            eff = dataclasses.replace(eff, variant=resolve_variant("auto", d_min))
            if internal:
                with self._lock:
                    if self.opts.variant == "auto":
                        self.opts = eff
                    eff = self.opts
        sig = _opts_sig(eff)

        # 1) factor the cache misses in ONE pass.  A batch may repeat a
        #    fingerprint (same Jacobian, many RHS requests): each distinct
        #    matrix is factored once, duplicates count as hits.
        #    ``step_facs`` pins this step's factorizations locally -- the
        #    LRU may evict mid-step (cache_size < distinct matrices in one
        #    batch) without pulling them out from under the solve.
        step_facs: dict = {}
        miss_fps: List[str] = []
        miss_reqs: List[SolveRequest] = []
        is_hit: List[bool] = []
        for r in batch:
            cached = self._cache_get((r.fingerprint, bucket, sig))
            if cached is not None:
                step_facs[r.fingerprint] = cached
                is_hit.append(True)
            elif r.fingerprint in miss_fps:
                is_hit.append(True)
            else:
                is_hit.append(False)
                miss_fps.append(r.fingerprint)
                miss_reqs.append(r)
        if miss_reqs:
            tf0 = time.perf_counter()
            bpl = _plan_for_bucket([r.band for r in miss_reqs], bucket, eff, self.device)
            bfac = batched.batch_factor(bpl)
            # sync here so the factor-vs-solve wall-clock split is honest
            # (launches are asynchronous; unsynced, factoring would bill to
            # the solve)
            self._sync()
            t_factor = time.perf_counter() - tf0
            for j, fp in enumerate(miss_fps):
                fac = batched.index_factorization(bfac, j)
                step_facs[fp] = fac
                self._cache_put((fp, bucket, sig), fac)
            self._bump("factored_systems", len(miss_reqs))
        self._bump("cache_hits", sum(is_hit))
        self._bump("cache_misses", len(is_hit) - sum(is_hit))

        # 2) one batched solve over cached + fresh factorizations
        facs = [step_facs[r.fingerprint] for r in batch]
        orig_ns = [r.band.shape[0] for r in batch]
        bfac = batched.stack_factorizations(facs, orig_ns)
        rhs = [_tensor(r.b) for r in batch]
        dt = functools.reduce(torch.promote_types, (b.dtype for b in rhs))
        bmat = torch.stack([batched.pad_rhs_to(b.to(dt), nb) for b in rhs]).to(self.device)
        res = bfac.solve_batch(bmat, record_history=eff.record_history)
        xs = batched.unpad_solution(res.x, orig_ns)  # host copies: the solve has ended
        iters = res.iterations.cpu().numpy()
        rnorm = res.resnorm.cpu().numpy()
        conv = res.converged.cpu().numpy()
        tres = res.true_resnorm.cpu().numpy()
        hists = res.history.cpu().numpy() if res.history is not None else None
        guard = eff.check_true_residual if eff.check_true_residual is not None else 10.0 * eff.tol
        for i, r in enumerate(batch):
            t = float(tres[i])
            c = bool(conv[i])
            r.result = SolveOutcome(
                x=xs[i],
                iterations=float(iters[i]),
                resnorm=float(rnorm[i]),
                converged=c,
                cache_hit=is_hit[i],
                bucket=bucket,
                variant=eff.variant,
                true_resnorm=t,
                misconverged=bool(c and t > guard),
                history=hists[i] if hists is not None else None,
            )
        dt_s = time.perf_counter() - t0
        mem = obs_cost.device_memory_bytes(self.device)
        with self._lock:
            self.stats["solved"] += len(batch)
            self.stats["steps"] += 1
            self.stats["factor_seconds_total"] += t_factor
            self.stats["solve_seconds_total"] += dt_s - t_factor
            self.stats["solve_seconds"] += dt_s
            if mem > self.stats["peak_device_bytes"]:
                self.stats["peak_device_bytes"] = mem

        if self.cost_accounting:
            self._account_cost(bucket, eff, len(batch), len(miss_reqs), iters, dt)

        mis = [r for r in batch if r.result.misconverged]
        if mis:
            self._bump("misconverged", len(mis))
            if _escalated:
                # the exact-bucket pass ALSO misconverged: never report a
                # silently-wrong answer as success
                for r in mis:
                    r.result.converged = False
            else:
                self._escalate(mis, eff)
        return batch

    def _escalate(self, reqs: List[SolveRequest], eff: SaPOptions) -> None:
        """Re-solve misconverged requests under structurally exact buckets.

        Misconvergence is, in practice, a padding artifact: a band stored
        (or bucketed) wider than its true bandwidth makes the K-block
        pivots ill-conditioned and the preconditioned residual lies.  The
        escalation trims each band to its effective bandwidth, re-buckets
        under ``"exact"`` rounding (no pow2 widening), and runs one more
        :meth:`solve_prepared` pass per escalation bucket.  The escalated
        outcome replaces the misconverged one; if it *still* misconverges
        the inner pass demotes ``converged`` to False.
        """
        self._bump("escalations", len(reqs))
        groups: dict = {}
        for r in reqs:
            trimmed = batched.trim_band_to_effective(r.band)
            ke = (trimmed.shape[1] - 1) // 2
            bkt = batched.bucket_shape(trimmed.shape[0], max(ke, 1), eff.p, "exact")
            groups.setdefault(bkt, []).append((r, trimmed))
        for bkt, members in groups.items():
            sub = [SolveRequest(rid=r.rid, band=trimmed, b=r.b) for r, trimmed in members]
            self.solve_prepared(sub, bkt, opts=eff, _escalated=True)
            for (r, _), s in zip(members, sub):
                out = s.result
                out.escalated = True
                r.result = out

    def run_until_drained(
        self, max_steps: int = 10_000, on_leftover: str = "warn"
    ) -> List[SolveRequest]:
        """Step until the queue is empty (or ``max_steps`` ticks elapse).

        Hitting the step budget with work still queued is never silent:
        ``on_leftover="warn"`` (default) emits a RuntimeWarning carrying
        the remaining queue depth, ``"raise"`` turns it into a
        RuntimeError -- unfinished requests would otherwise just look
        like missing results.
        """
        done: List[SolveRequest] = []
        steps = 0
        while self.pending and steps < max_steps:
            done.extend(self.step())
            steps += 1
        leftover = self.pending
        if leftover:
            msg = (
                f"run_until_drained stopped after max_steps={max_steps} "
                f"with {leftover} request(s) still queued"
            )
            if on_leftover == "raise":
                raise RuntimeError(msg)
            warnings.warn(msg, RuntimeWarning, stacklevel=2)
        return done

    # -- cost accounting ----------------------------------------------------

    def stage_costs(
        self,
        bucket: Tuple[int, int, int],
        s: int = 1,
        variant: Optional[str] = None,
        opts: Optional[SaPOptions] = None,
        dtype=None,
    ) -> dict:
        """Per-stage roofline costs for one bucket (cached after first use).

        Thin wrapper over :func:`repro_torch.obs.cost.solver_stage_costs`
        that defaults to the engine's own options, resolved variant and
        device; the returned dict maps stage name ->
        :class:`repro_torch.obs.cost.StageCost`.
        """
        with self._lock:
            eff = opts or self.opts
        if variant is None:
            variant = eff.variant if eff.variant != "auto" else "C"
        return obs_cost.solver_stage_costs(
            bucket, s=s, opts=eff, variant=variant, dtype=dtype, device=self.device
        )

    def _account_cost(self, bucket, eff, batch_len, n_factored, iters, dtype) -> None:
        """Fold one step's roofline predictions into the running totals.

        The S=1 stage costs scale linearly by batch size; the Krylov cost
        is per-sweep x the sweeps the (lockstep) batch actually ran --
        i.e. the max iteration count in the batch.
        """
        try:
            costs = self.stage_costs(bucket, variant=eff.variant, opts=eff, dtype=dtype)
        except Exception:  # cost model must never fail a solve
            return
        sweeps = float(np.max(iters)) if np.size(iters) else 0.0
        preds = {
            "factor": costs["factor"].scale(float(n_factored)),
            "krylov": costs["krylov"].per_iteration().scale(sweeps * batch_len),
        }
        with self._lock:
            for name, c in preds.items():
                ent = self._cost_totals.setdefault(
                    name, {"flops": 0.0, "hbm_bytes": 0.0, "roofline_s": 0.0}
                )
                ent["flops"] += c.flops
                ent["hbm_bytes"] += c.hbm_bytes
                ent["roofline_s"] += c.roofline_s

    def cost_snapshot(self) -> dict:
        """Accumulated per-stage roofline predictions (cost_accounting)."""
        with self._lock:
            return {k: dict(v) for k, v in self._cost_totals.items()}

    # -- derived stats ------------------------------------------------------

    def stats_snapshot(self) -> dict:
        """Consistent copy of the stats dict (for scraping threads)."""
        with self._lock:
            return dict(self.stats)

    @property
    def cache_hit_rate(self) -> float:
        """Fraction of drained requests served from the factorization cache."""
        with self._lock:
            tot = self.stats["cache_hits"] + self.stats["cache_misses"]
            return self.stats["cache_hits"] / tot if tot else 0.0

    @property
    def systems_per_second(self) -> float:
        """Throughput from the engine's own monotonic accumulators
        (``factor_seconds_total + solve_seconds_total``) -- no external
        wall clock needed, and the split lets callers separate cold
        (factor-heavy) from warm (cache-hit) throughput."""
        with self._lock:
            sec = self.stats["factor_seconds_total"] + self.stats["solve_seconds_total"]
            return self.stats["solved"] / sec if sec > 0 else 0.0


def _plan_for_bucket(
    bands: Sequence, bucket: Tuple[int, int, int], opts: SaPOptions, device: torch.device
) -> batched.BatchedSaPPlan:
    """Stack bands padded to an *explicit* bucket (no re-derivation).

    Unlike :func:`repro_torch.core.batched.batch_plan`, which infers one
    bucket from the fleet + a rounding policy, the serving path already
    committed to a bucket at scheduling time -- possibly under a different
    rounding than the engine default (the thrash guard widens it at
    runtime) -- so the bucket itself is authoritative here.  Host bands
    are padded on the host and the stack crosses to ``device`` once.
    """
    nb, kb, _ = bucket
    stacked = torch.stack([batched.pad_band_to(bd, nb, kb) for bd in bands])
    orig_ns = tuple(int(bd.shape[0]) for bd in bands)
    # per-band stored bandwidths: pad_band_to embeds a K-widened band via
    # the interleaved identity-row permutation, and batch_factor needs the
    # original k of each member to reconstruct those permutations
    orig_ks = tuple(int((bd.shape[1] - 1) // 2) for bd in bands)
    return batched.BatchedSaPPlan(
        bands=stacked.to(device), k=kb, n=nb, orig_ns=orig_ns,
        orig_ks=orig_ks, opts=opts,
    )
