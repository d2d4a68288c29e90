"""Multi-rank SaP: the partition-per-rank solver over ``torch.distributed``.

The paper's P-way work splitting maps onto ranks: every rank owns
``p_per_device`` partitions, one process a mesh position (SPMD by process,
where the JAX package runs one ``shard_map``).  Factorization and the two
block solves of the preconditioner are local to a rank, and communication
in the preconditioner is nearest-neighbour or log-depth:

  variant C (truncated, Sec. 2.1):
    setup:  one permutation of the left-spike top blocks  W^(t)   (K x K each)
    apply:  one permutation of g^(t) (down) + one of xt^(b) (up)  (K x R each)
  variant E (exact reduced system, Sec. 2.1.1):
    setup:  one permutation aligning two spike corners + ~log2(P)
            strided shift rounds reducing the (P-1)-interface chain by
            parallel cyclic reduction
            (:func:`repro_torch.core.cyclic_reduction.pcr_factor`)
    apply:  ~log2(P) shift rounds of (2K x R) blocks -- the chain is
            *never* gathered onto one rank.

The banded matvec of the outer Krylov iteration needs a K-row halo (two
permutations), and every dot product and norm of BiCGStab(2) is summed
over the ranks (:mod:`repro_torch.core.krylov`'s ``allreduce``).

Each rank's factor and apply run on the port's kernels
(:mod:`repro_torch.kernels.ops`): btf / bts for D, and for C and E one
fused factor + spike-corner pass over the rank's partitions (the JAX code
takes the same blocks from btf, a UL btf and two whole-spike bts); PCR's
block inverses go through the ``inv_odd`` kernel.

Transport.  A permutation posts every send and receive of this rank
together (``batch_isend_irecv``), so no ordering can deadlock, and a rank
that receives nothing gets zeros, as ``jax.lax.ppermute`` gives.  The
group's backend decides how a CUDA tensor travels: on NCCL the device
buffer is sent as it is; on gloo, which sends and receives host tensors,
through a host copy.  Nothing falls back on an error.
:func:`comm_stats` counts the permutations, all-reduces, their bytes and
the host time spent in them.

Partitions are flattened over all mesh axes (row-major), so the same code
runs on any mesh shape.  ``variant="auto"`` applies the same C-vs-E policy
as ``sap.factor()``: the degree of diagonal dominance (Eq. 2.11) is
estimated from each rank's own band rows and reduced over the ranks.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..kernels import ops as kops
from ..kernels.fused_spike import fused_factor_spike as _fused_padded
from .banded import block_row_windows, diag_dominance_factor
from .block_lu import DEFAULT_BOOST, BTFactors
from .cyclic_reduction import pcr_factor, pcr_n_levels, pcr_solve
from .krylov import _bicgstab2_block
from .sap import SaPSolveResult, resolve_variant
from .spike import _block_inverse


def mesh_axes(mesh) -> tuple[str, ...]:
    """The mesh's axis names (a :class:`~repro_torch.launch.mesh.Mesh`)."""
    return tuple(mesh.axis_names)


def n_devices(mesh) -> int:
    """The number of mesh positions: one rank each."""
    return int(mesh.size)


# ---------------------------------------------------------------------------
# Transport: permutations and all-reduces over the mesh's group
# ---------------------------------------------------------------------------

_STATS = dict(permutations=0, messages=0, bytes=0, allreduces=0, allreduce_bytes=0,
              seconds=0.0, by_axis={})


def reset_comm_stats() -> None:
    """Zero the counters of :func:`comm_stats`."""
    for name in _STATS:
        _STATS[name] = 0.0 if name == "seconds" else {} if name == "by_axis" else 0


def comm_stats() -> dict:
    """This process's traffic since the last reset: ``permutations`` (those
    with at least one pair), ``messages`` and ``bytes`` this rank sent,
    ``allreduces`` and their ``allreduce_bytes``, and ``seconds`` of host
    time inside them.  On gloo a CUDA tensor's host copy waits for the card
    first; that wait is not counted.  ``by_axis`` counts the collectives
    over one mesh axis (:func:`all_reduce_axis`) as ``{"kind/axis":
    {"messages", "bytes"}}``, kind ``all_reduce`` or ``all_gather`` (a
    gather sent as a zero-padded all-reduce), bytes those of the buffer."""
    out = dict(_STATS)
    out["by_axis"] = {k: dict(v) for k, v in _STATS["by_axis"].items()}
    return out


def _host(x: torch.Tensor, mesh) -> bool:
    """Whether ``x`` travels through a host copy: a CUDA tensor on gloo."""
    return mesh.backend == "gloo" and x.device.type != "cpu"


def _peer(mesh, rank: int) -> int:
    """The global rank of the group's rank ``rank`` (P2P ops take global)."""
    return rank if mesh.group is dist.group.WORLD else dist.get_global_rank(mesh.group, rank)


def ppermute(x: torch.Tensor, perm, mesh) -> torch.Tensor:
    """``jax.lax.ppermute`` over the mesh's group: rank ``dst`` receives
    ``x`` of rank ``src`` for every ``(src, dst)`` of ``perm``; a rank that
    receives nothing gets zeros.  Every send and receive of this rank is
    posted together."""
    me = mesh.rank
    dsts = [d for s, d in perm if s == me]
    srcs = [s for s, d in perm if d == me]
    if len(srcs) > 1:
        raise ValueError(f"ppermute: rank {me} would receive from {srcs}")
    if not perm:
        return torch.zeros_like(x)
    host = _host(x, mesh)
    if host:
        torch.cuda.synchronize(x.device)
    t0 = time.perf_counter()
    send = x.contiguous()
    if host:
        send = send.cpu()
    out = torch.zeros_like(send)
    ops = [dist.P2POp(dist.isend, send, _peer(mesh, d), mesh.group) for d in dsts]
    ops += [dist.P2POp(dist.irecv, out, _peer(mesh, s), mesh.group) for s in srcs]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    if host:
        out = out.to(x.device)
    _STATS["permutations"] += 1
    _STATS["messages"] += len(dsts)
    _STATS["bytes"] += len(dsts) * send.numel() * send.element_size()
    _STATS["seconds"] += time.perf_counter() - t0
    return out


_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX}


def all_reduce(x: torch.Tensor, mesh, op: str = "sum") -> torch.Tensor:
    """``x`` reduced over the mesh's group (a new tensor; ``x`` is kept)."""
    host = _host(x, mesh)
    if host:
        torch.cuda.synchronize(x.device)
    t0 = time.perf_counter()
    buf = x.cpu() if host else x.clone()
    dist.all_reduce(buf, op=_OPS[op], group=mesh.group)
    _STATS["allreduces"] += 1
    _STATS["allreduce_bytes"] += buf.numel() * buf.element_size()
    _STATS["seconds"] += time.perf_counter() - t0
    return buf.to(x.device) if host else buf


def all_reduce_axis(x: torch.Tensor, mesh, axis: str, op: str = "sum",
                    kind: str = "all_reduce") -> torch.Tensor:
    """``x`` reduced over the ranks that differ from this one only along
    ``axis`` (``mesh.axis_group(axis)``), as a new tensor; counted in
    ``comm_stats()["by_axis"]`` under ``kind/axis``.  On gloo a CUDA
    tensor travels through a host copy."""
    if mesh.shape[axis] == 1:
        return x.clone()
    host = _host(x, mesh)
    if host:
        torch.cuda.synchronize(x.device)
    t0 = time.perf_counter()
    buf = x.cpu() if host else x.clone()
    dist.all_reduce(buf, op=_OPS[op], group=mesh.axis_group(axis))
    nbytes = buf.numel() * buf.element_size()
    _STATS["allreduces"] += 1
    _STATS["allreduce_bytes"] += nbytes
    rec = _STATS["by_axis"].setdefault(f"{kind}/{axis}", {"messages": 0, "bytes": 0})
    rec["messages"] += 1
    rec["bytes"] += nbytes
    _STATS["seconds"] += time.perf_counter() - t0
    return buf.to(x.device) if host else buf


def all_gather(x: torch.Tensor, mesh) -> list[torch.Tensor]:
    """Every rank's ``x`` (same shape on all ranks), in rank order."""
    host = _host(x, mesh)
    send = x.contiguous().cpu() if host else x.contiguous()
    outs = [torch.empty_like(send) for _ in range(mesh.size)]
    dist.all_gather(outs, send, group=mesh.group)
    return [o.to(x.device) for o in outs] if host else outs


# ---------------------------------------------------------------------------
# Neighbour shifts over the flattened ranks (non-cyclic: edges get zeros)
# ---------------------------------------------------------------------------


def _shift_from_next(x, mesh):
    """Each rank receives the value owned by rank idx+1; the last gets 0."""
    return ppermute(x, [(i + 1, i) for i in range(mesh.size - 1)], mesh)


def _shift_from_prev(x, mesh):
    """Each rank receives the value owned by rank idx-1; the first gets 0."""
    return ppermute(x, [(i, i + 1) for i in range(mesh.size - 1)], mesh)


def _from_prev_by(x, dq, mesh):
    """Receive the block owned by the rank ``dq`` positions before."""
    if dq == 0:
        return x
    return ppermute(x, [(i, i + dq) for i in range(mesh.size - dq)], mesh)


def _from_next_by(x, dq, mesh):
    if dq == 0:
        return x
    return ppermute(x, [(i, i - dq) for i in range(dq, mesh.size)], mesh)


def _shift_dn_rows(x, s, mesh):
    """Row j of the global (flattened, p_loc rows a rank) tensor receives
    row j - s; rows shifted in past the start are zero.  One stride-s PCR
    exchange: at most two permutations whatever s, each sending only the
    rows the receiver keeps."""
    p_loc = x.shape[0]
    q, r = divmod(s, p_loc)
    if r == 0:
        return _from_prev_by(x, q, mesh)
    a = _from_prev_by(x[: p_loc - r], q, mesh)  # rows r.. from q ranks before
    b = _from_prev_by(x[p_loc - r:], q + 1, mesh)  # rows ..r-1 from q+1 before
    return torch.cat([b, a], dim=0)


def _shift_up_rows(x, s, mesh):
    """Row j receives row j + s (zeros past the end)."""
    p_loc = x.shape[0]
    q, r = divmod(s, p_loc)
    if r == 0:
        return _from_next_by(x, q, mesh)
    a = _from_next_by(x[r:], q, mesh)
    b = _from_next_by(x[:r], q + 1, mesh)
    return torch.cat([a, b], dim=0)


def _next_aligned(x, mesh):
    """Partition i+1's block at interface i: x[1:] and the next rank's x[0]."""
    return torch.cat([x[1:], _shift_from_next(x[:1], mesh)], dim=0)


def _prev_aligned(x, mesh):
    """Partition i-1's block at partition i: the previous rank's x[-1]
    and x[:-1]."""
    return torch.cat([_shift_from_prev(x[-1:], mesh), x[:-1]], dim=0)


# ---------------------------------------------------------------------------
# The preconditioner on one rank
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DistSaP:
    """A distributed solver on this rank: sizes, the resolved variant and
    the rank-local closures (``factor``, ``precond``, ``matvec``,
    ``shard_band``)."""

    mesh: object
    k: int
    m: int
    p_local: int
    n_pad: int
    variant: str  # resolved: "C" | "D" | "E"
    variant_requested: str
    matvec: Callable
    precond: Callable
    factor: Callable
    shard_band: Callable
    d_factor: Optional[float] = None  # Eq. 2.11 estimate ("auto" only)


def _fused(d, e, f, b_next, c_prev, boost_eps):
    """LU factors and the four spike corners of the rank's partitions in
    one fused pass: partition i's couplings are b_next[i] and c_prev[i]
    (the last one's B crosses to the next rank), which is the kernel's
    per-partition layout as it stands."""
    sinv, l, vb, vt, wt, wb = _fused_padded(d, e, f, b_next, c_prev, boost_eps)
    return BTFactors(sinv=sinv, l=l, f=f), vb, vt, wt, wb


def _local_factor_c(d, e, f, b_next, c_prev, boost_eps, mesh):
    """d/e/f: (p_loc, M, K, K); couplings per partition."""
    lu, v_bot, _, w_top, _ = _fused(d, e, f, b_next, c_prev, boost_eps)
    w_next = _next_aligned(w_top, mesh)  # W^(t) of partition i+1 at interface i
    eye = torch.eye(d.shape[-1], dtype=d.dtype, device=d.device)
    rbar_inv = _block_inverse(eye - w_next @ v_bot, boost_eps)
    return lu, v_bot, w_next, rbar_inv


def _correct(lu, b_next, c_prev, rb, xt_bot, xt_top, mesh):
    """Final solves (eq. 2.10): partition j subtracts B_j xt_top[j] from
    its bottom block and C_j xt_bot[j-1] (from the rank before, for its
    first partition) from its top block."""
    rb2 = rb.clone()
    rb2[:, -1] -= b_next @ xt_top
    rb2[:, 0] -= c_prev @ _prev_aligned(xt_bot, mesh)
    return kops.block_tridiag_solve(lu, rb2)


def _local_apply_c(state, b_next, c_prev, rb, mesh):
    """Truncated-coupling apply on the rank.  rb: (p_loc, M, K, R)."""
    lu, v_bot, w_next, rbar_inv = state
    g = kops.block_tridiag_solve(lu, rb)
    g_top_next = _next_aligned(g[:, 0], mesh)
    g_bot = g[:, -1]
    xt_top = rbar_inv @ (g_top_next - w_next @ g_bot)  # x~ for top of partition i+1
    xt_bot = g_bot - v_bot @ xt_top  # x~ for bottom of partition i
    return _correct(lu, b_next, c_prev, rb, xt_bot, xt_top, mesh)


def _local_factor_e(d, e, f, b_next, c_prev, boost_eps, mesh, p_total):
    """Exact coupling across ranks: assemble this rank's (2K x 2K)
    interface blocks from the whole-spike corners, then reduce the global
    chain by parallel cyclic reduction -- log2(P) strided shift rounds, no
    gather."""
    lu, v_bot, v_top, w_top, w_bot = _fused(d, e, f, b_next, c_prev, boost_eps)
    p_loc, _, k, _ = d.shape
    # interface i lives with partition i and couples y_i = [x_i^b;
    # x_{i+1}^t]: it needs W_{i+1}^t and V_{i+1}^t from partition i+1
    w_top_next, v_top_next = _next_aligned(torch.stack([w_top, v_top], dim=1), mesh).unbind(1)
    rd = d.new_zeros((p_loc, 2 * k, 2 * k))
    re, rf = torch.zeros_like(rd), torch.zeros_like(rd)
    eye = torch.eye(k, dtype=d.dtype, device=d.device)
    rd[:, :k, :k] = eye
    rd[:, :k, k:] = v_bot
    rd[:, k:, :k] = w_top_next
    rd[:, k:, k:] = eye
    re[:, :k, :k] = w_bot  # to y_{i-1} via W_i^(b)
    rf[:, k:, k:] = v_top_next  # to y_{i+1} via V_{i+1}^(t)
    # The flattened chain has one slot a partition; the last partition's
    # slot is not a real interface: pad it to a decoupled identity block.
    gidx = mesh.rank * p_loc + torch.arange(p_loc, device=d.device)
    pad = gidx >= p_total - 1
    rd[pad] = torch.eye(2 * k, dtype=d.dtype, device=d.device)
    re[pad] = 0.0
    rf[pad] = 0.0
    pcr = pcr_factor(
        rd, re, rf, pcr_n_levels(p_total - 1),
        shift_dn=lambda x, s: _shift_dn_rows(x, s, mesh),
        shift_up=lambda x, s: _shift_up_rows(x, s, mesh),
        boost_eps=boost_eps,
    )
    return lu, pcr


def _local_apply_e(state, b_next, c_prev, rb, mesh):
    """Exact-coupling apply: block solve + log-depth reduced sweep +
    corrected block solve (the counterpart of ``spike._apply_exact``)."""
    lu, pcr = state
    k = rb.shape[2]
    g = kops.block_tridiag_solve(lu, rb)
    h = torch.cat([g[:, -1], _next_aligned(g[:, 0], mesh)], dim=1)  # (p_loc, 2K, R)
    y = pcr_solve(
        pcr, h,
        shift_dn=lambda x, s: _shift_dn_rows(x, s, mesh),
        shift_up=lambda x, s: _shift_up_rows(x, s, mesh),
    )
    return _correct(lu, b_next, c_prev, rb, y[:, :k], y[:, k:], mesh)


def _local_matvec(band_loc, x_loc, k, mesh):
    """Banded matvec with a K-row halo from each neighbour.

    band_loc: (N_loc, 2K+1); x_loc: (N_loc, R).  Computes in the promoted
    dtype of the two, as :func:`repro_torch.core.banded.band_matvec`."""
    dt = torch.promote_types(band_loc.dtype, x_loc.dtype)
    x = x_loc.to(dt)
    lo = _shift_from_prev(x[-k:], mesh)  # the previous rank's last K rows
    hi = _shift_from_next(x[:k], mesh)  # the next rank's first K rows
    win = torch.cat([lo, x, hi], dim=0).unfold(0, 2 * k + 1, 1)  # (N_loc, R, 2K+1)
    return torch.einsum("nw,nrw->nr", band_loc.to(dt), win)


# ---------------------------------------------------------------------------
# Dominance estimate across ranks (drives variant="auto")
# ---------------------------------------------------------------------------


def dist_diag_dominance_factor(mesh, band_rows: torch.Tensor) -> torch.Tensor:
    """Degree of diagonal dominance (Eq. 2.11) over every rank's rows.

    Each rank reduces its own rows (``band_rows``, (N_loc, 2K+1)) with
    :func:`diag_dominance_factor` (identity padding rows drop out as
    infinitely dominant) and one all-reduce takes the minimum: no row
    leaves its rank.
    """
    return all_reduce(diag_dominance_factor(band_rows).reshape(1), mesh, "min")[0]


# ---------------------------------------------------------------------------
# Builder
# ---------------------------------------------------------------------------


def _rows(a, lo: int, hi: int, n: int, fill_diag: Optional[int], device) -> torch.Tensor:
    """Rows [lo, hi) of ``a`` (N leading rows), rows past N as padding:
    identity band rows (1 in column ``fill_diag``) or zeros.  Only those
    rows are read, so a memory-mapped array stays on disk elsewhere."""
    part = a[lo:min(hi, n)]
    t = part if isinstance(part, torch.Tensor) else torch.from_numpy(np.array(part))
    t = t.to(device)
    extra = hi - max(lo, n)
    if extra > 0:
        pad = t.new_zeros((extra,) + tuple(t.shape[1:]))
        if fill_diag is not None:
            pad[:, fill_diag] = 1.0
        t = torch.cat([t, pad], dim=0)
    return t


def build_dist_sap(
    mesh,
    n: int,
    k: int,
    variant: str = "C",
    p_per_device: int = 1,
    boost_eps: float = DEFAULT_BOOST,
    precond_dtype: torch.dtype = torch.float32,
    band=None,
) -> DistSaP:
    """This rank's part of a distributed SaP solver on ``mesh``.

    ``variant`` is one of "C" (truncated coupling), "D" (decoupled), "E"
    (exact reduced interface chain by cyclic reduction across ranks) or
    "auto" -- the policy of ``sap.factor()``: C when the band is
    diagonally dominant (d >= 1, Eq. 2.11), E below.  "auto" needs the
    band rows to estimate d, so pass ``band`` ((N, 2K+1) storage, a tensor
    or an array); each rank reads only its own rows of it.  Tensors go to
    ``mesh.device``.
    """
    if variant not in ("C", "D", "E", "auto"):
        raise ValueError(f"unknown distributed SaP variant {variant!r}")
    ndev = mesh.size
    p_total = ndev * p_per_device
    ni = -(-n // p_total)  # ceil rows per partition
    m = max(2, -(-ni // k))  # blocks per partition (>= 2 so top != bottom)
    n_pad = p_total * m * k
    n_loc = p_per_device * m * k
    lo, hi = mesh.rank * n_loc, (mesh.rank + 1) * n_loc

    variant_requested = variant
    d_factor = None
    if variant == "auto":
        if band is None:
            raise ValueError(
                'variant="auto" needs the band rows to estimate diagonal '
                "dominance; pass band=(N, 2K+1) storage to build_dist_sap"
            )
        rows = _rows(band, lo, hi, n, k, mesh.device)
        d_factor = float(dist_diag_dominance_factor(mesh, rows))
        variant = resolve_variant("auto", d_factor)

    def shard_band(band, b):
        """This rank's rows of the padded band and of b, and its
        p_per_device partitions as block-tridiagonal blocks with their
        couplings: d, e, f (p_loc, M, K, K), b_next (B of each partition,
        zero for the global last) and c_prev (C of each, zero for the
        global first), in ``precond_dtype``."""
        band_loc = _rows(band, lo, hi, n, k, mesh.device)
        b_loc = _rows(b, lo, hi, n, None, mesh.device)
        win = block_row_windows(band_loc, k).reshape(p_per_device, m, k, 3 * k)
        e = win[..., :k].contiguous()
        d = win[..., k: 2 * k].contiguous()
        f = win[..., 2 * k:].contiguous()
        # the corner blocks reach into the neighbouring partitions: B_i
        # (bottom rows of i, top columns of i+1) and C_i (top rows of i,
        # bottom columns of i-1), across ranks for the rank's end partitions
        b_next = f[:, m - 1].clone()
        c_prev = e[:, 0].clone()
        if mesh.rank == ndev - 1:
            b_next[-1] = 0.0
        if mesh.rank == 0:
            c_prev[0] = 0.0
        e[:, 0] = 0.0
        f[:, m - 1] = 0.0
        parts = {nm: t.to(precond_dtype).contiguous()
                 for nm, t in dict(d=d, e=e, f=f, b_next=b_next, c_prev=c_prev).items()}
        return band_loc, b_loc, parts

    # Every variant's factor returns an opaque per-rank state and apply
    # consumes it, so the plumbing is variant-independent.
    if variant == "C":
        def factor(d, e, f, b_next, c_prev):
            return _local_factor_c(d, e, f, b_next, c_prev, boost_eps, mesh)

        def precond(state, b_next, c_prev, rb):
            return _local_apply_c(state, b_next, c_prev, rb, mesh)
    elif variant == "E":
        def factor(d, e, f, b_next, c_prev):
            return _local_factor_e(d, e, f, b_next, c_prev, boost_eps, mesh, p_total)

        def precond(state, b_next, c_prev, rb):
            return _local_apply_e(state, b_next, c_prev, rb, mesh)
    else:
        def factor(d, e, f, b_next, c_prev):
            return (kops.block_tridiag_factor(d, e, f, boost_eps),)

        def precond(state, b_next, c_prev, rb):
            return kops.block_tridiag_solve(state[0], rb)

    return DistSaP(
        mesh=mesh,
        k=k,
        m=m,
        p_local=p_per_device,
        n_pad=n_pad,
        variant=variant,
        variant_requested=variant_requested,
        matvec=lambda band_loc, x: _local_matvec(band_loc, x, k, mesh),
        precond=precond,
        factor=factor,
        shard_band=shard_band,
        d_factor=d_factor,
    )


def solve_factored(dsap: DistSaP, state, band, b, b_next, c_prev, tol: float = 1e-8,
                   maxiter: int = 200) -> SaPSolveResult:
    """BiCGStab(2) on this rank's rows with a factored preconditioner
    (``state`` from ``dsap.factor``): the iteration runs in the dtype of
    ``b``, the preconditioner in that of the factors, and every dot and
    norm is summed over the ranks, so the scalars of the result are
    global; ``x`` is this rank's rows."""
    mesh = dsap.mesh
    k, m, p_loc = dsap.k, dsap.m, dsap.p_local
    pdt = b_next.dtype

    def precond(r):
        rb = r.reshape(p_loc, m, k, -1).to(pdt).contiguous()
        return dsap.precond(state, b_next, c_prev, rb).reshape(r.shape).to(r.dtype)

    res = _bicgstab2_block(
        lambda x: dsap.matvec(band, x), b[:, None], precond, None, tol, maxiter, False,
        allreduce=lambda t: all_reduce(t, mesh),
    )
    return SaPSolveResult(
        x=res.x[:, 0],
        iterations=res.iterations[0],
        resnorm=res.resnorm[0],
        converged=res.converged[0],
        true_resnorm=res.true_resnorm[0],
        d_factor=None if dsap.d_factor is None else torch.tensor(dsap.d_factor),
    )


def solve_step_fn(dsap: DistSaP, tol: float = 1e-8, maxiter: int = 200):
    """The whole solve on this rank: ``step(band, b, d, e, f, b_next,
    c_prev)`` with this rank's rows and partitions (``dsap.shard_band``)
    factors the preconditioner and runs BiCGStab(2).  Returns a
    :class:`~repro_torch.core.sap.SaPSolveResult` with this rank's ``x``
    and global diagnostics (iterations / resnorm / converged /
    true_resnorm, and the d-estimate when "auto" chose the variant)."""

    def step(band, b, d, e, f, b_next, c_prev):
        state = dsap.factor(d, e, f, b_next, c_prev)
        return solve_factored(dsap, state, band, b, b_next, c_prev, tol, maxiter)

    return step


def gather_x(x_loc: torch.Tensor, mesh, n: int) -> torch.Tensor:
    """The whole solution on every rank: the ranks' rows in order, the
    padding rows cut (``n`` is the system's size)."""
    return torch.cat(all_gather(x_loc, mesh), dim=0)[:n]
