"""Matrix reordering algorithms (paper Sec. 2.2.1, 3.2, 3.3).

* ``diagonal_boosting`` (DB): row permutation maximizing the product of
  absolute diagonal values, reduced to min-weight bipartite perfect
  matching with weights c_ij = log(max_j |a_ij|) - log|a_ij| (Eq. 2.12).
  Implemented as the four stages of the paper:
    DB-S1 form weighted bipartite graph
    DB-S2 initial partial match from potentials (length-1 augmenting paths)
    DB-S3 perfect match via Dijkstra shortest augmenting paths
    DB-S4 extract permutation (+ optional I-matrix scaling factors)

* ``cuthill_mckee`` (CM): bandwidth-reducing BFS ordering with the paper's
  heuristics (Sec. 3.3): multiple starting nodes, neighbor pre-sorting by
  ascending degree, termination when tree height stops growing / max level
  width stops shrinking, <= 3 CM iterations.

* ``drop_off``: removes smallest off-band elements subject to a fraction
  of the total absolute mass, to shrink the half-bandwidth (T_Drop).

* ``third_stage``: the third-stage reordering (Sec. 4.3.2), a CM pass
  inside each partition's diagonal block of the band.

These run on the host (numpy), exactly as SaP::GPU runs its reordering
stages partially on the CPU (hybrid strategy, Sec. 3.2-3.3).  This module
is the JAX package's ``repro.core.reorder`` copied for the port (numpy and
heapq only), with its trace spans.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Tuple

import numpy as np

from ..obs.trace import span
from .sparse import CSR, csr_from_coo, csr_from_dense

INF = np.inf


@dataclasses.dataclass
class ReorderPlan:
    """Host-side result of the DB/CM/drop-off analysis (paper Fig. 3.1).

    The permutations are stored once here and applied/undone inside the
    device-side solve; re-running the analysis per right-hand side is the
    exact waste the plan/factor/solve lifecycle removes.

    csr     : fully reordered matrix (the Krylov matvec ordering)
    b_perm  : composed RHS permutation, ``b_reordered = b[b_perm]``
    x_perm  : inverse unknown permutation, ``x = x_reordered[x_perm]``
    k       : preconditioner half bandwidth (after drop-off, >= 1)
    band_pc : (N, 2K+1) band assembly of the preconditioner matrix
    info    : stage diagnostics (k_after_reorder, k_after_drop, ...)
    """

    csr: CSR
    b_perm: np.ndarray
    x_perm: np.ndarray
    k: int
    band_pc: np.ndarray
    info: dict


def analyze(
    a,
    use_db: bool = True,
    use_cm: bool = True,
    drop_tol: float = 0.0,
) -> ReorderPlan:
    """Run the sparse front end once: DB -> CM -> drop-off -> band assembly.

    Pipeline stages T_DB .. T_Asmbl of paper Fig. 3.1.  Drop-off only
    affects the preconditioner band; ``csr`` keeps every element so the
    Krylov matvec uses the exact (reordered) matrix.
    """
    csr = to_csr(a)
    n = csr.n
    info: dict = {}

    with span("reorder", n=n, nnz=int(csr.data.size), drop_tol=drop_tol) as rsp:
        if use_db:
            with span("reorder.db"):
                row_perm = diagonal_boosting(csr)
                csr = permute_rows(csr, row_perm)
            info["db"] = True
        else:
            row_perm = np.arange(n)
            info["db"] = False

        if use_cm:
            with span("reorder.cm"):
                sym_perm = cuthill_mckee(symmetrize(csr))
                csr = permute_symmetric(csr, sym_perm)
            info["cm"] = True
        else:
            sym_perm = np.arange(n)
            info["cm"] = False

        k_full = half_bandwidth(csr)
        info["k_after_reorder"] = k_full

        csr_pc = csr
        k = k_full
        if drop_tol > 0.0:
            with span("reorder.drop"):
                csr_pc, k = drop_off(csr, drop_tol)
            info["k_after_drop"] = k
        k = max(k, 1)
        rsp.annotate(k=k)

        with span("reorder.assemble"):
            band_pc = csr_to_band(csr_pc, k)

    return ReorderPlan(
        csr=csr,
        b_perm=row_perm[sym_perm],
        x_perm=np.argsort(sym_perm),
        k=k,
        band_pc=band_pc,
        info=info,
    )


def to_csr(a) -> CSR:
    if isinstance(a, CSR):
        return a
    if hasattr(a, "tocsr"):  # scipy
        m = a.tocsr()
        return CSR(
            indptr=np.asarray(m.indptr, dtype=np.int64),
            indices=np.asarray(m.indices, dtype=np.int64),
            data=np.asarray(m.data, dtype=np.float64),
            n=m.shape[0],
        )
    return csr_from_dense(np.asarray(a))


# ---------------------------------------------------------------------------
# DB: diagonal boosting via min-weight bipartite perfect matching
# ---------------------------------------------------------------------------


def diagonal_boosting(
    csr: CSR, return_scaling: bool = False
) -> np.ndarray | Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Row permutation sigma maximizing prod |a_{i, sigma_i}|.

    Returns ``row_perm`` such that ``A[row_perm]`` has the boosted diagonal;
    i.e. row_perm[new_row] = old_row, with column j matched to old row
    row_perm[j].
    """
    n = csr.n
    indptr, indices, data = csr.indptr, csr.indices, csr.data

    # ---- DB-S1: weights c_ij = log a_i - log |a_ij| ------------------------
    absdata = np.abs(data)
    rowmax = np.zeros(n)
    rows = csr.row_ids()
    np.maximum.at(rowmax, rows, absdata)
    rowmax = np.maximum(rowmax, 1e-300)
    with np.errstate(divide="ignore"):
        w = np.log(rowmax[rows]) - np.log(np.maximum(absdata, 1e-300))
    w = np.where(absdata == 0.0, INF, w)

    # ---- DB-S2: initial potentials + greedy partial match ------------------
    u = np.full(n, INF)  # row potential: min_j c_ij
    np.minimum.at(u, rows, w)
    u = np.where(np.isfinite(u), u, 0.0)
    v = np.full(n, INF)  # col potential: min_i (c_ij - u_i)
    np.minimum.at(v, indices, w - u[rows])
    v = np.where(np.isfinite(v), v, 0.0)

    row_of_col = np.full(n, -1, dtype=np.int64)  # matching: column -> row
    col_of_row = np.full(n, -1, dtype=np.int64)
    # greedy tight edges (c_ij - u_i - v_j == 0)
    tight = np.nonzero(np.abs(w - u[rows] - v[indices]) < 1e-12)[0]
    for e in tight:
        i, j = rows[e], indices[e]
        if col_of_row[i] < 0 and row_of_col[j] < 0:
            col_of_row[i] = j
            row_of_col[j] = i

    # ---- DB-S3: Dijkstra shortest augmenting path per unmatched row --------
    for i0 in range(n):
        if col_of_row[i0] >= 0:
            continue
        # Dijkstra over rows; dist to columns implicit
        dist_col = np.full(n, INF)
        pred_row_of_col = np.full(n, -1, dtype=np.int64)
        visited_col = np.zeros(n, dtype=bool)
        heap = []
        # seed from row i0
        s, e = indptr[i0], indptr[i0 + 1]
        for t in range(s, e):
            j = indices[t]
            if not np.isfinite(w[t]):
                continue
            nd = w[t] - u[i0] - v[j]
            if nd < dist_col[j]:
                dist_col[j] = nd
                pred_row_of_col[j] = i0
                heapq.heappush(heap, (nd, j))
        found_j = -1
        final_dist = 0.0
        while heap:
            dj, j = heapq.heappop(heap)
            if visited_col[j] or dj > dist_col[j]:
                continue
            visited_col[j] = True
            if row_of_col[j] < 0:
                found_j = j
                final_dist = dj
                break
            # continue through the matched row of column j
            i = row_of_col[j]
            s, e = indptr[i], indptr[i + 1]
            for t in range(s, e):
                j2 = indices[t]
                if visited_col[j2] or not np.isfinite(w[t]):
                    continue
                nd = dj + w[t] - u[i] - v[j2]
                if nd < dist_col[j2] - 1e-15:
                    dist_col[j2] = nd
                    pred_row_of_col[j2] = i
                    heapq.heappush(heap, (nd, j2))
        if found_j < 0:
            # structurally singular for this row: leave for fallback pass
            continue
        # update potentials (Johnson re-weighting)
        upd = visited_col | (np.arange(n) == found_j)
        scl = np.nonzero(upd)[0]
        for j in scl:
            if dist_col[j] <= final_dist:
                v[j] += dist_col[j] - final_dist
        # rows on alternating tree: u_i adjusted so tightness is kept
        # (recompute u for matched rows of updated columns)
        for j in scl:
            i = row_of_col[j]
            if i >= 0:
                # keep c_ij - u_i - v_j == 0 on matching edges
                s_, e_ = indptr[i], indptr[i + 1]
                for t in range(s_, e_):
                    if indices[t] == j:
                        u[i] = w[t] - v[j]
                        break
        u[i0] = 0.0 if not np.isfinite(u[i0]) else u[i0]
        # augment along predecessor chain
        j = found_j
        while True:
            i = pred_row_of_col[j]
            row_of_col[j] = i
            col_of_row[i], j = j, col_of_row[i]
            if j < 0:
                break
        # fix u for the newly matched start row
        s, e = indptr[i0], indptr[i0 + 1]
        for t in range(s, e):
            if indices[t] == col_of_row[i0]:
                u[i0] = w[t] - v[col_of_row[i0]]
                break

    # ---- fallback: complete any unmatched rows/cols arbitrarily ------------
    free_cols = [j for j in range(n) if row_of_col[j] < 0]
    fc = 0
    for i in range(n):
        if col_of_row[i] < 0:
            j = free_cols[fc]
            fc += 1
            col_of_row[i] = j
            row_of_col[j] = i

    # ---- DB-S4: permutation (+ scaling) -------------------------------------
    # new row j should be old row matched to column j
    row_perm = row_of_col.copy()
    if not return_scaling:
        return row_perm
    # I-matrix scaling: r_i = exp(u_i)/a_i ; c_j = exp(v_j)  (Olschowka-
    # Neumaier); returns row/col scale factors for the *original* ordering.
    r_scale = np.exp(u) / rowmax
    c_scale = np.exp(v)
    return row_perm, r_scale, c_scale


# ---------------------------------------------------------------------------
# CM: Cuthill-McKee with the paper's multi-start heuristics
# ---------------------------------------------------------------------------


def symmetrize(csr: CSR) -> CSR:
    """Structure/values of (|A| + |A^T|)/2 (paper: (QA + (QA)^T)/2)."""
    at = csr.transpose()
    rows = np.concatenate([csr.row_ids(), at.row_ids()])
    cols = np.concatenate([csr.indices, at.indices])
    data = np.concatenate([np.abs(csr.data) * 0.5, np.abs(at.data) * 0.5])
    return csr_from_coo(csr.n, rows, cols, data)


def _bfs_cm(
    adj_indptr, adj_indices, deg, start, n
) -> Tuple[np.ndarray, np.ndarray, int, int]:
    """Single CM BFS pass; returns (order, level, height, max_level_width).

    Handles disconnected graphs by restarting from the unvisited node of
    minimum degree (each component restarts at level 0).
    """
    order = np.full(n, -1, dtype=np.int64)
    level = np.full(n, -1, dtype=np.int64)
    width = np.zeros(n + 1, dtype=np.int64)
    order[0] = start
    level[start] = 0
    width[0] += 1
    head, tail = 0, 1
    height = 0
    while tail < n:
        if head == tail:  # new component
            rest = np.nonzero(level < 0)[0]
            nxt = rest[np.argmin(deg[rest])]
            order[tail] = nxt
            level[nxt] = 0
            width[0] += 1
            tail += 1
        x = order[head]
        head += 1
        s, e = adj_indptr[x], adj_indptr[x + 1]
        nbrs = adj_indices[s:e]
        fresh = nbrs[level[nbrs] < 0]
        if fresh.size:
            # CM rule: enqueue unvisited neighbors by ascending degree
            fresh = np.unique(fresh)
            fresh = fresh[np.argsort(deg[fresh], kind="stable")]
            lv = level[x] + 1
            level[fresh] = lv
            height = max(height, int(lv))
            width[lv] += fresh.size
            order[tail : tail + fresh.size] = fresh
            tail += fresh.size
    return order, level, height, int(width.max())


def cuthill_mckee(sym: CSR, max_iters: int = 3, reverse: bool = False) -> np.ndarray:
    """CM ordering of a symmetric CSR.  Returns perm: new_idx -> old_idx.

    Paper heuristics (Sec. 3.3): start from the min-degree node; rerun from
    the lowest-degree node of the deepest BFS level; stop when the tree
    height stops increasing or the max level width stops decreasing
    (at most ``max_iters`` CM iterations).
    """
    n = sym.n
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    deg = np.diff(sym.indptr)
    cand = int(np.argmin(deg))
    tried: set[int] = set()
    best = None  # (order, height, width)
    for _ in range(max_iters):
        tried.add(cand)
        order, level, height, width = _bfs_cm(sym.indptr, sym.indices, deg, cand, n)
        if best is not None and height <= best[1] and width >= best[2]:
            break  # no improvement -> terminate (paper heuristic)
        if best is None or height > best[1] or width < best[2]:
            best = (order, height, width)
        # next start: lowest-degree node on the last level, not yet tried
        last = np.nonzero(level == height)[0]
        last = last[np.argsort(deg[last], kind="stable")]
        nxt = next((int(x) for x in last if int(x) not in tried), None)
        if nxt is None:
            rest = [x for x in range(n) if x not in tried]
            if not rest:
                break
            nxt = int(rest[np.argmin(deg[rest])])
        cand = nxt
    order = best[0]
    if reverse:
        order = order[::-1].copy()
    return order


def half_bandwidth(csr: CSR) -> int:
    rows = csr.row_ids()
    nz = csr.data != 0.0
    if not np.any(nz):
        return 0
    return int(np.max(np.abs(rows[nz] - csr.indices[nz])))


def permute_rows(csr: CSR, perm: np.ndarray) -> CSR:
    """Rows reordered: new row i = old row perm[i]."""
    counts = np.diff(csr.indptr)[perm]
    indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    idx = np.concatenate(
        [np.arange(csr.indptr[p], csr.indptr[p + 1]) for p in perm]
    ) if csr.nnz else np.zeros(0, dtype=np.int64)
    return CSR(indptr=indptr, indices=csr.indices[idx], data=csr.data[idx], n=csr.n)


def permute_symmetric(csr: CSR, perm: np.ndarray) -> CSR:
    """Symmetric permutation: B = A[perm][:, perm]."""
    inv = np.empty_like(perm)
    inv[perm] = np.arange(csr.n)
    rp = permute_rows(csr, perm)
    return csr_from_coo(csr.n, rp.row_ids(), inv[rp.indices], rp.data)


def csr_to_band(csr: CSR, k: int) -> np.ndarray:
    """Assemble (N, 2K+1) band storage; entries outside the band dropped."""
    n = csr.n
    band = np.zeros((n, 2 * k + 1))
    rows = csr.row_ids()
    off = csr.indices - rows
    keep = np.abs(off) <= k
    band[rows[keep], off[keep] + k] = csr.data[keep]
    return band


def drop_off(csr: CSR, frac: float) -> Tuple[CSR, int]:
    """Drop smallest-|.|  far-from-diagonal elements, bounded by ``frac``
    of the total absolute mass; returns (new_csr, new_half_bandwidth)."""
    rows = csr.row_ids()
    off = np.abs(csr.indices - rows)
    total = np.abs(csr.data).sum()
    budget = frac * total
    k0 = int(off.max()) if off.size else 0
    # mass per distance
    mass = np.zeros(k0 + 1)
    np.add.at(mass, off, np.abs(csr.data))
    # cumulative mass dropped if we truncate band to K (drop all dist > K)
    dropped = np.concatenate([np.cumsum(mass[::-1])[::-1][1:], [0.0]])
    k_new = k0
    for k in range(k0 + 1):
        if dropped[k] <= budget:
            k_new = k
            break
    keep = off <= k_new
    out = csr_from_coo(csr.n, rows[keep], csr.indices[keep], csr.data[keep])
    return out, k_new


# ---------------------------------------------------------------------------
# Third-stage reordering (Sec. 4.3.2): per-partition CM
# ---------------------------------------------------------------------------


def third_stage(
    band: np.ndarray, k: int, p: int, part_size: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-partition CM reordering of the banded matrix.

    ``band``: (N_pad, 2K+1) with N_pad = p * part_size.
    Returns (global_perm, k_per_partition) where global_perm is the
    concatenation of intra-partition permutations (new -> old, global ids)
    and k_per_partition[i] is the half bandwidth of partition i after its
    local reordering.
    """
    n_pad = band.shape[0]
    if n_pad != p * part_size:
        raise ValueError(f"band has {n_pad} rows, not p * part_size = {p * part_size}")
    perm = np.empty(n_pad, dtype=np.int64)
    k_i = np.zeros(p, dtype=np.int64)
    for i in range(p):
        lo, hi = i * part_size, (i + 1) * part_size
        rows = np.arange(lo, hi)
        rows_l, cols_l, vals = [], [], []
        for j in range(2 * k + 1):  # the diagonal block's entries, column by column of the band
            c = rows - k + j
            ok = (c >= lo) & (c < hi) & (band[lo:hi, j] != 0.0)
            rows_l.append(rows[ok] - lo)
            cols_l.append(c[ok] - lo)
            vals.append(band[lo:hi, j][ok])
        block = csr_from_coo(
            part_size, np.concatenate(rows_l), np.concatenate(cols_l), np.concatenate(vals)
        )
        local = cuthill_mckee(symmetrize(block))
        perm[lo:hi] = local + lo
        k_i[i] = half_bandwidth(permute_symmetric(block, local))
    return perm, k_i
