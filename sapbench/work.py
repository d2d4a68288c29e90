"""The least work of each stage of a SaP solve: (flops, bytes) from shapes.

A frozen copy of the port's analytic counts (``kernels/ops.py``'s
``btf_work``, ``bts_work``, ``fused_work``, ``bcr_work`` and
``obs/cost.py``'s split, product and matvec counts), kept here so that a
change to the program cannot change the yardstick.  Each count reads every
input once and writes every output once, in float32 (4 bytes) unless
``itemsize`` says otherwise.

The two stage counts a roofline share divides by do not depend on what
implements the stage.  Where the port has two implementations of the same
mathematics -- the fused factor+spike pass or btf, the UL btf and the
spike products; the reduced chain by the sequential sweep or by block
cyclic reduction -- the stage is counted at the smaller of the two
implementations' flops and the smaller of their bytes, so the same stage
reads the same bound whichever of them ran.
"""

from __future__ import annotations

Work = tuple[float, float]  # (flops, bytes)


def _add(*works: Work) -> Work:
    return sum(w[0] for w in works), sum(w[1] for w in works)


def _times(n: float, work: Work) -> Work:
    return n * work[0], n * work[1]


def _least(*works: Work) -> Work:
    """Fewest flops and fewest bytes over implementations of one stage."""
    return min(w[0] for w in works), min(w[1] for w in works)


def partition_blocks(n: int, p: int, k: int) -> int:
    """M, the K x K block rows of each of the P partitions: the N rows are
    split into P equal partitions, each padded to a multiple of K."""
    ni = -(-n // p)
    return -(-ni // k)


def btf_work(p: int, m: int, k: int, itemsize: int = 4) -> Work:
    """Block-tridiagonal LU of P chains of M K x K blocks.  Row 0 inverts
    (2K^3); rows 1..M-1 form L_j (2K^3), S_j = D_j - L_j F_{j-1} (2K^3 +
    K^2) and invert S_j (2K^3).  Reads D, E_1.., F_..M-2; writes sinv, l."""
    flops = p * ((6 * m - 4) * k**3 + (m - 1) * k**2)
    return float(flops), float(itemsize) * p * k * k * ((3 * m - 2) + 2 * m)


def bts_work(p: int, m: int, k: int, r: int, itemsize: int = 4) -> Work:
    """Both sweeps of a factored chain for R right-hand sides (2K^2 R flops
    a block product).  Reads sinv, l, f and b; writes x."""
    flops = p * ((6 * m - 4) * k * k * r + 2 * (m - 1) * k * r)
    return float(flops), float(itemsize) * p * ((3 * m - 2) * k * k + 2 * m * k * r)


def fused_work(p: int, m: int, k: int, itemsize: int = 4) -> Work:
    """The LU and the UL recurrence, the two spike carries and the four
    corner products in one pass.  Reads the chain and both couplings;
    writes sinv, l and four K x K corners."""
    flops = p * ((16 * m - 4) * k**3 + 2 * (m - 1) * k**2)
    return float(flops), float(itemsize) * p * k * k * ((3 * m - 2) + 2 * m + 2 + 4)


def bcr_work(m: int, k: int, r: int, itemsize: int = 4) -> dict[str, Work]:
    """Block cyclic reduction of one chain of m K x K blocks padded to 2^L:
    the factor's ``inv_odd`` and ``reduce`` over every level, a solve's
    ``rhs_reduce`` and ``backsub`` for R right-hand sides."""
    rows = (1 << max(m - 1, 0).bit_length()) - 1
    blk, vec = float(itemsize) * k * k, float(itemsize) * k * r
    return {
        "inv_odd": (2.0 * k**3 * (rows + 1), 2 * blk * (rows + 1)),
        "reduce": (rows * (12.0 * k**3 + 2 * k * k), rows * 11 * blk),
        "rhs_reduce": (rows * (4.0 * k * k * r + 2 * k * r), rows * (2 * blk + 3 * vec)),
        "backsub": (rows * (6.0 * k * k * r + 2 * k * r), rows * (3 * blk + 4 * vec)),
    }


def products(count: int, k: int, r: int) -> Work:
    """``count`` K x K blocks times K x R operands (float32)."""
    return count * 2.0 * k * k * r, count * 4.0 * (k * k + 2 * k * r)


def matvec_work(n: int, k: int, r: int) -> Work:
    """A float32 band (N, 2K+1) times an (N, R) block: the band and x read
    once, y written."""
    return 2.0 * (2 * k + 1) * n * r, 4.0 * n * (2 * k + 1) + 8.0 * n * r


def factor_work(n: int, k: int, p: int, variant: str) -> Work:
    """The factor stage: the split into P block-tridiagonal partitions, the
    partitions' LU with the spike blocks the variant needs, and the
    reduced system (C: the truncated P-1 K x K blocks; E: the exact chain
    of P-1 2K x 2K blocks)."""
    m = partition_blocks(n, p, k)
    split = (0.0, 4.0 * n * (2 * k + 1) + 3 * 4.0 * p * m * k * k)
    if variant == "D" or p == 1:
        return _add(split, btf_work(p, m, k))
    if variant == "C":
        lu_spikes = _least(fused_work(p, m, k),
                           _add(_times(2, btf_work(p, m, k)), products(2 * (p - 1), k, k)))
        reduced = _add(products(p - 1, k, k), btf_work(p - 1, 1, k))
    elif variant == "E":
        lu_spikes = _least(fused_work(p, m, k),
                           _add(btf_work(p, m, k), _times(2, bts_work(p, m, k, k))))
        bw = bcr_work(p - 1, 2 * k, 1)
        assemble = (0.0, 4.0 * (p - 1) * (3 * (2 * k) ** 2 + 4 * k * k))
        reduced = _add(assemble, _least(btf_work(1, p - 1, 2 * k),
                                        _add(bw["inv_odd"], bw["reduce"])))
    else:
        raise ValueError(f"unknown variant {variant!r}")
    return _add(split, lu_spikes, reduced)


def apply_work(n: int, k: int, p: int, variant: str, r: int) -> Work:
    """One preconditioner apply to R columns: the partitions' solve (D), or
    two solves around the truncated correction (C: five K x K products an
    interface) or around the exact reduced solve and the two coupling
    products (E)."""
    m = partition_blocks(n, p, k)
    sweep = bts_work(p, m, k, r)
    if variant == "D" or p == 1:
        return sweep
    if variant == "C":
        return _add(_times(2, sweep), products(5 * (p - 1), k, r))
    if variant == "E":
        bw = bcr_work(p - 1, 2 * k, r)
        chain = _least(bts_work(1, p - 1, 2 * k, r), _add(bw["rhs_reduce"], bw["backsub"]))
        return _add(_times(2, sweep), chain, products(2 * (p - 1), k, r))
    raise ValueError(f"unknown variant {variant!r}")


def solve_work(n: int, k: int, p: int, variant: str, r: int, sweeps: int) -> Work:
    """A BiCGStab(2) solve of R columns that ran ``sweeps`` whole sweeps:
    four preconditioner applies and four band matvecs a sweep, one apply
    before the loop (M^-1 b) and one matvec after it (the true residual)."""
    step = _add(apply_work(n, k, p, variant, r), matvec_work(n, k, r))
    return _add(_times(4 * sweeps, step), step)


def bound_s(work: Work, peak_flops: float, peak_bytes_per_s: float) -> float:
    """The least time the device could take: max(flops / peak, bytes / bandwidth)."""
    return max(work[0] / peak_flops, work[1] / peak_bytes_per_s)
