"""Block cyclic reduction kernels (SaP-E reduced-chain stage).

Replace the TPU kernels of ``repro/kernels/bcr.py``: ``_inv_odd_kernel``
(:func:`inv_odd`), ``_reduce_kernel`` (:func:`reduce`),
``_rhs_reduce_kernel`` (:func:`rhs_reduce`) and ``_backsub_kernel``
(:func:`backsub`).  The CUDA source is ``csrc/bcr.cu``: every elimination
level is one grid over (row, output tile) or (row slice) -- the TPU
kernels' per-row grid cell split further, since one level has only m/2
rows.  ``reduce`` launches two grids per call (D', E', F' read all of lo
and hi); each wrapper counts one launch per call.

Bound on the H100: the factor (``inv_odd`` + ``reduce``) by operations,
~14 (2K)^3 flops per eliminated row; the solve (``rhs_reduce`` +
``backsub``) at small R by bytes, every factor block read once.
``reduce`` computes each level's products as staged, register-tiled
tiles whose size the kernel's ``bcr_reduce_tile`` picks from the level's
shape (64 wide, or 80 / 96 on a level wide enough to give every SM eight
CTAs of a tile that pads K by at most 5%).  ``inv_odd`` inverts each block on a
thread-block cluster that holds the
block in its distributed shared memory (``inv_cluster_kernel``; at
2K = 400, four CTAs of 100 rows), by blocked Gauss-Jordan in panels of 32
columns.  The kernel's ``bcr_inv_cluster_size`` picks the cluster size
from the block size; blocks too large for a cluster of 16 go to the
one-block kernel (``inv_kernel``, the block in device memory), and those
launches are also counted apart, in ``inv_odd.block_launches``.

The solve at R <= 8 runs a warp per output row, each warp streaming its
rows of the blocks two ahead through a ring in shared memory (TMA bulk
copies for 16-byte rows, ``cp.async`` otherwise) against vectors staged
in shared memory: ``rhs_reduce`` in one pass over ``split`` CTAs a block
(``bcr_rhs_reduce_split``), ``backsub`` in one launch a level on a
thread-block cluster per odd block (``bcr_backsub_cluster``), t passed
between the CTAs in shared memory.  Both sizes come from one rule on
(m/2, K, R): the largest split at which the card holds the whole level at
once; they are counted in ``rhs_reduce.by_split`` and
``backsub.by_cluster``.  R > 8 takes the tiled
kernels (``backsub`` then two grids through a workspace), counted apart
in ``rhs_reduce.block_launches`` and ``backsub.block_launches``.

Storage: float32, bfloat16 or float64, each on its own instantiation
(``by_dtype`` on each wrapper counts them): every kernel reads its blocks
and vectors in the storage dtype, computes in float32 (float64 for
float64) and stores its outputs rounded to the storage dtype once, as
the plain versions round each level; ``reduce`` keeps lo and hi in the
compute dtype for its second grid (a workspace, bfloat16 only) and the
tiled ``backsub`` its t.  Float16, integer and mixed dtypes raise before
any build.

On a CPU tensor each wrapper runs its plain version from
:mod:`repro_torch.core.cyclic_reduction`; on a CUDA tensor it launches the
kernel or raises.
"""

from __future__ import annotations

import torch

from ..core.block_lu import DEFAULT_BOOST, compute_dtype
from ..core.cyclic_reduction import (
    bcr_backsub_ref,
    bcr_inv_odd_ref,
    bcr_reduce_ref,
    bcr_rhs_reduce_ref,
)
from . import build
from ._launch import SOLVER_DTYPES, check_grid, check_operands, check_shape, entry, stream_handle


def _blocks(what: str, t: torch.Tensor) -> tuple[int, int]:
    """(m, K) of an (m, K, K) block tensor; raises on any other shape."""
    if t.ndim != 3 or t.shape[1] != t.shape[2]:
        raise ValueError(f"{what}: expected (m, K, K) blocks, got {tuple(t.shape)}")
    return t.shape[0], t.shape[1]


def inv_odd(d: torch.Tensor, boost_eps: float = DEFAULT_BOOST, first: int = 1) -> torch.Tensor:
    """Boosted Gauss-Jordan inverses of d[first::2]: (m, K, K) -> (len, K, K).

    ``first=1`` inverts a level's odd diagonal blocks; ``first=0`` on a
    one-block chain inverts the root.  On the card the block size picks
    the route (``bcr_inv_cluster_size``): a cluster of that many CTAs, or
    the one-block kernel, counted also in ``inv_odd.block_launches``.
    """
    if d.device.type == "cpu":
        return bcr_inv_odd_ref(d, boost_eps, first)
    dtype = check_operands("bcr inv_odd", d.device, SOLVER_DTYPES, d=d)
    m, k = _blocks("bcr inv_odd", d)
    count = len(range(first, m, 2))
    lib = build.load("bcr")
    out = torch.empty((count, k, k), dtype=d.dtype, device=d.device)
    if count:
        cluster = entry(lib, "bcr_inv_cluster_size", dtype)(k)
        if cluster < 0:
            build.check(lib, -cluster, "bcr inv_odd cluster size")
        check_grid("bcr inv_odd", "x", count * max(cluster, 1))
        per_block = entry(lib, "bcr_inv_workspace_floats", dtype)(k, cluster)
        ws = torch.empty((max(1, count * per_block),), dtype=compute_dtype(dtype),
                         device=d.device)
        code = entry(lib, "bcr_inv_launch", dtype)(
            d.data_ptr(), out.data_ptr(), ws.data_ptr(), count, first, k, boost_eps, cluster,
            stream_handle(d.device),
        )
        build.check(lib, code, f"bcr inv_odd (cluster {cluster}, {dtype})")
        inv_odd.launches += 1
        inv_odd.by_dtype[dtype] = inv_odd.by_dtype.get(dtype, 0) + 1
        if cluster == 0:
            inv_odd.block_launches += 1
    return out


def reduce(
    d: torch.Tensor, e: torch.Tensor, f: torch.Tensor, a_odd: torch.Tensor
) -> tuple[torch.Tensor, ...]:
    """Eliminate the odd rows of an (m, K, K) chain (m even):
    ``(lo, hi, d', e', f')``, each (m/2, K, K)."""
    if d.device.type == "cpu":
        return bcr_reduce_ref(d, e, f, a_odd)
    dtype = check_operands("bcr reduce", d.device, SOLVER_DTYPES, d=d, e=e, f=f, a_odd=a_odd)
    m, k = _blocks("bcr reduce", d)
    if m % 2:
        raise ValueError(f"bcr reduce: chain length {m} must be even")
    for name, t in (("e", e), ("f", f)):
        check_shape("bcr reduce", name, t, (m, k, k))
    check_shape("bcr reduce", "a_odd", a_odd, (m // 2, k, k))
    check_grid("bcr reduce", "z", m // 2)  # a level's block rows on z
    lib = build.load("bcr")
    tile = entry(lib, "bcr_reduce_tile", dtype)(m // 2, k)
    if tile < 0:
        build.check(lib, -tile, "bcr reduce tile")
    lo, hi, dn, en, fn = (torch.empty_like(a_odd) for _ in range(5))
    ws = torch.empty((max(1, entry(lib, "bcr_reduce_workspace_floats", dtype)(m // 2, k)),),
                     dtype=compute_dtype(dtype), device=d.device)
    code = entry(lib, "bcr_reduce_launch", dtype)(
        d.data_ptr(), e.data_ptr(), f.data_ptr(), a_odd.data_ptr(), lo.data_ptr(),
        hi.data_ptr(), dn.data_ptr(), en.data_ptr(), fn.data_ptr(), ws.data_ptr(), m // 2, k,
        tile, stream_handle(d.device),
    )
    build.check(lib, code, f"bcr reduce (tile {tile}, {dtype})")
    reduce.launches += 1
    reduce.by_dtype[dtype] = reduce.by_dtype.get(dtype, 0) + 1
    reduce.by_tile[tile] = reduce.by_tile.get(tile, 0) + 1
    return lo, hi, dn, en, fn


def rhs_reduce(lo: torch.Tensor, hi: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Fold a level's odd right-hand sides into its even equations:
    b (m, K, R) -> (m/2, K, R)."""
    if b.device.type == "cpu":
        return bcr_rhs_reduce_ref(lo, hi, b)
    dtype = check_operands("bcr rhs_reduce", b.device, SOLVER_DTYPES, lo=lo, hi=hi, b=b)
    m2, k = _blocks("bcr rhs_reduce", lo)
    check_shape("bcr rhs_reduce", "hi", hi, (m2, k, k))
    r = b.shape[-1]
    check_shape("bcr rhs_reduce", "b", b, (2 * m2, k, r))
    lib = build.load("bcr")
    split = entry(lib, "bcr_rhs_reduce_split", dtype)(m2, k, r)
    if split < 0:
        build.check(lib, -split, "bcr rhs_reduce split")
    if split:
        check_grid("bcr rhs_reduce", "x", m2 * split)
    else:  # the tiled kernel puts the level's rows on y
        check_grid("bcr rhs_reduce", "y", m2)
    out = torch.empty((m2, k, r), dtype=b.dtype, device=b.device)
    code = entry(lib, "bcr_rhs_reduce_launch", dtype)(
        lo.data_ptr(), hi.data_ptr(), b.data_ptr(), out.data_ptr(), m2, k, r, split,
        stream_handle(b.device),
    )
    build.check(lib, code, f"bcr rhs_reduce (split {split}, {dtype})")
    rhs_reduce.launches += 1
    rhs_reduce.by_dtype[dtype] = rhs_reduce.by_dtype.get(dtype, 0) + 1
    rhs_reduce.by_split[split] = rhs_reduce.by_split.get(split, 0) + 1
    if split == 0:
        rhs_reduce.block_launches += 1
    return out


def backsub(
    a_odd: torch.Tensor,
    e_odd: torch.Tensor,
    f_odd: torch.Tensor,
    b: torch.Tensor,
    x: torch.Tensor,
) -> torch.Tensor:
    """Recover a level's odd unknowns and interleave: ``b`` the level's
    (m, K, R) right-hand side, ``x`` the (m/2, K, R) even unknowns ->
    the level's (m, K, R) solution."""
    if b.device.type == "cpu":
        return bcr_backsub_ref(a_odd, e_odd, f_odd, b, x)
    dtype = check_operands("bcr backsub", b.device, SOLVER_DTYPES, a_odd=a_odd, e_odd=e_odd,
                           f_odd=f_odd, b=b, x=x)
    m2, k = _blocks("bcr backsub", a_odd)
    for name, t in (("e_odd", e_odd), ("f_odd", f_odd)):
        check_shape("bcr backsub", name, t, (m2, k, k))
    r = x.shape[-1]
    check_shape("bcr backsub", "x", x, (m2, k, r))
    check_shape("bcr backsub", "b", b, (2 * m2, k, r))
    lib = build.load("bcr")
    cluster = entry(lib, "bcr_backsub_cluster", dtype)(m2, k, r)
    if cluster < 0:
        build.check(lib, -cluster, "bcr backsub cluster size")
    if cluster:
        check_grid("bcr backsub", "x", m2 * cluster)
    else:  # the tiled kernels put the level's rows on y
        check_grid("bcr backsub", "y", m2)
    # the tiled kernels' workspace, in the compute dtype
    t = torch.empty(x.shape, dtype=compute_dtype(dtype), device=x.device) if cluster == 0 else None
    out = torch.empty((2 * m2, k, r), dtype=x.dtype, device=x.device)
    code = entry(lib, "bcr_backsub_launch", dtype)(
        a_odd.data_ptr(), e_odd.data_ptr(), f_odd.data_ptr(), b.data_ptr(), x.data_ptr(),
        None if t is None else t.data_ptr(), out.data_ptr(), m2, k, r, cluster,
        stream_handle(b.device),
    )
    build.check(lib, code, f"bcr backsub (cluster {cluster}, {dtype})")
    backsub.launches += 1
    backsub.by_dtype[dtype] = backsub.by_dtype.get(dtype, 0) + 1
    backsub.by_cluster[cluster] = backsub.by_cluster.get(cluster, 0) + 1
    if cluster == 0:
        backsub.block_launches += 1
    return out


inv_odd.launches = 0
inv_odd.block_launches = 0  # those of them on the one-block kernel
inv_odd.by_dtype = {}  # launches by storage dtype (so on for the others)
reduce.launches = 0
reduce.by_dtype = {}
reduce.by_tile = {}  # launches by tile size
rhs_reduce.launches = 0
rhs_reduce.by_dtype = {}
rhs_reduce.block_launches = 0  # those of them on the tiled kernel
rhs_reduce.by_split = {}  # launches by CTAs a block (0: the tiled kernel)
backsub.launches = 0
backsub.by_dtype = {}
backsub.block_launches = 0  # those of them on the tiled kernels
backsub.by_cluster = {}  # launches by cluster size (0: the tiled kernels)
