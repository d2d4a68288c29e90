"""Carry a factorization across: numpy leaves in, a port handle out.

A SaP factorization is the solver's state, the counterpart of a model's
weights: factored once, reused for any number of right-hand sides.
:func:`factorization_from_numpy` rebuilds a :class:`SaPFactorization` from
the leaves of a factorization computed elsewhere (for example by the JAX
package, flattened to numpy by the caller), so the port can solve with it
without refactoring.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from .block_lu import BTFactors
from .cyclic_reduction import BCRFactors, BCRLevel
from .operators import BandedOperator, CsrOperator
from .sap import SaPFactorization, resolve_device
from .spike import SaPPreconditioner

# Leaf names, as dotted paths into the factorization handle.  A BCR
# factorization adds ``red_bcr.root_inv`` and, per level l = 0, 1, ...,
# ``red_bcr.<l>.<field>`` for every field of BCR_LEVEL_FIELDS (the levels
# differ in length, so they are not stacked).
LEAVES = (
    "op.band",
    "op.data", "op.rows", "op.cols",
    "b_perm", "x_perm",
    "lu.sinv", "lu.l", "lu.f",
    "b_cpl", "c_cpl", "v_bot", "w_top", "rbar_inv",
    "red_lu.sinv", "red_lu.l", "red_lu.f",
    "red_bcr.root_inv",
    "d_factor",
)
BCR_LEVEL_FIELDS = BCRLevel._fields
_BCR_LEVEL_LEAF = re.compile(r"red_bcr\.(\d+)\.(" + "|".join(BCR_LEVEL_FIELDS) + r")")


def _bcr_factors(get, arrays: dict, m: int) -> BCRFactors:
    levels = []
    while f"red_bcr.{len(levels)}.lo" in arrays:
        lvl = len(levels)
        levels.append(BCRLevel(*(get(f"red_bcr.{lvl}.{name}") for name in BCR_LEVEL_FIELDS)))
    return BCRFactors(levels=tuple(levels), root_inv=get("red_bcr.root_inv"), m=m)


def factorization_from_numpy(
    arrays: dict[str, np.ndarray], meta: dict, device=None
) -> SaPFactorization:
    """Build a :class:`SaPFactorization` from numpy leaves.

    ``arrays`` maps the names in :data:`LEAVES` (and the per-level
    ``red_bcr.<l>.*`` names) to arrays; leaves a variant has none of may be
    absent.  The operator is ``op.band`` (band storage) or ``op.data`` /
    ``op.rows`` / ``op.cols`` (expanded COO of the reordered matrix, with
    ``b_perm`` / ``x_perm``).  ``meta`` holds ``variant``, ``p``, ``m``,
    ``k`` (the block size), ``tol``, ``maxiter`` and ``solver``, and
    optionally ``iter_dtype``; ``n`` for a COO operator; ``red_bcr_m``, the
    true chain length, for a BCR factorization.  The reduced solver follows
    from the leaves present.  Tensors go to ``device`` (default: the card).
    """
    unknown = {n for n in arrays if n not in LEAVES and not _BCR_LEVEL_LEAF.fullmatch(n)}
    if unknown:
        raise ValueError(f"unknown factorization leaves {sorted(unknown)}")
    dev = resolve_device(device)

    def get(name):
        a = arrays.get(name)
        return None if a is None else torch.tensor(np.asarray(a)).to(dev)

    def index(name):
        a = get(name)
        return None if a is None else a.to(torch.int64)

    red_lu = red_bcr = None
    reduced_solver = "none"
    if arrays.get("red_lu.sinv") is not None:
        red_lu = BTFactors(sinv=get("red_lu.sinv"), l=get("red_lu.l"), f=get("red_lu.f"))
        reduced_solver = "chain"
    if arrays.get("red_bcr.root_inv") is not None:
        red_bcr = _bcr_factors(get, arrays, int(meta["red_bcr_m"]))
        reduced_solver = "bcr"
    pc = SaPPreconditioner(
        variant=meta["variant"],
        lu=BTFactors(sinv=get("lu.sinv"), l=get("lu.l"), f=get("lu.f")),
        b_cpl=get("b_cpl"),
        c_cpl=get("c_cpl"),
        v_bot=get("v_bot"),
        w_top=get("w_top"),
        rbar_inv=get("rbar_inv"),
        red_lu=red_lu,
        red_bcr=red_bcr,
        p=int(meta["p"]),
        m=int(meta["m"]),
        k=int(meta["k"]),
        reduced_solver=reduced_solver,
    )
    if arrays.get("op.band") is not None:
        op = BandedOperator.from_band(get("op.band"))
        n, k = op.n, op.k
    else:
        n, k = int(meta["n"]), int(meta["k"])
        op = CsrOperator(data=get("op.data"), rows=index("op.rows"), cols=index("op.cols"), n=n)
    return SaPFactorization(
        op=op,
        pc=pc,
        n=n,
        k=k,
        tol=float(meta["tol"]),
        maxiter=int(meta["maxiter"]),
        iter_dtype=meta.get("iter_dtype"),
        solver=meta["solver"],
        d_factor=get("d_factor"),
        b_perm=index("b_perm"),
        x_perm=index("x_perm"),
    )
