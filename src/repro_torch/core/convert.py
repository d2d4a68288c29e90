"""Carry a factorization across: numpy leaves in, a port handle out.

A SaP factorization is the solver's state, the counterpart of a model's
weights: factored once, reused for any number of right-hand sides.
:func:`factorization_from_numpy` rebuilds a :class:`SaPFactorization` from
the leaves of a factorization computed elsewhere (for example by the JAX
package, flattened to numpy by the caller), so the port can solve with it
without refactoring.
"""

from __future__ import annotations

import numpy as np
import torch

from .block_lu import BTFactors
from .operators import BandedOperator
from .sap import SaPFactorization, resolve_device
from .spike import SaPPreconditioner

# Leaf names, as dotted paths into the factorization handle.
LEAVES = (
    "op.band",
    "lu.sinv", "lu.l", "lu.f",
    "b_cpl", "c_cpl", "v_bot", "w_top", "rbar_inv",
    "red_lu.sinv", "red_lu.l", "red_lu.f",
    "d_factor",
)


def factorization_from_numpy(
    arrays: dict[str, np.ndarray], meta: dict, device=None
) -> SaPFactorization:
    """Build a :class:`SaPFactorization` from numpy leaves.

    ``arrays`` maps the names in :data:`LEAVES` to arrays; the ``v_bot`` /
    ``w_top`` / ``rbar_inv`` / ``red_lu.*`` leaves may be absent where the
    variant has none.  ``meta`` holds ``variant``, ``p``, ``m``, ``k`` (the
    block size), ``tol``, ``maxiter`` and ``solver``, and optionally
    ``iter_dtype``.  Tensors go to ``device`` (default: the card).
    """
    unknown = set(arrays) - set(LEAVES)
    if unknown:
        raise ValueError(f"unknown factorization leaves {sorted(unknown)}")
    dev = resolve_device(device)

    def get(name):
        a = arrays.get(name)
        return None if a is None else torch.tensor(np.asarray(a)).to(dev)

    red_lu = None
    if arrays.get("red_lu.sinv") is not None:
        red_lu = BTFactors(sinv=get("red_lu.sinv"), l=get("red_lu.l"), f=get("red_lu.f"))
    pc = SaPPreconditioner(
        variant=meta["variant"],
        lu=BTFactors(sinv=get("lu.sinv"), l=get("lu.l"), f=get("lu.f")),
        b_cpl=get("b_cpl"),
        c_cpl=get("c_cpl"),
        v_bot=get("v_bot"),
        w_top=get("w_top"),
        rbar_inv=get("rbar_inv"),
        red_lu=red_lu,
        p=int(meta["p"]),
        m=int(meta["m"]),
        k=int(meta["k"]),
        reduced_solver="chain" if red_lu is not None else "none",
    )
    op = BandedOperator.from_band(get("op.band"))
    return SaPFactorization(
        op=op,
        pc=pc,
        n=op.n,
        k=op.k,
        tol=float(meta["tol"]),
        maxiter=int(meta["maxiter"]),
        iter_dtype=meta.get("iter_dtype"),
        solver=meta["solver"],
        d_factor=get("d_factor"),
    )
