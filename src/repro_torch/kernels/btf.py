"""Block-tridiagonal LU factorization kernel (SaP factor stage).

Replaces the TPU kernel ``repro/kernels/btf.py:_btf_kernel`` (``btf_pallas``).
The CUDA source is ``csrc/btf.cu``: one thread block per partition walks
the M block rows, ``S_0 = D_0``, ``L_j = E_j inv(S_{j-1})``,
``S_j = D_j - L_j F_{j-1}``, inverting each ``S_j`` by boosted Gauss-Jordan
in shared memory (in a device workspace when K x K floats do not fit, as
for the SaP-E reduced chain at block size 2K = 400).

Bound on the H100: operations (~6 K^3 flops per block row against 5 K^2
floats moved).  The design keeps the elimination block and the running
inverse in shared memory; parallelism is one block per partition, so at
P = 64 about half the SMs are idle.

On a CPU tensor the wrapper runs the plain version
(:func:`repro_torch.core.block_lu.btf_ref`); on a CUDA tensor it launches
the kernel or raises.
"""

from __future__ import annotations

import torch

from ..core.block_lu import DEFAULT_BOOST, btf_ref
from . import build
from ._launch import check_operands, check_shape, stream_handle


def btf(
    d: torch.Tensor, e: torch.Tensor, f: torch.Tensor, boost_eps: float = DEFAULT_BOOST
) -> tuple[torch.Tensor, torch.Tensor]:
    """Factor all partitions.  d/e/f: (P, M, K, K) -> (sinv, l) same shape."""
    if d.device.type == "cpu":
        fac = btf_ref(d, e, f, boost_eps)
        return fac.sinv, fac.l
    check_operands("btf", d.device, d=d, e=e, f=f)
    p, m, k, _ = d.shape
    for name, t in (("d", d), ("e", e), ("f", f)):
        check_shape("btf", name, t, (p, m, k, k))
    lib = build.load("btf")
    sinv = torch.empty_like(d)
    l = torch.empty_like(d)
    ws = torch.empty((p * lib.btf_workspace_floats(k),), dtype=torch.float32, device=d.device)
    code = lib.btf_launch(
        d.data_ptr(), e.data_ptr(), f.data_ptr(), sinv.data_ptr(), l.data_ptr(),
        ws.data_ptr(), p, m, k, boost_eps, stream_handle(d.device),
    )
    build.check(lib, code, "btf")
    btf.launches += 1
    return sinv, l


btf.launches = 0
