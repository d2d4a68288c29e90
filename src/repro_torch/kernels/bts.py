"""Block-tridiagonal solve kernel (SaP preconditioner apply).

Replaces the TPU kernels ``repro/kernels/bts.py:_fwd_kernel`` and
``_bwd_kernel`` (``bts_pallas``).  The CUDA source is ``csrc/bts.cu``: one
thread block per partition runs the forward sweep
``y_j = b_j - L_j y_{j-1}`` and then the backward sweep
``x_j = Sinv_j (y_j - F_j x_{j+1})`` from j = M-1 down, in one launch.

Bound on the H100: bytes.  Every apply reads sinv, l and f once (for R = 1
about half a flop per byte).  The narrow-R product reads each block row
with a warp's consecutive lanes; with one block per partition only P SMs
stream memory, so the kernel stays below the card's bandwidth at P = 64.

On a CPU tensor the wrapper runs the plain version
(:func:`repro_torch.core.block_lu.bts_ref`); on a CUDA tensor it launches
the kernel or raises.
"""

from __future__ import annotations

import torch

from ..core.block_lu import BTFactors, bts_ref
from . import build
from ._launch import check_operands, check_shape, stream_handle


def bts(
    sinv: torch.Tensor, l: torch.Tensor, f: torch.Tensor, b: torch.Tensor
) -> torch.Tensor:
    """Solve D x = b for all partitions.

    sinv/l/f: (P, M, K, K);  b: (P, M, K, R)  ->  x: (P, M, K, R).
    """
    if b.device.type == "cpu":
        return bts_ref(BTFactors(sinv=sinv, l=l, f=f), b)
    check_operands("bts", b.device, sinv=sinv, l=l, f=f, b=b)
    p, m, k, r = b.shape
    for name, t in (("sinv", sinv), ("l", l), ("f", f)):
        check_shape("bts", name, t, (p, m, k, k))
    lib = build.load("bts")
    x = torch.empty_like(b)
    ws = torch.empty((p * k * r,), dtype=torch.float32, device=b.device)
    code = lib.bts_launch(
        sinv.data_ptr(), l.data_ptr(), f.data_ptr(), b.data_ptr(), x.data_ptr(),
        ws.data_ptr(), p, m, k, r, stream_handle(b.device),
    )
    build.check(lib, code, "bts")
    bts.launches += 1
    return x


bts.launches = 0
