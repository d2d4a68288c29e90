"""Plain reference for dense banded systems in (N, 2K+1) band storage.

``band[r, j] == A[r, r - K + j]``.  :func:`solve` is a sequential block
LU (block Thomas) over the N / K block rows of K x K blocks, with partial
pivoting inside each diagonal block and no partitioning, computed in
float64: the straightforward direct method, independent of the
partitioned, preconditioned and iterated solve it judges.  :func:`matvec`
is the band product row by diagonal.

``solve(..., dtype=torch.float32, tf32=True)`` is the control: the same
method with every operand of its block products and block solves rounded
to TF32 (10 explicit mantissa bits, float32 accumulation), the precision
just below the float32 that the configurations state.

Plain torch only; nothing of the program is imported.
"""

from __future__ import annotations

import torch


def _tf32(t: torch.Tensor) -> torch.Tensor:
    """Round float32 values to TF32's 10-bit mantissa, to nearest."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def matvec(bands: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y = A x for S bands (S, N, 2K+1) and S blocks (S, N, R), in the
    promoted dtype, one diagonal at a time."""
    s, n, w = bands.shape
    k = (w - 1) // 2
    dt = torch.promote_types(bands.dtype, x.dtype)
    xp = torch.zeros((s, n + 2 * k, x.shape[-1]), dtype=dt, device=x.device)
    xp[:, k:k + n] = x
    y = torch.zeros((s, n, x.shape[-1]), dtype=dt, device=x.device)
    for j in range(w):
        y += bands[:, :, j:j + 1].to(dt) * xp[:, j:j + n]
    return y


def _block_row(bands: torch.Tensor, i: int, k: int, dt) -> torch.Tensor:
    """Block row i as a dense (S, K, 3K) slab over block columns i-1..i+1:
    band row r of the slab sits at columns r..r+2K, the flat offset
    r * (3K + 1) + j of a row-major (K, 3K) slab."""
    s = bands.shape[0]
    slab = torch.zeros((s, k, 3 * k), dtype=dt, device=bands.device)
    view = slab.as_strided((s, k, 2 * k + 1), (3 * k * k, 3 * k + 1, 1))
    view.copy_(bands[:, i * k:(i + 1) * k])
    return slab


def solve(bands: torch.Tensor, rhs: torch.Tensor, dtype=torch.float64,
          tf32: bool = False) -> torch.Tensor:
    """x with A_s x_s = b_s for S bands (S, N, 2K+1) and S right-hand-side
    blocks (S, N, R), returned in ``dtype``.

    Forward: S_0 = D_0, S_i = D_i - E_i G_{i-1}, G_i = S_i^-1 F_i,
    z_i = S_i^-1 (b_i - E_i z_{i-1}); backward: x_i = z_i - G_i x_{i+1}.
    N is padded to a multiple of K with identity rows.
    """
    s, n, w = bands.shape
    k = (w - 1) // 2
    r = rhs.shape[-1]
    rnd = _tf32 if tf32 else (lambda t: t)
    n_pad = -(-n // k) * k
    if n_pad > n:
        eye_rows = torch.zeros((s, n_pad - n, w), dtype=bands.dtype, device=bands.device)
        eye_rows[:, :, k] = 1.0
        bands = torch.cat([bands, eye_rows], dim=1)
        rhs = torch.cat([rhs, rhs.new_zeros((s, n_pad - n, r))], dim=1)
    m = n_pad // k
    b = rhs.to(dtype).reshape(s, m, k, r)
    g = torch.empty((s, m, k, k), dtype=dtype, device=bands.device)
    z = torch.empty((s, m, k, r), dtype=dtype, device=bands.device)
    for i in range(m):
        slab = _block_row(bands, i, k, dtype)
        e, d, f = slab[..., :k], slab[..., k:2 * k], slab[..., 2 * k:]
        y = b[:, i]
        if i > 0:
            d = d - rnd(e) @ rnd(g[:, i - 1])
            y = y - rnd(e) @ rnd(z[:, i - 1])
        sol, _ = torch.linalg.solve_ex(rnd(d), rnd(torch.cat([f, y], dim=-1)))
        g[:, i], z[:, i] = sol[..., :k], sol[..., k:]
    x = torch.empty_like(z)
    x[:, m - 1] = z[:, m - 1]
    for i in range(m - 2, -1, -1):
        x[:, i] = z[:, i] - rnd(g[:, i]) @ rnd(x[:, i + 1])
    return x.reshape(s, n_pad, r)[:, :n]
