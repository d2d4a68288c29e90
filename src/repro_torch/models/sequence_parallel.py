"""Sequence parallelism for the SaP-scans (the SSD and WKV recurrences).

Long-context prefill of the recurrent architectures splits the sequence
axis over ranks.  This is the paper's split along time: each rank solves
its local block of the (block-bidiagonal) recurrence system, then the
coupling between ranks -- the paper's reduced system, exact for triangular
systems -- is resolved by a chain of neighbour steps carrying (decayed)
partial states:

    r_i <- r_{i-1} * D_{i-1} + s_{i-1}        (P-1 neighbour steps)

where s_j is rank j's local carry and D_j its total decay.  The chain is
exact (no truncation: the system is triangular), costs P-1 messages of one
state each, and the local work is the port's chunked scan kernel, run
once from a zero state.  The incoming state is folded in analytically (an
elementwise product and one small einsum, in float32), so no second scan
runs.

Each rank holds its slice of T and calls the callable that
:func:`sp_ssd` / :func:`sp_wkv6` return on it (one process a mesh
position, where the JAX package runs one ``shard_map``).  The states come
back as this rank's ``(1, B, H, ...)`` slice: the global final state is
the last rank's.
"""

from __future__ import annotations

import torch

from ..core.distributed import ppermute
from ..kernels import ops as kops


def _prefix_chain(s_loc: torch.Tensor, ltot_exp: torch.Tensor, mesh, axes) -> torch.Tensor:
    """Exact prefix of recurrence states across ranks.

    s_loc:    local carry with leading (B, H, ...) dims
    ltot_exp: this rank's total decay, broadcastable to s_loc
    Returns r = sum_{j < i} (prod_{j < l < i} D_l) s_j   on rank i.
    """
    n = mesh.axis_size(axes)
    perm = mesh.axis_perm(axes, [(i, i + 1) for i in range(n - 1)])  # to the next; first gets 0
    r = torch.zeros_like(s_loc)
    for _ in range(n - 1):
        r = ppermute(r * ltot_exp + s_loc, perm, mesh)
    return r


# ---------------------------------------------------------------------------
# Mamba-2 SSD (scalar per-head decay)
# ---------------------------------------------------------------------------


def sp_ssd_local(x, b, c, loga, mesh, axes=("data",), chunk: int = 64):
    """One rank's part (T is split over ``axes``).

    x: (B, H, T_loc, P), b/c: (B, H, T_loc, N), loga: (B, H, T_loc).
    Returns (y, state_out): state_out (1, B, H, N, P) on the *last* rank is
    the global final state.
    """
    bsz, h, t_loc, pd = x.shape
    n_state = b.shape[-1]
    zeros = torch.zeros((bsz, h, n_state, pd), dtype=torch.float32, device=x.device)
    y0, s_loc = kops.ssd(x, b, c, loga, zeros, chunk=min(chunk, t_loc))

    ltot = loga.sum(dim=2)  # (B, H) total log-decay of this rank's slice
    d_exp = torch.exp(ltot)[..., None, None]  # broadcast to (B, H, N, P)
    r = _prefix_chain(s_loc, d_exp, mesh, axes)  # incoming state of this rank

    # fold the incoming state in: y_t += exp(Lcum_t) * (c_t @ r)
    lcum = torch.cumsum(loga, dim=2)
    y_corr = torch.exp(lcum)[..., None] * torch.einsum("bhtn,bhnp->bhtp", c.float(), r)
    s_out = r * d_exp + s_loc
    return y0 + y_corr, s_out[None]


def sp_ssd(mesh, seq_axes=("data",)):
    """Sequence-parallel SSD on ``mesh``: a callable ``(x, b, c, loga) ->
    (y, states)`` on this rank's T slice; ``states`` (1, B, H, N, P) is this
    rank's, and the last rank's is the global final state."""
    axes = tuple(seq_axes)

    def fn(x, b, c, loga):
        return sp_ssd_local(x, b, c, loga, mesh, axes)

    return fn


# ---------------------------------------------------------------------------
# RWKV6 WKV (per-channel decay; the state is (Dk, Dv) a head)
# ---------------------------------------------------------------------------


def sp_wkv6_local(r, k, v, logw, u, mesh, axes=("data",), chunk: int = 64):
    """One rank's WKV6.  r/k/v/logw: (B, H, T_loc, D); u: (H, D).

    The current-token bonus u is local (it applies to position t only), so
    only the running state crosses ranks.
    """
    bsz, h, t_loc, d = r.shape
    zeros = torch.zeros((bsz, h, d, d), dtype=torch.float32, device=r.device)
    o0, s_loc = kops.wkv6(r, k, v, logw, u, zeros, chunk=min(chunk, t_loc))

    ltot = logw.sum(dim=2)  # (B, H, D) per-channel total decay
    d_exp = torch.exp(ltot)[..., None]  # (B, H, Dk, 1) acts on the k dim
    rin = _prefix_chain(s_loc, d_exp, mesh, axes)

    # fold the incoming state in: o_t += (r_t * exp(Lprev_t)) @ r_in
    lcum = torch.cumsum(logw, dim=2)
    lprev = torch.cat([torch.zeros_like(lcum[:, :, :1]), lcum[:, :, :-1]], dim=2)
    o_corr = torch.einsum("bhtd,bhde->bhte", (r * torch.exp(lprev)).float(), rin)
    s_out = rin * d_exp + s_loc
    return o0 + o_corr, s_out[None]


def sp_wkv6(mesh, seq_axes=("data",)):
    """Sequence-parallel WKV6: a callable ``(r, k, v, logw, u) -> (o,
    states)`` on this rank's T slice; ``states`` (1, B, H, Dk, Dv) is this
    rank's, and the last rank's is the global final state."""
    axes = tuple(seq_axes)

    def fn(r, k, v, logw, u):
        return sp_wkv6_local(r, k, v, logw, u, mesh, axes)

    return fn
