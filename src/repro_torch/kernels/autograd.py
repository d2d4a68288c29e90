"""Gradients through the three model kernels: flash attention, WKV6, SSD.

Each is a ``torch.autograd.Function`` whose forward is the kernel wrapper
it is given (the CUDA kernel for CUDA tensors) and whose backward re-runs
that kernel's plain PyTorch version -- :func:`.ref.flash_attention_ref`,
:func:`.wkv.wkv6_plain`, :func:`.ssd.ssd_plain` -- on detached copies of
the saved inputs under ``torch.enable_grad()`` and returns
``torch.autograd.grad`` of it against the incoming gradients.

That recompute is the definition of the gradient, not a fallback: the JAX
package has no backward kernel either (nothing in it defines a custom
VJP; its gradients are autodiff of the kernels' jnp formulation), so the
gradient here is that of the plain version at the kernel's inputs, and
the forward value is the kernel's.  The forward never runs the plain
version on the card.  Each call's recompute lives only inside its own
backward, so no (B, H, T, T) tensor outlives one layer's backward.

:mod:`.ops` sends a call here when grad mode is on and an operand on the
card requires grad; on the CPU, autograd differentiates the plain
versions directly.  The raw wrappers keep refusing operands that require
grad (:func:`._launch.check_no_grad`): inside ``Function.forward`` grad
mode is off.  ``backward_calls`` counts the recomputes by kernel.

bfloat16 scan tensors (``scan_dtype="bfloat16"``) take the same path: the
forward runs the kernels' bfloat16 instantiation, the recompute casts
them to float32 as the plain version does, and the gradients come back
in the inputs' dtypes (bfloat16 for r, k, v, log w and x, B, C; float32
for u, log a and the state).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .ref import flash_attention_ref
from .ssd import ssd_plain
from .wkv import wkv6_plain

backward_calls = {"flash": 0, "wkv6": 0, "ssd": 0}


def on_card_with_grad(*tensors: torch.Tensor) -> bool:
    """Whether a call must go through its Function: grad mode is on and an
    operand on the card requires grad."""
    return (torch.is_grad_enabled() and tensors[0].device.type == "cuda"
            and any(t.requires_grad for t in tensors))


def _recompute_grads(plain: Callable, saved: tuple, needs: tuple, grads_out: tuple):
    """Gradients of ``plain(*saved)`` (a tensor or a tuple of them) with
    respect to the saved inputs marked in ``needs``, against
    ``grads_out`` (None where an output has no incoming gradient)."""
    with torch.enable_grad():
        inputs = [t.detach().requires_grad_(n) for t, n in zip(saved, needs)]
        outs = plain(*inputs)
        outs = outs if isinstance(outs, tuple) else (outs,)
        pairs = [(o, g) for o, g in zip(outs, grads_out) if g is not None]
        wanted = [t for t in inputs if t.requires_grad]
        if not (pairs and wanted):
            return [None] * len(inputs)
        got = iter(torch.autograd.grad([o for o, _ in pairs], wanted, [g for _, g in pairs],
                                       allow_unused=True))
    return [next(got) if t.requires_grad else None for t in inputs]


class FlashAttention(torch.autograd.Function):
    """``kernel(q, k, v, causal, window)``; the gradient of
    :func:`.ref.flash_attention_ref` (GQA's K and V gradients summed over
    each query group by its reshape), in the inputs' dtype."""

    @staticmethod
    def forward(ctx, kernel: Callable, q, k, v, causal: bool, window: Optional[int]):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        return kernel(q, k, v, causal, window)

    @staticmethod
    def backward(ctx, grad_o):
        backward_calls["flash"] += 1
        plain = lambda q, k, v: flash_attention_ref(q, k, v, ctx.causal, ctx.window)  # noqa: E731
        dq, dk, dv = _recompute_grads(plain, ctx.saved_tensors, ctx.needs_input_grad[1:4],
                                      (grad_o,))
        return None, dq, dk, dv, None, None


class WKV6(torch.autograd.Function):
    """``kernel(r, k, v, logw, u, state, chunk)`` on flattened (batch x
    head) rows -> (o, state_out); the gradient of :func:`.wkv.wkv6_plain`.
    ``u`` is per row (the caller expands it over the batch, so autograd
    sums its gradient through the ``expand``).  An output with no incoming
    gradient (the final state, in a loss) adds no term."""

    @staticmethod
    def forward(ctx, kernel: Callable, r, k, v, logw, u, state, chunk: int):
        ctx.save_for_backward(r, k, v, logw, u, state)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return kernel(r, k, v, logw, u, state, chunk)

    @staticmethod
    def backward(ctx, grad_o, grad_state):
        backward_calls["wkv6"] += 1
        plain = lambda *a: wkv6_plain(*a, ctx.chunk)  # noqa: E731
        grads = _recompute_grads(plain, ctx.saved_tensors, ctx.needs_input_grad[1:7],
                                 (grad_o, grad_state))
        return (None, *grads, None)


class SSD(torch.autograd.Function):
    """``kernel(x, b, c, loga, state, chunk, hshare)`` on flattened rows ->
    (y, state_out); the gradient of :func:`.ssd.ssd_plain`.  ``b`` and
    ``c`` are the kernel's: one row for each ``hshare`` consecutive rows
    of ``x``, so their gradient is summed over the rows that share them.
    An output with no incoming gradient adds no term."""

    @staticmethod
    def forward(ctx, kernel: Callable, x, b, c, loga, state, chunk: int, hshare: int):
        ctx.save_for_backward(x, b, c, loga, state)
        ctx.chunk, ctx.hshare = chunk, hshare
        ctx.set_materialize_grads(False)
        return kernel(x, b, c, loga, state, chunk, hshare)

    @staticmethod
    def backward(ctx, grad_y, grad_state):
        backward_calls["ssd"] += 1
        plain = lambda *a: ssd_plain(*a, ctx.chunk, ctx.hshare)  # noqa: E731
        grads = _recompute_grads(plain, ctx.saved_tensors, ctx.needs_input_grad[1:6],
                                 (grad_y, grad_state))
        return (None, *grads, None, None)
