"""Every family's loss and its gradients against the JAX package's.

One reduced configuration a family (float32): stablelm (dense),
starcoder2 (sliding window), deepseek-moe-16b (router aux loss, shared
experts), phi-3-vision (patches ahead of the text), rwkv6, zamba2 (shared
B and C of the SSD scan, the shared attention block) and whisper (encoder
and decoder).  The JAX parameters are carried across by
``params_from_jax``; ``jax.value_and_grad(fam.loss)`` against the port's
``loss(...).backward()``, each gradient mapped back by ``params_to_jax``.

Then the three kernels alone: autograd of the plain versions behind
``ops.wkv6``, ``ops.ssd`` (shared and per-head B, C) and
``flash_attention_ref`` (causal, GQA, windowed, bidirectional, Tq != Tk)
against ``jax.grad`` of ``repro.kernels.ref.wkv6_chunked_ref``,
``ssd_chunked_ref`` and ``repro.models.layers.flash_attention``; the
autograd Functions of ``repro_torch.kernels.autograd`` on CPU tensors (the
wrapper runs the plain version there) against autograd of the plain
version, and ``torch.autograd.gradcheck`` of each in float64.

Tolerances: the loss within 1e-5 relative; each gradient leaf within
1e-4 of that leaf's largest magnitude (the same float32 model with its
sums in another order: the differences seen are ~2e-5 at most, on
RWKV6's decay LoRA).  The kernel gradients the same, against the largest
magnitude of each input's gradient.  The Functions against the plain
autograd: exactly equal (one function, differentiated twice).

The WKV cases keep the decay mild (log w in [-0.5, -0.01]): under strong
decay the JAX package's ``wkv6_chunked_ref`` returns NaN (ROADMAP R6),
where the port masks before the exponential.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.kernels import ref as jref
from repro.models import get_family as jax_family
from repro.models.layers import flash_attention as jax_flash
from repro_torch.configs import get_config
from repro_torch.kernels import autograd as kgrad
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attn import flash_attention as flash_wrapper
from repro_torch.kernels.ref import flash_attention_ref
from repro_torch.kernels.ssd import ssd as ssd_wrapper
from repro_torch.kernels.ssd import ssd_plain
from repro_torch.kernels.wkv import wkv6 as wkv_wrapper
from repro_torch.kernels.wkv import wkv6_plain
from repro_torch.models import get_family
from repro_torch.models.convert import params_from_jax, params_to_jax

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4  # of each leaf's largest magnitude
ARCHS = ["stablelm-1.6b", "starcoder2-15b", "deepseek-moe-16b", "phi-3-vision-4.2b",
         "rwkv6-1.6b", "zamba2-2.7b", "whisper-medium"]
B, T = 2, 64


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, size=(B, T)).astype(np.int32)}
    if cfg.n_patches:
        batch["patches"] = rng.standard_normal((B, cfg.n_patches, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal((B, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return batch


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, np.asarray(tree)


def assert_trees_close(want: dict, got: dict, tol: float = GRAD_TOL):
    """Every leaf of ``want`` (JAX) against the same path in ``got``:
    within ``tol`` of the leaf's largest magnitude; the same leaves."""
    want_paths = {p for p, _ in _leaves(want)}
    assert want_paths == {p for p, _ in _leaves(got)}
    for path, a in _leaves(want):
        b = got
        for k in path:
            b = b[k]
        assert a.shape == b.shape, path
        scale = max(float(np.abs(a).max()), 1e-30)
        err = float(np.abs(a - b).max())
        assert err <= tol * scale, f"{'/'.join(path)}: {err:.3e} > {tol} x {scale:.3e}"


@pytest.fixture(scope="module", params=ARCHS)
def loss_and_grads(request):
    """(JAX loss, JAX gradient tree, JAX metrics), the port's model (its
    parameters' .grad filled by backward), loss and metrics, the same
    parameters and batch in both."""
    name = request.param
    jc, tc = jax_config(name, reduced=True), get_config(name, reduced=True)
    jf = jax_family(jc)
    jp = jf.init(jc, jax.random.PRNGKey(0))
    batch = _batch(jc, seed=len(name))
    (jl, jm), jg = jax.jit(jax.value_and_grad(functools.partial(jf.loss, jc), has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    model = params_from_jax(tc, jax.tree.map(np.asarray, jp), device="cpu").requires_grad_(True)
    tl, tm = get_family(tc).loss(tc, model, {k: torch.tensor(v) for k, v in batch.items()})
    tl.backward()
    return (name, float(jl), jax.tree.map(np.asarray, jg), {k: float(v) for k, v in jm.items()},
            model, float(tl.detach()), {k: float(v.detach()) for k, v in tm.items()})


def test_loss_matches_jax(loss_and_grads):
    name, jl, _, jm, _, tl, tm = loss_and_grads
    assert np.isfinite(tl)
    assert abs(tl - jl) <= LOSS_RTOL * abs(jl)
    assert set(tm) == set(jm) == {"nll", "aux"}
    for k in jm:
        assert abs(tm[k] - jm[k]) <= LOSS_RTOL * max(abs(jm[k]), 1.0), (name, k)
    if "moe" in name:
        assert tm["aux"] > 0


def test_every_gradient_leaf_matches_jax(loss_and_grads):
    _, _, jg, _, model, _, _ = loss_and_grads
    assert_trees_close(jg, params_to_jax(model, {n: p.grad for n, p in model.named_parameters()}))


def test_moe_aux_loss_carries_gradient_into_every_router():
    cfg = get_config("deepseek-moe-16b", reduced=True)
    fam = get_family(cfg)
    model = fam.init(cfg, device="cpu").requires_grad_(True)
    _, metrics = fam.loss(cfg, model, {"tokens": torch.tensor(_batch(cfg, 0)["tokens"])})
    metrics["aux"].backward()
    for blk in model["blocks"]:
        assert blk["moe"]["router"].grad is not None
        assert float(blk["moe"]["router"].grad.abs().max()) > 0
    # the last layer's experts feed no router: the aux loss leaves them alone
    assert model["blocks"][-1]["moe"]["experts"]["wi"].grad is None


def test_params_to_jax_inverts_params_from_jax():
    for name in ("stablelm-1.6b", "zamba2-2.7b", "whisper-medium"):
        jc, tc = jax_config(name, reduced=True), get_config(name, reduced=True)
        jp = jax.tree.map(np.asarray, jax_family(jc).init(jc, jax.random.PRNGKey(1)))
        back = params_to_jax(params_from_jax(tc, jp, device="cpu"))
        assert_trees_close(jp, back, tol=0.0)
        model = params_from_jax(tc, jp, device="cpu")
        doubled = {n: 2 * p for n, p in model.named_parameters()}
        assert_trees_close(jax.tree.map(lambda a: 2 * a, jp), params_to_jax(model, doubled),
                           tol=0.0)


def test_init_keeps_parameters_frozen_until_asked():
    for name in ("stablelm-1.6b", "rwkv6-1.6b", "zamba2-2.7b", "whisper-medium"):
        cfg = get_config(name, reduced=True)
        model = get_family(cfg).init(cfg, device="cpu")
        assert not any(p.requires_grad for p in model.parameters())
        model.requires_grad_(True)
        assert all(p.requires_grad for p in model.parameters())


# ---------------------------------------------------------------------------
# The three kernels alone
# ---------------------------------------------------------------------------


def _weights(rng, *shapes):
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _torch_grads(fn, arrays):
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    fn(*ts).backward()
    return [t.grad.numpy() for t in ts]


def _assert_grads_close(want, got):
    for i, (a, b) in enumerate(zip(want, got)):
        a = np.asarray(a)
        assert a.shape == b.shape, i
        assert float(np.abs(a - b).max()) <= GRAD_TOL * max(float(np.abs(a).max()), 1e-30), i


def test_wkv6_gradients_match_jax():
    bsz, h, t, d, chunk = 2, 3, 32, 8, 8
    rng = np.random.default_rng(0)
    r, k, v = _weights(rng, *[(bsz, h, t, d)] * 3)
    logw = -rng.uniform(0.01, 0.5, size=(bsz, h, t, d)).astype(np.float32)
    u = rng.standard_normal((h, d)).astype(np.float32) * 0.5
    s0 = rng.standard_normal((bsz, h, d, d)).astype(np.float32) * 0.1
    wo, ws = _weights(rng, (bsz, h, t, d), (bsz, h, d, d))

    def jloss(*a):
        o, s = jref.wkv6_chunked_ref(*a, chunk)
        return jnp.sum(o * wo) + jnp.sum(s * ws)

    def tloss(*a):
        o, s = ops.wkv6(*a, chunk=chunk)
        return (o * torch.tensor(wo)).sum() + (s * torch.tensor(ws)).sum()

    args = (r, k, v, logw, u, s0)
    want = jax.grad(jloss, argnums=tuple(range(6)))(*map(jnp.asarray, args))
    _assert_grads_close(want, _torch_grads(tloss, args))


@pytest.mark.parametrize("shared", [True, False])
def test_ssd_gradients_match_jax(shared):
    bsz, h, t, n, p, chunk = 2, 4, 32, 6, 5, 8
    rng = np.random.default_rng(1)
    x = rng.standard_normal((bsz, h, t, p)).astype(np.float32)
    bc_shape = (bsz, t, n) if shared else (bsz, h, t, n)
    b, c = _weights(rng, bc_shape, bc_shape)
    loga = -rng.uniform(0.01, 1.0, size=(bsz, h, t)).astype(np.float32)
    s0 = rng.standard_normal((bsz, h, n, p)).astype(np.float32) * 0.1
    wy, ws = _weights(rng, (bsz, h, t, p), (bsz, h, n, p))

    def heads_j(a):
        return jnp.broadcast_to(a[:, None], (bsz, h, t, n)) if shared else a

    def heads_t(a):
        return a[:, None].expand(bsz, h, t, n) if shared else a

    def jloss(x, b, c, loga, s0):
        y, s = jref.ssd_chunked_ref(x, heads_j(b), heads_j(c), loga, s0, chunk)
        return jnp.sum(y * wy) + jnp.sum(s * ws)

    def tloss(x, b, c, loga, s0):
        y, s = ops.ssd(x, heads_t(b), heads_t(c), loga, s0, chunk=chunk)
        return (y * torch.tensor(wy)).sum() + (s * torch.tensor(ws)).sum()

    args = (x, b, c, loga, s0)
    want = jax.grad(jloss, argnums=tuple(range(5)))(*map(jnp.asarray, args))
    _assert_grads_close(want, _torch_grads(tloss, args))


# (B, Hq, Hk, Tq, Tk, D, causal, window)
FLASH_CASES = [
    (2, 4, 2, 80, 80, 16, True, None),  # causal GQA, a ragged second tile
    (1, 4, 1, 96, 96, 8, True, 24),  # windowed, a window under one tile
    (2, 2, 2, 70, 70, 16, False, None),  # bidirectional
    (1, 4, 2, 40, 100, 16, False, None),  # cross-attention, Tq != Tk
]


@pytest.mark.parametrize("b,hq,hk,tq,tk,d,causal,window", FLASH_CASES)
def test_flash_attention_gradients_match_jax(b, hq, hk, tq, tk, d, causal, window):
    rng = np.random.default_rng(tq + tk)
    q, k, v, w = _weights(rng, (b, hq, tq, d), (b, hk, tk, d), (b, hk, tk, d), (b, hq, tq, d))

    def jloss(q, k, v):
        return jnp.sum(jax_flash(q, k, v, causal=causal, window=window, block_k=32) * w)

    def tloss(q, k, v):
        return (flash_attention_ref(q, k, v, causal, window) * torch.tensor(w)).sum()

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    _assert_grads_close(want, _torch_grads(tloss, (q, k, v)))


# ---------------------------------------------------------------------------
# The autograd Functions on CPU tensors: the wiring
# ---------------------------------------------------------------------------


def _grads(out_fn, inputs):
    xs = [x.detach().clone().requires_grad_(True) for x in inputs]
    out_fn(*xs).backward()
    return [x.grad for x in xs]


@pytest.mark.parametrize("b,hq,hk,tq,tk,d,causal,window", FLASH_CASES)
def test_flash_function_gives_the_plain_gradient(b, hq, hk, tq, tk, d, causal, window):
    g = torch.Generator().manual_seed(tq)
    qkv = [torch.randn(b, h, t, d, generator=g) for h, t in ((hq, tq), (hk, tk), (hk, tk))]
    w = torch.randn(b, hq, tq, d, generator=g)
    before = kgrad.backward_calls["flash"]
    via = _grads(lambda *a: (kgrad.FlashAttention.apply(flash_wrapper, *a, causal, window) * w)
                 .sum(), qkv)
    assert kgrad.backward_calls["flash"] == before + 1
    plain = _grads(lambda *a: (flash_attention_ref(*a, causal, window) * w).sum(), qkv)
    for x, y in zip(via, plain):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    # only k needs a gradient: the others get None
    q, k, v = (x.detach() for x in qkv)
    k.requires_grad_(True)
    (kgrad.FlashAttention.apply(flash_wrapper, q, k, v, causal, window) * w).sum().backward()
    torch.testing.assert_close(k.grad, plain[1], rtol=0, atol=0)


def test_wkv6_function_sums_u_over_the_batch_and_takes_no_state_gradient():
    bsz, h, t, d, chunk = 3, 2, 16, 4, 8
    g = torch.Generator().manual_seed(0)
    r, k, v = (torch.randn(bsz * h, t, d, generator=g) for _ in range(3))
    logw = -torch.rand(bsz * h, t, d, generator=g) * 0.5
    u = torch.randn(h, d, generator=g)
    s0 = torch.randn(bsz * h, d, d, generator=g) * 0.1
    w = torch.randn(bsz * h, t, d, generator=g)

    def loss(fn, r, k, v, logw, u, s0):
        u_full = u.expand(bsz, h, d).reshape(bsz * h, d).contiguous()
        o, _ = fn(r, k, v, logw, u_full, s0)  # the final state feeds nothing
        return (o * w).sum()

    via = _grads(lambda *a: loss(lambda *x: kgrad.WKV6.apply(wkv_wrapper, *x, chunk), *a),
                 (r, k, v, logw, u, s0))
    plain = _grads(lambda *a: loss(lambda *x: wkv6_plain(*x, chunk), *a), (r, k, v, logw, u, s0))
    assert via[4].shape == (h, d)
    for x, y in zip(via, plain):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_ssd_function_sums_shared_b_and_c_over_the_heads():
    bsz, h, t, n, p, chunk = 2, 3, 16, 4, 5, 8
    g = torch.Generator().manual_seed(1)
    x = torch.randn(bsz * h, t, p, generator=g)
    b, c = (torch.randn(bsz, t, n, generator=g) for _ in range(2))
    loga = -torch.rand(bsz * h, t, generator=g)
    s0 = torch.randn(bsz * h, n, p, generator=g) * 0.1
    wy, ws = torch.randn(bsz * h, t, p, generator=g), torch.randn(bsz * h, n, p, generator=g)

    def loss(fn, *a):
        y, s = fn(*a)
        return (y * wy).sum() + (s * ws).sum()

    via = _grads(lambda *a: loss(lambda *z: kgrad.SSD.apply(ssd_wrapper, *z, chunk, h), *a),
                 (x, b, c, loga, s0))
    plain = _grads(lambda *a: loss(lambda *z: ssd_plain(*z, chunk, h), *a), (x, b, c, loga, s0))
    assert via[1].shape == (bsz, t, n)
    for u, w in zip(via, plain):
        torch.testing.assert_close(u, w, rtol=0, atol=0)
    # the heads' sum: the same gradient as B expanded to every head
    b_heads = b.repeat_interleave(h, dim=0)
    per_head = _grads(lambda bb: loss(lambda *z: ssd_plain(*z, chunk, 1), x, bb, c.repeat_interleave(
        h, dim=0), loga, s0), (b_heads,))[0]
    torch.testing.assert_close(via[1], per_head.reshape(bsz, h, t, n).sum(1),
                               rtol=1e-5, atol=1e-5)


def test_functions_pass_gradcheck_in_float64():
    g = torch.Generator().manual_seed(2)
    dd = dict(dtype=torch.float64)

    def rnd(*s, scale=1.0):
        return (torch.randn(*s, generator=g, **dd) * scale).requires_grad_(True)

    q, k, v = rnd(1, 2, 5, 4), rnd(1, 1, 5, 4), rnd(1, 1, 5, 4)
    assert torch.autograd.gradcheck(
        lambda q, k, v: kgrad.FlashAttention.apply(flash_wrapper, q, k, v, True, 3), (q, k, v))
    r, kk, vv = rnd(2, 4, 3), rnd(2, 4, 3), rnd(2, 4, 3)
    logw = (-torch.rand(2, 4, 3, generator=g, **dd) * 0.5).requires_grad_(True)
    u, s0 = rnd(2, 3), rnd(2, 3, 3, scale=0.1)
    assert torch.autograd.gradcheck(
        lambda *a: kgrad.WKV6.apply(wkv_wrapper, *a, 2), (r, kk, vv, logw, u, s0))
    x, b, c = rnd(4, 4, 2), rnd(2, 4, 3), rnd(2, 4, 3)
    loga = (-torch.rand(4, 4, generator=g, **dd)).requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda *a: kgrad.SSD.apply(ssd_wrapper, *a, 2, 2), (x, b, c, loga, rnd(4, 3, 2)))


def test_cpu_entry_points_differentiate_the_plain_versions_directly(monkeypatch):
    """On the CPU the entry points take no Function: autograd runs through
    the plain version itself."""
    def no_function(*a, **kw):
        raise AssertionError("a CPU call went through an autograd Function")

    for fn in (kgrad.FlashAttention, kgrad.WKV6, kgrad.SSD):
        monkeypatch.setattr(fn, "apply", no_function)
    q = torch.randn(1, 2, 8, 8, requires_grad=True)
    ops.flash_attention(q, q, q).sum().backward()
    assert q.grad is not None
    r = torch.randn(1, 2, 8, 4, requires_grad=True)
    o, _ = ops.wkv6(r, r, r, -torch.rand(1, 2, 8, 4), torch.randn(2, 4), torch.zeros(1, 2, 4, 4),
                    chunk=4)
    o.sum().backward()
    y, _ = ops.ssd(torch.randn(1, 2, 8, 3), r, r, -torch.rand(1, 2, 8), torch.zeros(1, 2, 4, 3),
                   chunk=4)
    y.sum().backward()
    assert r.grad is not None
