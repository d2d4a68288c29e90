"""The port's ServeEngine against the JAX package's, token for token.

Reduced RWKV6, Zamba2, starcoder2 (a dense transformer with a sliding
window of 32, so a long queue wraps its ring-buffer KV cache),
deepseek-moe, phi-3-vision and whisper (float32), the JAX parameters
carried across by ``params_from_jax``, the same submissions to both
engines: every tick's logits must agree, and so must every generated
token, through queues that refill slots.  The port must reproduce three
behaviours of the reference: a refilled slot keeps the state its previous
request left (ROADMAP R5); whisper's cross-attention cache stays at zero,
since the engine never fills it (R8); and a MoE decode step routes the
slots as one group, so at three slots deepseek-moe-reduced's capacity is
one slot an expert and a request's tokens depend on its neighbours (R9).

Tolerance: rtol = atol = 2e-4 on each tick's logits (the same float32
model, sums in another order).  Where the two engines' greedy tokens
differ, the JAX logits' top-2 margin at that tick must be within that
tolerance (a near-tie), and the streams are not compared after it.
"""

import jax
import numpy as np
import pytest

from repro.configs import get_config as jax_config
from repro.models import get_family as jax_family
from repro.serve import Request as JaxRequest
from repro.serve import ServeEngine as JaxEngine
from repro_torch.configs import get_config
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import Request, ServeEngine

TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(scope="module", params=["rwkv6-1.6b", "zamba2-2.7b", "starcoder2-15b",
                                        "deepseek-moe-16b", "phi-3-vision-4.2b",
                                        "whisper-medium"])
def models(request):
    jc = jax_config(request.param, reduced=True)
    tc = get_config(request.param, reduced=True)
    jp = jax_family(jc).init(jc, jax.random.PRNGKey(0))
    return (jc, jp), (tc, params_from_jax(tc, jax.tree.map(np.asarray, jp), device="cpu"))


def _engines(models, slots, max_len=64):
    (jc, jp), (tc, tp) = models
    je = JaxEngine(jc, jp, slots=slots, max_len=max_len)
    te = ServeEngine(tc, tp, slots=slots, max_len=max_len, device="cpu")
    j_logits, t_logits = [], []
    j_step = je._step

    def j_spy(p, c, t):
        out = j_step(p, c, t)
        j_logits.append(np.asarray(out[0]))
        return out

    je._step = j_spy
    fam = te.fam

    class Spy:
        def __getattr__(self, name):
            return getattr(fam, name)

        def decode_step(self, *args):
            out = fam.decode_step(*args)
            t_logits.append(out[0].numpy().copy())
            return out

    te.fam = Spy()
    return je, te, j_logits, t_logits


def _serve(models, slots, prompts, max_new):
    je, te, j_logits, t_logits = _engines(models, slots)
    jr = [JaxRequest(rid=i, prompt=p, max_new_tokens=m) for i, (p, m) in
          enumerate(zip(prompts, max_new))]
    tr = [Request(rid=i, prompt=p, max_new_tokens=m) for i, (p, m) in
          enumerate(zip(prompts, max_new))]
    for r in jr:
        je.submit(r)
    for r in tr:
        te.submit(r)
    ticks = (je.run_until_drained(), te.run_until_drained())
    return jr, tr, ticks, j_logits, t_logits


def _compare(jr, tr, ticks, j_logits, t_logits):
    """Logits tick by tick; tokens equal unless a near-tie explains the first
    difference (then nothing after it is compared)."""
    for tick, (jl, tl) in enumerate(zip(j_logits, t_logits)):
        np.testing.assert_allclose(tl, jl, err_msg=f"tick {tick}", **TOL)
        j_tok, t_tok = jl.argmax(-1), tl.argmax(-1)
        if (j_tok != t_tok).any():
            top2 = np.sort(jl, axis=-1)[:, -2:]
            margin = (top2[:, 1] - top2[:, 0])[j_tok != t_tok]
            assert (margin <= TOL["atol"] + TOL["rtol"] * np.abs(top2[:, 1]).max()).all()
            return
    assert ticks[0] == ticks[1]
    assert [r.out for r in tr] == [r.out for r in jr]
    assert all(r.done for r in tr)


def test_one_slot_queue_matches_jax(models):
    prompts = [[1, 2, 3], [2, 2, 3], [5, 6, 7, 8], [9]]
    jr, tr, ticks, jl, tl = _serve(models, 1, prompts, [4, 4, 3, 5])
    _compare(jr, tr, ticks, jl, tl)
    assert [len(r.out) for r in tr] == [4, 4, 3, 5]


def test_refilled_slots_match_jax(models):
    rng = np.random.default_rng(0)
    vocab = models[1][0].vocab
    prompts = [rng.integers(0, vocab, size=n).tolist() for n in (3, 7, 1, 5, 4, 2, 6)]
    jr, tr, ticks, jl, tl = _serve(models, 3, prompts, [5, 2, 6, 3, 4, 1, 2])
    _compare(jr, tr, ticks, jl, tl)


def test_refilled_slot_keeps_the_previous_state_like_jax(models):
    """R5: [2, 2, 3] served after another request in a one-slot engine
    continues from that request's state; served alone it does not.  Both
    packages give the same two streams."""
    after = _serve(models, 1, [[7, 1], [2, 2, 3]], [3, 4])
    alone = _serve(models, 1, [[2, 2, 3]], [4])
    _compare(*after)
    _compare(*alone)
    assert after[1][1].out != alone[1][0].out


def test_long_queue_matches_jax(models):
    """45 ticks of one slot: past starcoder2-reduced's window of 32, so the
    ring buffer of its KV cache wraps at the shared length."""
    rng = np.random.default_rng(1)
    vocab = models[1][0].vocab
    prompts = [rng.integers(0, vocab, size=n).tolist() for n in (10, 12, 8)]
    jr, tr, ticks, jl, tl = _serve(models, 1, prompts, [6, 6, 6])
    assert ticks[1] == 45  # a request takes len(prompt) + max_new - 1 ticks
    _compare(jr, tr, ticks, jl, tl)


def test_whisper_cross_cache_stays_zero_like_jax():
    """R8: neither engine fills whisper's cross-attention cache, so every
    request attends to zeros there; both caches end with it at zero."""
    jc = jax_config("whisper-medium", reduced=True)
    tc = get_config("whisper-medium", reduced=True)
    jp = jax_family(jc).init(jc, jax.random.PRNGKey(0))
    models = (jc, jp), (tc, params_from_jax(tc, jax.tree.map(np.asarray, jp), device="cpu"))
    je, te, jl, tl = _engines(models, 2)
    for i, p in enumerate([[1, 2, 3], [4, 5]]):
        je.submit(JaxRequest(rid=i, prompt=p, max_new_tokens=3))
        te.submit(Request(rid=i, prompt=p, max_new_tokens=3))
    je.run_until_drained()
    te.run_until_drained()
    for name in ("cross_k", "cross_v"):
        assert not np.asarray(je.cache[name]).any() and not te.cache[name].any()
    np.testing.assert_allclose(tl[-1], jl[-1], **TOL)
