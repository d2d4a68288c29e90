"""The port's dense transformers against the JAX package.

Every reduced dense architecture (stablelm, phi3-mini, minitron,
starcoder2; float32), the JAX parameters carried across by
``params_from_jax``: ``forward`` at T=128 (the port's attention through
``ops.flash_attention``, the flash kernel's entry point; the JAX package's
jnp path, ``kernel_impl=None``) and at the ragged T=40 (the port through
the same entry point; the JAX package's chunked attention, as its Pallas
kernel takes only multiples of 128), ``forward`` with prepended patch
embeddings, ``decode_step``
token by token for 48 tokens -- past starcoder2-reduced's window of 32, so
its ring buffer wraps -- and tied embeddings.  The port's own ``init``
against the JAX init's tree and scales, and the configurations against
``repro.configs``.  The MoE and VLM configurations are in
``test_torch_moe.py``.

Tolerance: rtol = atol = 2e-4 on logits and caches, as in
``test_torch_lm.py`` -- the same float32 model with the sums taken in
another order (the differences seen are < 1e-6 on logits of size ~0.7).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import get_family as jax_family
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.models import get_family, transformer
from repro_torch.models.convert import params_from_jax

TOL = dict(rtol=2e-4, atol=2e-4)
DENSE = ["stablelm-1.6b", "phi3-mini-3.8b", "minitron-8b", "starcoder2-15b"]


def _pair(jc, tc):
    jf = jax_family(jc)
    jp = jf.init(jc, jax.random.PRNGKey(0))
    return (jc, jf, jp), (tc, get_family(tc), params_from_jax(tc, jax.tree.map(np.asarray, jp),
                                                              device="cpu"))


@pytest.fixture(scope="module", params=DENSE)
def pair(request):
    """(JAX cfg, family, params) and (port cfg, family, params) of one
    reduced dense architecture, the same parameters in both."""
    return _pair(jax_config(request.param, reduced=True), get_config(request.param, reduced=True))


def _tokens(cfg, b, t, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, size=(b, t)).astype(np.int32)


def test_dense_configs_match_the_jax_registry():
    for name in DENSE:
        for reduced in (False, True):
            mine = get_config(name, reduced=reduced)
            theirs = jax_config(name, reduced=reduced)
            assert dataclasses.asdict(mine) == {f: getattr(theirs, f)
                                                for f in dataclasses.asdict(mine)}
            assert mine.params_count() == theirs.params_count()
            assert get_family(mine) is transformer
    full = get_config("minitron-8b")
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads, full.head_dim,
            full.d_ff, full.vocab_padded) == (32, 4096, 32, 8, 128, 16_384, 256_000)


@pytest.mark.parametrize("t", [128, 40])
def test_forward_matches_jax(pair, t, monkeypatch):
    (jc, jf, jp), (tc, tf, tp) = pair
    calls = []
    flash = ops.flash_attention
    monkeypatch.setattr(ops, "flash_attention", lambda *a, **kw: calls.append(1) or flash(*a, **kw))
    toks = _tokens(jc, 2, t, seed=t)
    j_logits, j_aux = jf.forward(jc, jp, toks)
    t_logits, t_aux = tf.forward(tc, tp, torch.tensor(toks, dtype=torch.long))
    assert t_logits.shape == (2, t, tc.vocab_padded)
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), **TOL)
    assert float(t_aux) == float(j_aux) == 0.0 and t_aux.dtype == torch.float32
    # the flash entry point at every length, once a layer
    assert len(calls) == tc.n_layers
    torch.testing.assert_close(tp(torch.tensor(toks, dtype=torch.long))[0], t_logits)  # nn.Module


def test_forward_with_patches_matches_jax(pair):
    (jc, jf, jp), (tc, tf, tp) = pair
    toks = _tokens(jc, 2, 24, seed=5)
    patches = np.random.default_rng(6).normal(size=(2, 8, jc.d_model)).astype(np.float32)
    j_logits, _ = jf.forward(jc, jp, toks, patches)
    t_logits, _ = tf.forward(tc, tp, torch.tensor(toks, dtype=torch.long), torch.tensor(patches))
    assert t_logits.shape == (2, 32, tc.vocab_padded)
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), **TOL)


def test_decode_steps_match_jax_past_the_window(pair):
    (jc, jf, jp), (tc, tf, tp) = pair
    toks = _tokens(jc, 2, 48, seed=2)
    j_cache = jf.init_cache(jc, 2, 64)
    t_cache = tf.init_cache(tc, 2, 64, device="cpu")
    assert t_cache["k"].shape == (tc.n_layers, 2, tc.n_kv_heads, min(64, tc.window or 64),
                                  tc.head_dim)
    step = jax.jit(lambda p, c, t: jf.decode_step(jc, p, c, t))
    for i in range(toks.shape[1]):
        j_logits, j_cache = step(jp, j_cache, toks[:, i:i + 1])
        t_logits, t_cache = tf.decode_step(tc, tp, t_cache, torch.tensor(toks[:, i:i + 1],
                                                                        dtype=torch.long))
        assert t_logits.shape == (2, tc.vocab)
        np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), err_msg=f"token {i}",
                                   **TOL)
    assert int(t_cache["len"]) == int(j_cache["len"]) == 48
    for name in ("k", "v"):
        np.testing.assert_allclose(t_cache[name].numpy(), np.asarray(j_cache[name]), **TOL)


def test_decode_reproduces_the_forward(pair):
    """The port against itself: 48 decode steps equal a 48-token forward
    (under starcoder2's window the ring buffer has wrapped)."""
    _, (tc, tf, tp) = pair
    toks = torch.tensor(_tokens(tc, 2, 48, seed=3), dtype=torch.long)
    full, _ = tf.forward(tc, tp, toks)
    cache = tf.init_cache(tc, 2, 48, device="cpu")
    for i in range(48):
        logits, cache = tf.decode_step(tc, tp, cache, toks[:, i:i + 1])
        torch.testing.assert_close(logits, full[:, i, : tc.vocab], **TOL)


def test_port_init_has_the_jax_tree_shapes_and_scales(pair):
    (jc, jf, jp), (tc, tf, _) = pair
    mine = tf.init(tc, torch.Generator().manual_seed(0), device="cpu")
    assert isinstance(mine, transformer.TransformerLM)
    want = dict(jax.tree_util.tree_flatten_with_path(jp)[0])
    flat = {}
    for name, p in mine.named_parameters():
        parts = name.split(".")
        if parts[0] == "blocks":  # per-layer modules -> the stacked JAX leaf
            parts = ["blocks"] + parts[2:]
        flat.setdefault(tuple(parts), []).append(p.detach())
    assert len(flat) == len(want)
    for path, leaf in want.items():
        key = tuple(k.key for k in path)
        got = torch.stack(flat[key]) if key[0] == "blocks" else flat[key][0]
        assert tuple(got.shape) == leaf.shape, key
        assert got.dtype == torch.float32
        # same scale: standard deviations within 25% (constants: equal)
        np.testing.assert_allclose(float(got.std()), float(np.std(leaf)), rtol=0.25, atol=1e-6,
                                   err_msg=str(key))
    assert sum(p.numel() for p in mine.parameters()) == sum(a.size for a in jax.tree.leaves(jp))


def test_tied_embeddings_match_jax():
    name = "minitron-8b"
    jc = dataclasses.replace(jax_config(name, reduced=True), tie_embeddings=True)
    tc = dataclasses.replace(get_config(name, reduced=True), tie_embeddings=True)
    (jc, jf, jp), (tc, tf, tp) = _pair(jc, tc)
    assert "lm_head" not in jp and not hasattr(tp, "lm_head")
    assert tc.params_count() == jc.params_count()
    toks = _tokens(jc, 2, 128, seed=4)
    j_logits, _ = jf.forward(jc, jp, toks)
    t_logits, _ = tf.forward(tc, tp, torch.tensor(toks, dtype=torch.long))
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), **TOL)
    mine = tf.init(tc, device="cpu")
    assert "lm_head" not in dict(mine.named_parameters())
    j_cache, t_cache = jf.init_cache(jc, 2, 8), tf.init_cache(tc, 2, 8, device="cpu")
    j_logits, _ = jf.decode_step(jc, jp, j_cache, toks[:, :1])
    t_logits, _ = tf.decode_step(tc, tp, t_cache, torch.tensor(toks[:, :1], dtype=torch.long))
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), **TOL)


def test_entry_points_need_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("starcoder2-15b", reduced=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        transformer.init(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        transformer.init_cache(cfg, 2, 16)
    with pytest.raises(ValueError, match="generator draws on cpu"):
        transformer.init(cfg, torch.Generator().manual_seed(0), device="cuda")
    assert next(transformer.init(cfg, device="cpu").parameters()).device.type == "cpu"
