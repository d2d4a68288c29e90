"""The port's whisper (encoder-decoder) against the JAX package.

Reduced whisper-medium (float32; enc_seq 32), the JAX parameters carried
across by ``params_from_jax``, frames and tokens made with numpy from a
seed: ``encode`` (the port's bidirectional self-attention through
``ops.flash_attention``, the flash kernel's entry point, once a layer),
``decode_train`` (causal self- and cross-attention through the same entry
point, twice a layer), ``forward``, ``precompute_cross_kv`` and
``decode_step`` token by token with the cross cache filled, each against
the JAX package's; decode against the port's own ``decode_train``; the
port's own ``init`` against the JAX init's tree and scales; LayerNorm and
the sinusoids against ``repro.models``.

Tolerance: rtol = atol = 2e-4 on logits, encoder outputs and caches, as
in ``test_torch_transformer.py`` -- the same float32 model with the sums
taken in another order (the differences seen are < 1e-6 on logits of
size ~0.6).
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import get_family as jax_family
from repro.models import layers as jl
from repro.models import whisper as jw
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.models import get_family, whisper
from repro_torch.models import layers as tl
from repro_torch.models.convert import params_from_jax

TOL = dict(rtol=2e-4, atol=2e-4)
NAME = "whisper-medium"


@pytest.fixture(scope="module")
def pair():
    """(JAX cfg, params) and (port cfg, params) of the reduced whisper, the
    same parameters in both."""
    jc, tc = jax_config(NAME, reduced=True), get_config(NAME, reduced=True)
    jp = jax_family(jc).init(jc, jax.random.PRNGKey(0))
    return (jc, jp), (tc, params_from_jax(tc, jax.tree.map(np.asarray, jp), device="cpu"))


def _frames(cfg, b, seed, t=None):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(b, t or cfg.enc_seq, cfg.d_model)).astype(np.float32)


def _tokens(cfg, b, t, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, size=(b, t)).astype(np.int32)


def _long(a):
    return torch.tensor(a, dtype=torch.long)


def _counting(monkeypatch):
    calls = []
    flash = ops.flash_attention
    monkeypatch.setattr(ops, "flash_attention",
                        lambda *a, **kw: calls.append(kw.get("causal")) or flash(*a, **kw))
    return calls


def test_layer_norm_and_sinusoids_match():
    rng = np.random.default_rng(0)
    x, w, b = (rng.normal(size=s).astype(np.float32) for s in ((2, 5, 16), (16,), (16,)))
    np.testing.assert_allclose(tl.layer_norm(torch.tensor(x), torch.tensor(w), torch.tensor(b))
                               .numpy(), np.asarray(jl.layer_norm(x, w, b)), **TOL)
    np.testing.assert_allclose(whisper._sinusoids(1500, 64).numpy(),
                               np.asarray(jw._sinusoids(1500, 64)), **TOL)


@pytest.mark.parametrize("t", [None, 40])
def test_encode_matches_jax(pair, t, monkeypatch):
    """At enc_seq and at a ragged 40 frames (cross-attention then has Tk != Tq)."""
    (jc, jp), (tc, tp) = pair
    frames = _frames(jc, 2, seed=1, t=t)
    calls = _counting(monkeypatch)
    got = whisper.encode(tc, tp, torch.tensor(frames))
    assert calls == [False] * tc.n_enc_layers  # bidirectional, once a layer
    np.testing.assert_allclose(got.numpy(), np.asarray(jw.encode(jc, jp, frames)), **TOL)


def test_decode_train_and_forward_match_jax(pair, monkeypatch):
    (jc, jp), (tc, tp) = pair
    frames, toks = _frames(jc, 2, seed=2), _tokens(jc, 2, 24, seed=3)
    enc = jw.encode(jc, jp, frames)
    calls = _counting(monkeypatch)
    got = whisper.decode_train(tc, tp, _long(toks), torch.tensor(np.asarray(enc)))
    assert calls == [True, False] * tc.n_layers  # self (causal), then cross
    want = jw.decode_train(jc, jp, toks, enc)
    assert got.shape == (2, 24, tc.vocab_padded)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    j_logits, j_aux = jw.forward(jc, jp, {"frames": frames, "tokens": toks})
    t_logits, t_aux = get_family(tc).forward(tc, tp, {"frames": torch.tensor(frames),
                                                      "tokens": _long(toks)})
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), **TOL)
    assert float(t_aux) == float(j_aux) == 0.0 and t_aux.dtype == torch.float32
    torch.testing.assert_close(tp(torch.tensor(frames), _long(toks))[0], t_logits)  # nn.Module


def _filled_caches(jc, jp, tc, tp, b, max_len, seed):
    frames = _frames(jc, b, seed=seed)
    enc = jw.encode(jc, jp, frames)
    jk, jv = jw.precompute_cross_kv(jc, jp, enc)
    tk, tv = whisper.precompute_cross_kv(tc, tp, torch.tensor(np.asarray(enc)))
    j_cache = dict(jw.init_cache(jc, b, max_len), cross_k=jk, cross_v=jv)
    t_cache = whisper.init_cache(tc, b, max_len, device="cpu")
    t_cache["cross_k"].copy_(tk)
    t_cache["cross_v"].copy_(tv)
    return (frames, enc), (jk, jv, j_cache), (tk, tv, t_cache)


def test_precompute_cross_kv_and_decode_steps_match_jax(pair):
    (jc, jp), (tc, tp) = pair
    _, (jk, jv, j_cache), (tk, tv, t_cache) = _filled_caches(jc, jp, tc, tp, 2, 32, seed=4)
    assert tk.shape == (tc.n_layers, 2, tc.n_kv_heads, tc.enc_seq, tc.head_dim)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)
    toks = _tokens(jc, 2, 20, seed=5)
    step = jax.jit(lambda p, c, t: jw.decode_step(jc, p, c, t))
    for i in range(toks.shape[1]):
        j_logits, j_cache = step(jp, j_cache, toks[:, i:i + 1])
        t_logits, t_cache = whisper.decode_step(tc, tp, t_cache, _long(toks[:, i:i + 1]))
        assert t_logits.shape == (2, tc.vocab)
        np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), err_msg=f"token {i}",
                                   **TOL)
    assert int(t_cache["len"]) == int(j_cache["len"]) == 20
    for name in ("self_k", "self_v", "cross_k", "cross_v"):
        np.testing.assert_allclose(t_cache[name].numpy(), np.asarray(j_cache[name]), **TOL)


def test_decode_steps_reproduce_decode_train(pair):
    """The port against itself: encode -> precompute_cross_kv -> 24 decode
    steps equal ``decode_train`` over the same 24 tokens."""
    (jc, jp), (tc, tp) = pair
    (frames, _), _, (_, _, cache) = _filled_caches(jc, jp, tc, tp, 2, 24, seed=6)
    toks = _long(_tokens(tc, 2, 24, seed=7))
    full = whisper.decode_train(tc, tp, toks, whisper.encode(tc, tp, torch.tensor(frames)))
    for i in range(24):
        logits, cache = whisper.decode_step(tc, tp, cache, toks[:, i:i + 1])
        torch.testing.assert_close(logits, full[:, i, : tc.vocab], **TOL)


def test_decode_past_the_cache_clamps_like_jax(pair):
    """Past ``max_len`` both packages write the last slot again (the JAX
    package's dynamic_update_slice clamps its start)."""
    (jc, jp), (tc, tp) = pair
    toks = _tokens(jc, 1, 6, seed=8)
    j_cache, t_cache = jw.init_cache(jc, 1, 4), whisper.init_cache(tc, 1, 4, device="cpu")
    for i in range(6):
        j_logits, j_cache = jw.decode_step(jc, jp, j_cache, toks[:, i:i + 1])
        t_logits, t_cache = whisper.decode_step(tc, tp, t_cache, _long(toks[:, i:i + 1]))
        np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), **TOL)
    np.testing.assert_allclose(t_cache["self_k"].numpy(), np.asarray(j_cache["self_k"]), **TOL)


def test_port_init_has_the_jax_tree_shapes_and_scales(pair):
    (jc, jp), (tc, _) = pair
    mine = whisper.init(tc, torch.Generator().manual_seed(0), device="cpu")
    assert isinstance(mine, whisper.Whisper)
    want = dict(jax.tree_util.tree_flatten_with_path(jp)[0])
    flat = {}
    for name, p in mine.named_parameters():
        parts = name.split(".")
        if parts[0] in ("enc_blocks", "dec_blocks"):  # per-layer -> the stacked JAX leaf
            parts = parts[:1] + parts[2:]
        flat.setdefault(tuple(parts), []).append(p.detach())
    assert len(flat) == len(want)
    for path, leaf in want.items():
        key = tuple(k.key for k in path)
        got = torch.stack(flat[key]) if key[0].endswith("_blocks") else flat[key][0]
        assert tuple(got.shape) == leaf.shape, key
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got.std()), float(np.std(leaf)), rtol=0.25, atol=1e-6,
                                   err_msg=str(key))
    assert mine["pos_dec"].shape == (32_768, tc.d_model)
    assert sum(p.numel() for p in mine.parameters()) == sum(a.size for a in jax.tree.leaves(jp))


def test_entry_points_need_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config(NAME, reduced=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        whisper.init(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        whisper.init_cache(cfg, 2, 16)
    with pytest.raises(ValueError, match="generator draws on cpu"):
        whisper.init(cfg, torch.Generator().manual_seed(0), device="cuda")
    assert next(whisper.init(cfg, device="cpu").parameters()).device.type == "cpu"
