"""The port's RWKV6 and Zamba2 models against the JAX package.

Reduced configurations (float32), the JAX parameters carried across by
``params_from_jax``: ``forward`` (logits and carried state), a prompt pass
continued by a second ``forward`` from the carried state, ``decode_step``
token by token with the state carried, and the port's own ``init`` (the
JAX init's tree, shapes and scales; other random values).  The shared
layers (norms, RoPE, MLP, decode attention) and the chunked attention
(``flash_attention_ref``) against ``repro.models.layers``, and the configurations of every
architecture of ``repro.configs`` (and the family module each resolves
to) against the JAX package's.

Tolerance: rtol = atol = 2e-4 on logits and states -- the same float32
model with the matrix products' and the scans' sums taken in another
order (the differences seen are ~1e-6 on logits of size ~0.7).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import get_family as jax_family
from repro.models import layers as jl
from repro_torch.configs import arch_names, get_config
from repro_torch.kernels.ref import flash_attention_ref
from repro_torch.models import get_family
from repro_torch.models import layers as tl
from repro_torch.models.convert import params_from_jax

TOL = dict(rtol=2e-4, atol=2e-4)
ARCHS = ["rwkv6-1.6b", "zamba2-2.7b"]


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(JAX cfg, family, params) and (port cfg, family, params) of one
    reduced architecture, the same parameters in both."""
    jc = jax_config(request.param, reduced=True)
    tc = get_config(request.param, reduced=True)
    jf, tf = jax_family(jc), get_family(tc)
    jp = jf.init(jc, jax.random.PRNGKey(0))
    tp = params_from_jax(tc, jax.tree.map(np.asarray, jp), device="cpu")
    return (jc, jf, jp), (tc, tf, tp)


def _tokens(cfg, b, t, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, size=(b, t)).astype(np.int32)


def _close_state(ts, js):
    assert set(ts) == set(js)
    for name in js:
        np.testing.assert_allclose(ts[name].numpy(), np.asarray(js[name]), err_msg=name, **TOL)


def test_configs_match_the_jax_registry():
    registry = ["rwkv6-1.6b", "mixtral-8x22b", "deepseek-moe-16b", "phi3-mini-3.8b",
                "stablelm-1.6b", "minitron-8b", "starcoder2-15b", "zamba2-2.7b",
                "phi-3-vision-4.2b", "whisper-medium"]
    assert arch_names() == registry
    for name in registry:
        for reduced in (False, True):
            mine = dataclasses.asdict(get_config(name, reduced=reduced))
            theirs = jax_config(name, reduced=reduced)
            assert mine == {f: getattr(theirs, f) for f in mine}
            want_count = jax_config(name, reduced).params_count()
            assert get_config(name, reduced).params_count() == want_count
            mod = get_family(get_config(name, reduced))
            assert mod.__name__.split(".")[-1] == jax_family(theirs).__name__.split(".")[-1]


def test_forward_and_carried_state_match(pair):
    (jc, jf, jp), (tc, tf, tp) = pair
    toks = _tokens(jc, 2, 32, seed=0)
    j_logits, j_state = jf.forward(jc, jp, toks)
    t_logits, t_state = tf.forward(tc, tp, torch.tensor(toks, dtype=torch.long))
    assert t_logits.shape == (2, 32, tc.vocab_padded)
    torch.testing.assert_close(tp(torch.tensor(toks, dtype=torch.long))[0], t_logits)  # nn.Module
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), **TOL)
    _close_state(t_state, j_state)
    # a second prompt pass continues from the carried state
    more = _tokens(jc, 2, 16, seed=1)
    j2, j_state2 = jf.forward(jc, jp, more, j_state)
    t2, t_state2 = tf.forward(tc, tp, torch.tensor(more, dtype=torch.long), t_state)
    np.testing.assert_allclose(t2.numpy(), np.asarray(j2), **TOL)
    _close_state(t_state2, j_state2)


def test_decode_steps_carry_the_state_like_jax(pair):
    (jc, jf, jp), (tc, tf, tp) = pair
    toks = _tokens(jc, 2, 10, seed=2)
    j_cache = jf.init_cache(jc, 2, 16)
    t_cache = tf.init_cache(tc, 2, 16, device="cpu")
    step = jax.jit(lambda p, c, t: jf.decode_step(jc, p, c, t))
    for i in range(toks.shape[1]):
        j_logits, j_cache = step(jp, j_cache, toks[:, i:i + 1])
        t_logits, t_cache = tf.decode_step(tc, tp, t_cache, torch.tensor(toks[:, i:i + 1],
                                                                        dtype=torch.long))
        assert t_logits.shape == (2, tc.vocab)
        np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), **TOL)
    _close_state(t_cache, j_cache)


def test_decode_reproduces_the_chunked_forward(pair):
    """The port against itself: T=16 through the chunk-16 scan equals 16
    chunk-1 decode steps (the kernels' two paths on the card)."""
    _, (tc, tf, tp) = pair
    toks = torch.tensor(_tokens(tc, 2, 16, seed=3), dtype=torch.long)
    full, _ = tf.forward(tc, tp, toks)
    cache = tf.init_cache(tc, 2, 16, device="cpu")
    for i in range(16):
        logits, cache = tf.decode_step(tc, tp, cache, toks[:, i:i + 1])
        torch.testing.assert_close(logits, full[:, i, : tc.vocab], **TOL)


def test_prompt_longer_than_a_chunk_must_be_a_multiple_of_it(pair):
    _, (tc, tf, tp) = pair
    toks = torch.tensor(_tokens(tc, 1, tc.ssm_chunk + 4, seed=4), dtype=torch.long)
    with pytest.raises(ValueError, match="not divisible by chunk"):
        tf.forward(tc, tp, toks)


def test_port_init_has_the_jax_tree_shapes_and_scales(pair):
    (jc, jf, jp), (tc, tf, _) = pair
    mine = tf.init(tc, torch.Generator().manual_seed(0), device="cpu")
    assert isinstance(mine, torch.nn.Module)
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
        np.testing.assert_allclose(float(got.std()) if got.numel() > 1 else 0.0,
                                   float(np.std(leaf)) if leaf.size > 1 else 0.0,
                                   rtol=0.25, atol=1e-6, err_msg=str(key))
    assert sum(p.numel() for p in mine.parameters()) == sum(a.size for a in jax.tree.leaves(jp))


def test_entry_points_need_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("rwkv6-1.6b", reduced=True)
    fam = get_family(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        fam.init(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        fam.init_cache(cfg, 2, 16)
    assert next(fam.init(cfg, device="cpu").parameters()).device.type == "cpu"


@pytest.mark.parametrize("name", ARCHS)
def test_init_refuses_a_generator_on_another_device(name, monkeypatch):
    cfg = get_config(name, reduced=True)
    fam = get_family(cfg)
    with pytest.raises(ValueError, match="generator draws on cpu"):
        fam.init(cfg, torch.Generator().manual_seed(0), device="cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):  # the default is the card
        fam.init(cfg, torch.Generator().manual_seed(0))


# ---------------------------------------------------------------------------
# shared layers
# ---------------------------------------------------------------------------


def _arr(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def test_norms_rope_and_mlp_match():
    rng = np.random.default_rng(0)
    x, w, b = _arr(rng, 2, 5, 16), _arr(rng, 16), _arr(rng, 16)
    t = lambda a: torch.tensor(a)  # noqa: E731
    np.testing.assert_allclose(tl.rms_norm(t(x), t(w)).numpy(), jl.rms_norm(x, w), **TOL)
    np.testing.assert_allclose(tl.group_norm(t(x), t(w), t(b), 4).numpy(),
                               jl.group_norm(x, w, b, 4), **TOL)
    q = _arr(rng, 2, 3, 5, 8)
    pos = np.arange(3, 8)
    np.testing.assert_allclose(tl.apply_rope(t(q), t(pos), 1e4).numpy(),
                               jl.apply_rope(q, jnp.asarray(pos), 1e4), **TOL)
    params = {"wi": _arr(rng, 16, 24), "wo": _arr(rng, 12, 16)}
    tparams = {k: t(v) for k, v in params.items()}
    for act in ("silu", "gelu", "relu2"):
        np.testing.assert_allclose(tl.mlp(tparams, t(x), act).numpy(),
                                   jl.mlp(params, x, act), **TOL)
    plain = {"wi": params["wi"][:, :12], "wo": params["wo"]}
    np.testing.assert_allclose(tl.mlp({k: t(v) for k, v in plain.items()}, t(x), "silu", False)
                               .numpy(), jl.mlp(plain, x, "silu", False), **TOL)


@pytest.mark.parametrize("window,block_k,q_offset", [(None, 4, 0), (3, 8, 0), (None, 16, 5)])
def test_attention_matches(window, block_k, q_offset):
    rng = np.random.default_rng(1)
    q, k, v = _arr(rng, 2, 4, 6, 8), _arr(rng, 2, 2, 11, 8), _arr(rng, 2, 2, 11, 8)
    t = torch.tensor
    got = flash_attention_ref(t(q), t(k), t(v), causal=True, window=window, block_k=block_k,
                              q_offset=q_offset)
    want = jl.flash_attention(q, k, v, causal=True, window=window, block_k=block_k,
                              q_offset=q_offset)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    q1 = q[:, :, :1]
    for cur in (7, np.array([3, 11])):
        got = tl.decode_attention(t(q1), t(k), t(v), t(cur), window=window)
        want = jl.decode_attention(q1, k, v, jnp.asarray(cur), window=window)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
