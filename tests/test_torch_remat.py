"""``ModelConfig.remat`` in every family's training forward, against the
JAX package's ``jax.checkpoint`` of the same layers.

Five reduced configurations (float32): stablelm (the dense block),
deepseek-moe (the block with its router's aux), rwkv6 (the block with its
state), zamba2 (the Mamba layer; the shared attention block stays
outside) and whisper (the encoder and the decoder block).  At each of
"none", "full" and "dots":

* the loss and every gradient leaf equal the "none" run's within 1e-6 of
  the leaf's largest magnitude (the replay recomputes the same float32
  values), and JAX's ``value_and_grad`` at the same ``remat`` within the
  tolerances of ``tests/test_torch_loss_grad.py`` (1e-5 relative, 1e-4 of
  each leaf's largest);
* the bytes kept for the backward are ordered full < dots < none, so a
  knob that does nothing fails.  They are counted as the storages made
  during the forward (every operator's outputs, seen by a
  ``TorchDispatchMode``) still alive when it ends, parameters and inputs
  aside: what autograd, the checkpoint and the "dots" policy's cache hold.
  ``torch.autograd.graph.saved_tensors_hooks`` cannot order the three: a
  checkpoint's own hooks are the innermost inside its region and the
  policy's cache is no saved tensor, so hooks see "full" and "dots" alike;
  they do show "full" below "none", which is asserted too.

A ``TrainLoop`` step at "full" equals one at "none"; serving (no grad,
or frozen parameters) never enters ``torch.utils.checkpoint``.
"""

import dataclasses
import functools
import gc
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro.configs import get_config as jax_config
from repro.models import get_family as jax_family
from repro_torch.configs import get_config
from repro_torch.models import get_family
from repro_torch.models.convert import params_from_jax, params_to_jax

ARCHS = ["stablelm-1.6b", "deepseek-moe-16b", "rwkv6-1.6b", "zamba2-2.7b", "whisper-medium"]
MODES = ["none", "full", "dots"]
LOSS_RTOL, GRAD_TOL, MODE_TOL = 1e-5, 1e-4, 1e-6
B, T = 2, 64


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, size=(B, T)).astype(np.int32)}
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal((B, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return batch


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, np.asarray(tree)


def _worst(want: dict, got: dict) -> float:
    """The largest leaf difference over that leaf's largest magnitude."""
    assert {p for p, _ in _leaves(want)} == {p for p, _ in _leaves(got)}
    worst = 0.0
    for path, a in _leaves(want):
        b = got
        for k in path:
            b = b[k]
        worst = max(worst, float(np.abs(a - b).max()) / max(float(np.abs(a).max()), 1e-30))
    return worst


class _Made(TorchDispatchMode):
    """Every storage an operator makes while the mode is on (weakly)."""

    def __init__(self):
        super().__init__()
        self.made = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                st = t.untyped_storage()
                self.made.append((StorageWeakRef(st), st.nbytes()))
        return out


def _port_run(name, mode, jp, batch):
    """(loss, gradient tree, bytes alive after the forward, bytes packed
    by saved_tensors_hooks) of the port at ``remat=mode``."""
    tc = dataclasses.replace(get_config(name, reduced=True), remat=mode)
    model = params_from_jax(tc, jp, device="cpu").requires_grad_(True)
    tb = {k: torch.tensor(v) for k, v in batch.items()}
    own = {StorageWeakRef(t.untyped_storage()).cdata for t in [*model.parameters(), *tb.values()]}
    packed = []

    def pack(t):
        packed.append(t.untyped_storage().nbytes())
        return t

    made = _Made()
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t), made:
        total, _ = get_family(tc).loss(tc, model, tb)
    gc.collect()
    alive = {ref.cdata: n for ref, n in made.made if not ref.expired() and ref.cdata not in own}
    total.backward()
    grads = params_to_jax(model, {n: p.grad for n, p in model.named_parameters()})
    return float(total.detach()), grads, sum(alive.values()), sum(packed)


def _jax_run(name, mode, jp, batch):
    jc = dataclasses.replace(jax_config(name, reduced=True), remat=mode)
    (jl, _), jg = jax.jit(jax.value_and_grad(functools.partial(jax_family(jc).loss, jc),
                                             has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    return float(jl), jax.tree.map(np.asarray, jg)


@pytest.fixture(scope="module", params=ARCHS)
def runs(request):
    """{mode: port run} and {mode: JAX run} of one architecture, the same
    weights and batch throughout; JAX compiles in threads meanwhile."""
    name = request.param
    jc = jax_config(name, reduced=True)
    jp = jax.tree.map(np.asarray, jax.jit(functools.partial(jax_family(jc).init, jc))(
        jax.random.PRNGKey(0)))
    batch = _batch(jc, len(name))
    # the JAX package's RWKV6, Zamba2 and whisper layers take
    # jax.checkpoint(body) for any remat but "none": their "dots" program is
    # their "full" one, compiled once
    jax_modes = MODES if jc.family in ("dense", "moe") else ["none", "full"]
    with ThreadPoolExecutor(3) as pool:
        jax_runs = {m: pool.submit(_jax_run, name, m, jp, batch) for m in jax_modes}
        port = {m: _port_run(name, m, jp, batch) for m in MODES}
        jruns = {m: f.result() for m, f in jax_runs.items()}
    jruns.setdefault("dots", jruns["full"])
    return name, port, jruns


@pytest.mark.parametrize("mode", ["full", "dots"])
def test_gradients_equal_the_no_remat_run(runs, mode):
    _, port, _ = runs
    assert port[mode][0] == port["none"][0]
    assert _worst(port["none"][1], port[mode][1]) <= MODE_TOL


@pytest.mark.parametrize("mode", MODES)
def test_loss_and_gradients_equal_jax_at_the_same_remat(runs, mode):
    _, port, jruns = runs
    jl, jg = jruns[mode]
    assert abs(port[mode][0] - jl) <= LOSS_RTOL * abs(jl)
    assert _worst(jg, port[mode][1]) <= GRAD_TOL


def test_bytes_kept_for_the_backward_are_ordered_full_dots_none(runs):
    name, port, _ = runs
    alive = {m: port[m][2] for m in MODES}
    assert alive["full"] < alive["dots"] < alive["none"], (name, alive)
    packed = {m: port[m][3] for m in MODES}
    assert packed["full"] < packed["none"], (name, packed)


def test_the_default_is_full_and_every_reduced_config_none():
    for name in ARCHS:
        assert get_config(name).remat == "full"
        assert get_config(name, reduced=True).remat == "none"


@pytest.mark.parametrize("name", ["stablelm-1.6b", "zamba2-2.7b"])
def test_a_train_loop_step_at_full_equals_one_at_none(tmp_path, name):
    from repro_torch import optim
    from repro_torch.data import DataConfig
    from repro_torch.train import TrainConfig, TrainLoop

    out = {}
    for mode in ("none", "full"):
        cfg = dataclasses.replace(get_config(name, reduced=True), remat=mode)
        loop = TrainLoop(cfg, optim.AdamWConfig(lr=1e-3, warmup_steps=0),
                         TrainConfig(steps=2, log_every=1, checkpoint_every=10,
                                     checkpoint_dir=str(tmp_path / mode)),
                         DataConfig(vocab=cfg.vocab, seq_len=T, global_batch=B), device="cpu")
        res = loop.run(resume=False)
        out[mode] = ([r["loss"] for r in res["log"]], [r["grad_norm"] for r in res["log"]],
                     {n: p.detach().clone() for n, p in res["params"].named_parameters()})
    assert out["full"][0] == out["none"][0]
    assert out["full"][1] == out["none"][1]
    for n, p in out["none"][2].items():
        assert torch.equal(out["full"][2][n], p), n


@pytest.mark.parametrize("name", ARCHS)
def test_serving_never_enters_the_checkpoint(monkeypatch, name):
    """At remat="full": a forward under no_grad, and one on frozen
    parameters with grad mode on, run the plain layers."""
    import torch.utils.checkpoint as ckpt

    def refuse(*a, **k):
        raise AssertionError("checkpoint entered while serving")

    monkeypatch.setattr(ckpt, "checkpoint", refuse)
    cfg = dataclasses.replace(get_config(name, reduced=True), remat="full")
    fam = get_family(cfg)
    model = fam.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = {k: torch.tensor(v) for k, v in _batch(cfg, 0).items()}
    args = (batch,) if cfg.family == "encdec" else (batch["tokens"],)
    with torch.no_grad():
        a = fam.forward(cfg, model, *args)[0]
    b = fam.forward(cfg, model, *args)[0]  # frozen parameters: nothing records
    assert torch.equal(a, b)
    model.requires_grad_(True)
    with pytest.raises(AssertionError, match="checkpoint entered"):
        fam.forward(cfg, model, *args)
