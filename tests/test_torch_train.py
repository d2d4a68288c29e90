"""The port's training path: the train step against the JAX package's,
and the ports of the JAX package's training tests (``tests/test_train.py``).

``make_train_step`` at stablelm-reduced (float32), the JAX parameters
carried across, three steps on three batches in four modes (microbatches
1 and 2, int8 gradient compression off and on):

- every step's loss within 1e-5 (relative) of the JAX step's;
- without compression, the parameters after the third step within 1e-5
  of the JAX package's.  The learning rate is 1e-4: Adam divides each
  element's momentum by its RMS, so an element whose gradient is near 0
  turns the ~1e-7 relative difference of the two gradients into an update
  difference of up to the learning rate; after three steps that reads
  1.1e-5 at lr = 1e-3 and 1.2e-6 at 1e-4 (measured);
- with compression, the parameters after each step within 1e-6 of each
  leaf's largest magnitude of the JAX package's ``compress_tree`` and
  ``apply_updates`` run on the port's own gradients.  Against the JAX
  step end to end they cannot be held element by element: an int8 code
  flips where ``g / scale`` lies within the gradients' difference of a
  half-integer, and a flip moves that element by up to the learning rate
  (measured: 1 of 147,776 elements 1.2e-5 apart after three steps with two
  microbatches, the rest within 3.3e-6).

Then the six tests of ``tests/test_train.py`` on the port (loss decreases,
crash recovery, deterministic data, microbatching matches the full batch,
compression still learns, checkpoints restored bitwise with GC and
bfloat16), a restart that restores the parameters bit for bit, and the
loop's default device (the card; an error without one).
"""

import functools
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jopt
from repro.configs import get_config as jax_config
from repro.models import get_family as jax_family
from repro.train import TrainConfig as JaxTrainConfig
from repro.train import make_train_step as jax_make_train_step
from repro_torch import optim
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.models import get_family
from repro_torch.models.convert import params_from_jax, params_to_jax
from repro_torch.optim import AdamWConfig
from repro_torch.train import TrainConfig, TrainLoop, make_train_step, run_with_restarts
from repro_torch.train.checkpoint import CheckpointManager

ARCH = "stablelm-1.6b"
LR = 1e-4
LOSS_RTOL, PARAM_ATOL, EMULATED_TOL = 1e-5, 1e-5, 1e-6
MODES = [(1, False), (2, False), (1, True), (2, True)]


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, np.asarray(tree, dtype=np.float32)


def _max_diff(want: dict, got: dict, relative: bool) -> float:
    worst = 0.0
    for path, a in _leaves(want):
        b = got
        for k in path:
            b = b[k]
        d = float(np.abs(a - b).max())
        worst = max(worst, d / max(float(np.abs(a).max()), 1e-30) if relative else d)
    return worst


@pytest.fixture(scope="module")
def start():
    jc = jax_config(ARCH, reduced=True)
    jp = jax_family(jc).init(jc, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    batches = [rng.integers(0, jc.vocab, size=(4, 32)).astype(np.int32) for _ in range(3)]
    return jc, jp, batches


@pytest.mark.parametrize("nmicro,compress", MODES)
def test_train_step_matches_jax(start, tmp_path, nmicro, compress):
    jc, jp, batches = start
    tc = get_config(ARCH, reduced=True)
    jtc = JaxTrainConfig(microbatches=nmicro, grad_compress=compress,
                         checkpoint_dir=str(tmp_path))
    jstep = jax.jit(jax_make_train_step(jc, jopt.AdamWConfig(lr=LR, warmup_steps=0), jtc))
    js, je = jopt.init(jp), (jopt.compress.init_error_state(jp) if compress else {})
    model = params_from_jax(tc, jax.tree.map(np.asarray, jp), device="cpu").requires_grad_(True)
    params = dict(model.named_parameters())
    ts = optim.init(params)
    te = optim.compress.init_error_state(params) if compress else {}
    tstep = make_train_step(tc, AdamWConfig(lr=LR, warmup_steps=0),
                            TrainConfig(microbatches=nmicro, grad_compress=compress,
                                        checkpoint_dir=str(tmp_path)))
    # the JAX optimizer on the port's own gradients (recorded before the
    # compression)
    seen = []
    real = optim.compress.compress_tree

    def record(grads, err):
        seen.append(params_to_jax(model, values=grads))
        return real(grads, err)

    emu_p, emu_s, emu_e = jp, jopt.init(jp), jopt.compress.init_error_state(jp)
    ecfg = jopt.AdamWConfig(lr=LR, warmup_steps=0)
    jcur = jp
    for toks in batches:
        jcur, js, je, jm = jstep(jcur, js, je, {"tokens": jnp.asarray(toks)})
        jax_loss = float(jm["loss"])
        optim.compress.compress_tree = record
        try:
            tm = tstep(model, ts, te, {"tokens": torch.tensor(toks)})
        finally:
            optim.compress.compress_tree = real
        assert set(tm) == {"loss", "nll", "aux", "grad_norm", "lr"}
        assert abs(float(tm["loss"]) - jax_loss) <= LOSS_RTOL * abs(jax_loss)
        if compress:
            ghat, emu_e = jopt.compress.compress_tree(seen[-1], emu_e)
            emu_p, emu_s, _ = jopt.apply_updates(ecfg, emu_p, ghat, emu_s)
            assert _max_diff(emu_p, params_to_jax(model), relative=True) <= EMULATED_TOL
    assert len(seen) == (3 if compress else 0)
    assert ts.step == 3
    if not compress:
        assert _max_diff(jcur, params_to_jax(model), relative=False) <= PARAM_ATOL


# ---------------------------------------------------------------------------
# The JAX package's training tests, on the port
# ---------------------------------------------------------------------------


def _mk(ckpt_dir, steps=40, **kw):
    cfg = get_config(ARCH, reduced=True)
    tc = TrainConfig(steps=steps, checkpoint_every=20, checkpoint_dir=str(ckpt_dir),
                     log_every=10, **kw)
    oc = AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=steps)
    dc = DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=8, noise=0.05)
    return cfg, tc, oc, dc


def test_loss_decreases(tmp_path):
    cfg, tc, oc, dc = _mk(tmp_path)
    out = TrainLoop(cfg, oc, tc, dc, device="cpu").run()
    losses = [r["loss"] for r in out["log"]]
    assert [r["step"] for r in out["log"]] == [10, 20, 30, 40]
    assert set(out["log"][0]) == {"step", "loss", "grad_norm", "lr", "step_time_s", "straggler"}
    assert losses[-1] < losses[0] - 0.5


def test_crash_recovery_resumes_from_checkpoint(tmp_path):
    cfg, tc, oc, dc = _mk(tmp_path, steps=50)
    calls = {"n": 0}

    def fault(step):
        if step == 30 and calls["n"] == 0:
            calls["n"] += 1
            raise RuntimeError("simulated preemption")

    out, restarts = run_with_restarts(
        lambda: TrainLoop(cfg, oc, tc, dc, fault_hook=fault, device="cpu"))
    assert restarts == 1
    assert out["last_step"] == 50
    # the second attempt resumed from the step-20 checkpoint: it logged 30..50
    assert [r["step"] for r in out["log"]] == [30, 40, 50]


def test_deterministic_data_across_restart(tmp_path):
    _, _, _, dc = _mk(tmp_path)
    a = SyntheticLM(dc).batch(7)
    b = SyntheticLM(dc).batch(7)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    # shards partition the batch deterministically
    s0 = SyntheticLM(dc, shard_id=0, n_shards=2).batch(7)
    s1 = SyntheticLM(dc, shard_id=1, n_shards=2).batch(7)
    assert s0["tokens"].shape[0] == dc.global_batch // 2
    assert not np.array_equal(s0["tokens"], s1["tokens"])


def test_microbatching_matches_full_batch(tmp_path):
    """Gradient accumulation must give the same update as the full batch."""
    cfg = get_config(ARCH, reduced=True)
    oc = AdamWConfig(lr=1e-3, warmup_steps=0)
    fam = get_family(cfg)
    tokens = torch.randint(0, cfg.vocab, (4, 32), generator=torch.Generator().manual_seed(1))
    out = []
    for nmicro in (1, 2):
        model = fam.init(cfg, device="cpu").requires_grad_(True)
        params = dict(model.named_parameters())
        step = make_train_step(cfg, oc, TrainConfig(microbatches=nmicro,
                                                    checkpoint_dir=str(tmp_path)))
        m = step(model, optim.init(params), {}, {"tokens": tokens})
        out.append((m, params))
    (m1, p1), (m2, p2) = out
    # losses match to fp tolerance; params close (clip uses same norm scale)
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 1e-3
    assert float(m2["aux"]) == 0.0
    assert max(float((p1[n] - p2[n]).detach().abs().max()) for n in p1) < 1e-4


def test_grad_compression_still_learns(tmp_path):
    cfg, tc, oc, dc = _mk(tmp_path, steps=30, grad_compress=True)
    out = TrainLoop(cfg, oc, tc, dc, device="cpu").run()
    losses = [r["loss"] for r in out["log"]]
    assert losses[-1] < losses[0] - 0.3


def test_checkpoint_restore_bitwise(tmp_path):
    cm = CheckpointManager(tmp_path, keep=2, async_save=False)
    tree = {"a": torch.arange(10, dtype=torch.float32),
            "b": {"c": torch.ones((3, 3), dtype=torch.bfloat16)}}
    cm.save(5, tree)
    cm.save(10, tree)
    cm.save(15, tree)  # keep=2 -> step 5 garbage-collected
    assert cm.latest_step() == 15
    restored = cm.restore(15, tree)
    np.testing.assert_array_equal(restored["a"].numpy(), np.arange(10))
    assert restored["b"]["c"].dtype == torch.bfloat16
    ckpts = list(pathlib.Path(tmp_path).glob("step_*.npz"))
    assert len(ckpts) == 2


def test_checkpoint_of_optimizer_state_and_latest_without_manifest(tmp_path):
    cm = CheckpointManager(tmp_path, keep=3)
    params = {"w": torch.randn(4, 3), "v": torch.randn(5).bfloat16()}
    state = optim.init(params, master_weights=True)
    optim.apply_updates(AdamWConfig(warmup_steps=0, master_weights=True), params,
                        {n: torch.randn_like(p.float()) for n, p in params.items()}, state)
    cm.save(7, {"params": params, "opt": state, "err": {}})
    cm.wait()
    with np.load(tmp_path / "step_00000007.npz") as data:
        assert {"params/w", "params/v", "opt/step", "opt/m/w", "opt/v/v",
                "opt/master/w"} <= set(data.files)
    template = {"params": {n: torch.zeros_like(p) for n, p in params.items()},
                "opt": optim.init(params, master_weights=True), "err": {}}
    back = cm.restore(7, template)
    assert back["opt"].step == 1 and isinstance(back["opt"].step, int)
    for n in params:
        assert back["params"][n].dtype == params[n].dtype
        torch.testing.assert_close(back["params"][n], params[n], rtol=0, atol=0)
        torch.testing.assert_close(back["opt"].m[n], state.m[n], rtol=0, atol=0)
        torch.testing.assert_close(back["opt"].master[n], state.master[n], rtol=0, atol=0)
    (tmp_path / "manifest.json").unlink()
    assert cm.latest_step() == 7
    assert CheckpointManager(tmp_path / "empty").latest_step() is None


def test_restart_restores_the_parameters_bit_for_bit(tmp_path):
    cfg, tc, oc, dc = _mk(tmp_path, steps=20)
    first = TrainLoop(cfg, oc, tc, dc, device="cpu").run()
    again = TrainLoop(cfg, oc, tc, dc, device="cpu").run()  # resumes at 20: no step
    assert again["last_step"] == 20 and again["log"] == []
    mine = dict(again["params"].named_parameters())
    for n, p in first["params"].named_parameters():
        torch.testing.assert_close(mine[n], p, rtol=0, atol=0)


def test_loop_runs_on_the_card_unless_told(tmp_path, monkeypatch):
    cfg, tc, oc, dc = _mk(tmp_path, steps=1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TrainLoop(cfg, oc, tc, dc)
    loop = TrainLoop(cfg, oc, tc, dc, device="cpu")
    out = loop.run()
    assert out["last_step"] == 1 and np.isfinite(out["final_loss"])
    assert all(p.device.type == "cpu" and p.requires_grad
               for p in out["params"].parameters())


def test_batches_with_patches_and_frames_train(tmp_path):
    """A batch may carry the patches or frames its family's loss reads."""
    for name in ("phi-3-vision-4.2b", "whisper-medium"):
        cfg = get_config(name, reduced=True)
        model = get_family(cfg).init(cfg, device="cpu").requires_grad_(True)
        params = dict(model.named_parameters())
        g = torch.Generator().manual_seed(0)
        batch = {"tokens": torch.randint(0, cfg.vocab, (2, 16), generator=g)}
        if cfg.n_patches:
            batch["patches"] = torch.randn(2, cfg.n_patches, cfg.d_model, generator=g)
        else:
            batch["frames"] = torch.randn(2, cfg.enc_seq, cfg.d_model, generator=g)
        step = make_train_step(cfg, AdamWConfig(lr=1e-3, warmup_steps=0),
                               TrainConfig(microbatches=2, checkpoint_dir=str(tmp_path)))
        before = {n: p.detach().clone() for n, p in params.items()}
        m = step(model, optim.init(params), {}, batch)
        assert np.isfinite(float(m["loss"])) and float(m["grad_norm"]) > 0
        assert all(not torch.equal(before[n], p) for n, p in params.items())
        assert all(p.grad is None for p in params.values())


def test_jax_and_port_train_configs_carry_the_same_fields():
    """Every field, ``zero1`` (read by the sharded step) included, with the
    same defaults but the checkpoint directory."""
    import dataclasses

    mine = {f.name for f in dataclasses.fields(TrainConfig)}
    assert mine == {f.name for f in dataclasses.fields(JaxTrainConfig)}
    assert functools.reduce(lambda a, b: a and b, [
        getattr(TrainConfig(), f) == getattr(JaxTrainConfig(), f)
        for f in mine if f != "checkpoint_dir"])

