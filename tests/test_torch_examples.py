"""The port's examples (``repro_torch.examples``) on the CPU, against the
JAX package's scripts in ``examples/`` where they print the same numbers.

Each example runs through its ``main(["--device", "cpu", ...])`` (or its
``run(...)`` where a size must shrink for the CPU) and the test reads what
it printed.  Held against the JAX package, float32 throughout, as
``tests/test_torch_sap.py`` holds the lifecycle: the quickstart's dense
demo (SaP-C and SaP-D) and ``distributed_solve``'s single-process
reference against ``repro.core``'s ``plan_banded`` / ``factor`` / ``solve``
on the same band and right-hand side -- the same iteration count, x within
1e-4 relative to the JAX x.  ``train_lm``'s ~100M configuration against
the JAX script's ``make_100m``: the same fields and parameter count.
Without ``--device`` and with no card every example raises the error of
``repro_torch.device.resolve_device``.
"""

import dataclasses
import importlib
import importlib.util
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
from benchmarks.check_trace import check_required, validate_events
from repro_torch.configs import get_config
from repro_torch.examples import distributed_solve, quickstart, train_lm
from repro_torch.kernels import ops

ROOT = Path(__file__).resolve().parent.parent
EXAMPLES = ("quickstart", "fleet_solve", "serve_async", "traced_solve", "distributed_solve",
            "serve_lm", "train_lm")
XTOL = 1e-4  # tests/test_torch_sap.py's bound on x against the JAX x


def _module(name):
    return importlib.import_module(f"repro_torch.examples.{name}")


def _floats(pattern, text):
    return [float(m) for m in re.findall(pattern, text)]


def _jax_solve(band, b, **opts):
    fac = J.factor(J.plan_banded(jnp.asarray(band, jnp.float32), J.SaPOptions(**opts)))
    res = fac.solve(jnp.asarray(b, jnp.float32))
    return np.asarray(res.x, np.float64), float(res.iterations)


def _relative(x, ref):
    return float(np.linalg.norm(x - ref) / np.linalg.norm(ref))


def test_quickstart_against_jax(capsys):
    dense = quickstart.run("cpu")
    out = capsys.readouterr().out
    assert out.rstrip().endswith("quickstart OK")
    for variant in ("C", "D"):
        (relerr,) = _floats(rf"SaP-{variant}: iters=\s*[\d.]+\s+relerr=(\S+)", out)
        assert relerr < XTOL
    (oneshot,) = _floats(r"one-shot x16:\s+([\d.]+) ms", out)
    (maxerr,) = _floats(r"factor-once x16:\s+[\d.]+ ms \([\d.]+x, maxerr=(\S+)\)", out)
    assert oneshot > 0 and maxerr < 1e-4
    assert re.search(r"K after DB\+CM reordering: \d+\s+iters=1\.00", out)
    assert re.search(r"with 2% drop-off: K=\d+ iters=1\.00", out)

    # the dense demo's inputs, rebuilt, through the JAX lifecycle
    n, k = 4096, 16
    band = np.float32(J.random_banded(n, k, d=1.0, seed=0))
    xstar = np.random.default_rng(0).normal(size=n)
    b = np.asarray(J.band_to_dense(jnp.asarray(band))) @ xstar
    for variant, res in dense.items():
        jx, jit = _jax_solve(band, b, p=8, variant=variant, tol=1e-6)
        assert float(res.iterations) == jit
        assert _relative(res.x.double().numpy(), jx) <= XTOL


def test_fleet_solve(capsys):
    assert _module("fleet_solve").main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    (maxerr,) = _floats(r"batched\s*:\s+[\d.]+ ms \([\d.]+x\)\s+maxerr=(\S+) conv=True", out)
    assert maxerr < 1e-4
    assert "solved=32 conv=True steps=4" in out
    assert "factored=4 cache_hit_rate=88%" in out
    assert "(2048, 8, 8), (4096, 8, 8), (4096, 16, 8), (8192, 16, 8)" in out


def test_serve_async(capsys):
    assert _module("serve_async").main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "futures: 23 solved, 1 shed (deadline_misses=1)" in out
    served = eval(re.search(r"variants served: (\{.*?\})", out).group(1))  # noqa: S307
    assert set(served) == {"C", "E"} and sum(served.values()) == 23
    trimmed = json.loads(out[out.index("{\n"):])
    assert trimmed["counters"]["submitted"] == 24.0
    assert trimmed["counters"]["solved"] == 23.0


def test_traced_solve_smoke(tmp_path, capsys):
    assert _module("traced_solve").main(["--smoke", "--out", str(tmp_path), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    (relerr,) = _floats(r"variant=E\s+converged=True\s+iters=[\d.]+\s+relerr=(\S+)", out)
    assert relerr < XTOL
    doc = json.loads((tmp_path / "trace.json").read_text())
    pairs = validate_events(doc["traceEvents"])
    check_required(pairs, ["reorder", "factor.lu", "factor.spike", "krylov"])


def test_distributed_solve_on_four_ranks(capsys):
    got = distributed_solve.run("cpu", ranks=4)
    out = capsys.readouterr().out
    assert "mesh: {'data': 2, 'model': 2} (4 ranks on cpu)" in out
    assert out.rstrip().splitlines()[-1].startswith("distributed solve OK")
    for variant in ("C", "D", "E"):
        (relerr,) = _floats(rf"SaP-{variant}: P=8 partitions\s+iters=\s*[\d.]+\s+relerr=(\S+)"
                            r"\s+converged=True", out)
        assert relerr < XTOL
    assert re.search(r"SaP-auto @ d=0\.5 -> E \(d_factor=0\.500\)", out)

    n, k = 4096, 12
    band = J.random_banded(n, k, d=1.0, seed=0)
    xstar = np.random.default_rng(0).normal(size=n)
    b = np.asarray(J.band_to_dense(jnp.asarray(band))) @ xstar
    jx, jit = _jax_solve(band, b, p=8, variant="C", tol=1e-6, maxiter=300)
    assert got["reference"]["iterations"] == jit
    assert _relative(got["reference"]["x"], jx) <= XTOL
    # the split solve against the single process, C at the same P
    assert _relative(got["C"]["x"], got["reference"]["x"]) <= XTOL


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "rwkv6-1.6b", "zamba2-2.7b"])
def test_serve_lm(arch, capsys):
    assert _module("serve_lm").main(["--device", "cpu", "--arch", arch]) == 0
    out = capsys.readouterr().out
    assert re.search(r"served 12/12 requests, 192 tokens, \d+ engine ticks, [\d.]+s "
                     r"\([\d.]+ tok/s on the CPU\)", out)
    assert len(re.findall(r"  req \d+: prompt=\[", out)) == 3


def test_train_lm_restart(tmp_path, capsys):
    cfg = get_config("stablelm-1.6b", reduced=True)
    got = train_lm.run("cpu", cfg, steps=30, batch=4, seq=32, ckpt_dir=str(tmp_path),
                       simulate_crash=True)
    out = capsys.readouterr().out
    assert got["restarts"] == 1 and got["last_step"] == 30
    losses = _floats(r"step\s+\d+\s+loss (\S+)", out)
    assert len(losses) == 6 and all(np.isfinite(losses))
    assert got["final_loss"] < got["log"][0]["loss"]
    assert f"final loss: {got['final_loss']:.4f}  restarts: 1" in out


def test_train_lm_config_is_the_jax_scripts():
    spec = importlib.util.spec_from_file_location("jax_train_lm", ROOT / "examples" / "train_lm.py")
    jax_script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_script)
    jcfg, tcfg = jax_script.make_100m("stablelm-1.6b"), train_lm.make_100m("stablelm-1.6b")
    for f in dataclasses.fields(tcfg):
        assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
    from repro.models import get_family as jax_family
    from repro_torch.models import get_family

    jshapes = jax.eval_shape(lambda: jax_family(jcfg).init(jcfg, jax.random.PRNGKey(0)))
    j_params = sum(int(np.prod(p.shape)) for p in jax.tree.leaves(jshapes))
    t_params = sum(p.numel() for p in get_family(tcfg).init(tcfg, device="cpu").parameters())
    assert t_params == j_params


@pytest.mark.parametrize("name", EXAMPLES)
def test_no_card_is_an_error(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _module(name).main([])


def test_launch_report_at_exit():
    """The launch counts a parent reads from a child: one line at exit with
    every wrapper's count, only when the environment asks for it."""
    code = "import repro_torch.kernels.ops"
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    quiet = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                           timeout=120, check=True)
    assert ops.LAUNCH_REPORT_PREFIX not in quiet.stdout
    env[ops.REPORT_LAUNCHES_ENV] = "1"
    loud = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                          timeout=120, check=True)
    (line,) = [ln for ln in loud.stdout.splitlines() if ln.startswith(ops.LAUNCH_REPORT_PREFIX)]
    report = json.loads(line[len(ops.LAUNCH_REPORT_PREFIX):])
    assert report["launches"] == dict.fromkeys(ops.launch_counts(), 0)
    assert set(report["launches"]) == {"btf", "bts", "fused_factor_spike", "bcr_inv_odd",
                                       "bcr_reduce", "bcr_rhs_reduce", "bcr_backsub", "wkv",
                                       "ssd", "flash"}
