"""Run one benchmark cell once: set-up, a closed-loop window, the check.

Everything that belongs to one configuration, traffic mix or metric is a
file that this module finds by the name ``BENCHMARK.json`` gives it:

* ``sapbench/configs/<config>.json``: the system's sizes, the solver
  settings, the plain reference that judges it (``reference``: a module
  of ``sapbench/reference/``) and the limit of each compared number;
* ``sapbench/traffic/<mix>.json``: the mix's parameters (right-hand
  sides a request, warm-up requests, the judged sample, and what its
  generator reads), read by the generator it names;
* ``sapbench/generators/<generator>.py``: how requests are made --
  ``systems(traffic)``, the systems set-up makes; ``system(traffic, i)``,
  the one request ``i`` solves; ``start(program, bands, traffic)``, the
  set-up before the warm-up, which returns ``request(i, b)``;
* ``sapbench/metrics/<metric>.py``: a reader ``read(ctx)`` that returns
  the metric from the run's record, or None where it finds nothing.

A request's time runs from its start to its x ready on the device, after
a synchronize.  After the window a sample of the requests, drawn from the
seed, is judged against the plain reference, in float64, once the
program's state is freed.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import math
import random
import sys
import time
from pathlib import Path
from typing import Any, Callable, Optional

import torch

from . import tracing, work

SOLVER_SOURCES = ("btf", "bts", "fused_spike", "bcr")
STAGES = ("factor", "krylov")
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro", "benchmarks")


# ---------------------------------------------------------------------------
# The manifest and the files it names
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Cell:
    name: str
    root: Path
    workload: dict
    config: dict
    traffic: dict
    manifest: dict
    generator: Any  # the mix's module of sapbench/generators/


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(root: Path, name: str) -> Cell:
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    workloads = {w["name"]: w for w in manifest["workloads"]}
    if name not in workloads:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(workloads)})")
    w = workloads[name]
    cfg_entry = {c["name"]: c for c in manifest["configs"]}[w["config"]]
    config = json.loads((root / cfg_entry["file"]).read_text())
    traffic = json.loads((root / "sapbench" / "traffic" / f"{w['traffic']}.json").read_text())
    gen = traffic["generator"]
    generator = load_module(root / "sapbench" / "generators" / f"{gen}.py", "sapbench_generator_" + gen)
    return Cell(name, root, w, config, traffic, manifest, generator)


def cell_metrics(cell: Cell, trace: bool) -> list[dict]:
    """The metric entries this cell reports: end-to-end ones untraced,
    per-layer ones traced; an entry with ``workloads`` only in those."""
    group = cell.manifest["per_layer" if trace else "end_to_end"]
    return [m for m in group if cell.name in m.get("workloads", [cell.name])]


def reader(root: Path, metric: str) -> Callable[[Any], Optional[float]]:
    path = root / "sapbench" / "metrics" / f"{metric}.py"
    return load_module(path, "sapbench_metric_" + metric.replace(".", "_").replace("-", "_")).read


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one the benchmark may not load."""
    return sorted({m for m in (n.split(".", 1)[0] for n in sys.modules) if m in FORBIDDEN_MODULES})


# ---------------------------------------------------------------------------
# Inputs: systems and right-hand sides from the seed
# ---------------------------------------------------------------------------


def sub_seed(seed: int, stream: int) -> int:
    """An independent seed for one input stream of a run."""
    return (seed * 0x9E3779B97F4A7C15 + stream * 0xBF58476D1CE4E5B9) % (1 << 63)


def make_bands(count: int, n: int, k: int, d: float, seed: int, device) -> torch.Tensor:
    """``count`` band matrices (count, N, 2K+1), float32, on ``device``: the
    paper's Eq. 2.11 systems.  Off-diagonals U(-1, 1), entries outside the
    matrix zero, |a_ii| = max(d * sum_{j != i} |a_ij|, 1e-3) with the sign
    of the diagonal's own draw."""
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, 0))
    bands = torch.empty((count, n, 2 * k + 1), dtype=torch.float32, device=device)
    rows = torch.arange(k, device=device)[:, None]
    cols = torch.arange(2 * k + 1, device=device)[None, :]
    top = (cols >= k - rows).float()  # row r < K: column r - K + j >= 0
    bottom = torch.flip(top, dims=(0, 1))  # row N-K+r: column < N
    for band in bands:
        band.uniform_(-1.0, 1.0, generator=g)
        band[:k] *= top
        band[n - k:] *= bottom
        off = band.abs().sum(dim=1) - band[:, k].abs()
        band[:, k] = torch.where(band[:, k] >= 0, 1.0, -1.0) * torch.clamp(d * off, min=1e-3)
    return bands


class Sample:
    """A reservoir of ``size`` requests drawn uniformly from all requests of
    the window by a seeded stream: x and b copied into slots made before
    the window, so the sample adds no allocation inside it."""

    def __init__(self, size: int, n: int, r: int, seed: int, device):
        self.size = size
        self.rng = random.Random(sub_seed(seed, 2))
        self.x = torch.zeros((size, n, r), dtype=torch.float32, device=device)
        self.b = torch.zeros((size, n, r), dtype=torch.float32, device=device)
        self.system = [-1] * size
        self.request = [-1] * size

    def offer(self, i: int, system: int, x: torch.Tensor, b: torch.Tensor) -> None:
        slot = i if i < self.size else self.rng.randrange(i + 1)
        if slot < self.size:
            self.x[slot].copy_(x.reshape(self.x.shape[1:]))
            self.b[slot].copy_(b)
            self.system[slot] = system
            self.request[slot] = i

    def kept(self) -> list[int]:
        return [s for s in range(self.size) if self.request[s] >= 0]


# ---------------------------------------------------------------------------
# The program under test
# ---------------------------------------------------------------------------


class Program:
    """The port's entry points the window drives, set from a configuration."""

    def __init__(self, config: dict, device: torch.device):
        from repro_torch.core.sap import SaPOptions, factor, plan_banded

        self.device = device
        self._factor, self._plan = factor, plan_banded
        self.opts = SaPOptions(
            p=config["p"], variant=config["variant"], reduced_solver=config["reduced_solver"],
            tol=config["tol"], maxiter=config["maxiter"], precond_dtype=config["dtype"])

    def factor(self, band: torch.Tensor):
        return self._factor(self._plan(band, self.opts, device=self.device))

    @staticmethod
    def solve(fac, b: torch.Tensor):
        return fac.solve(b[:, 0]) if b.shape[1] == 1 else fac.solve_many(b)

    @staticmethod
    def launches() -> dict[str, int]:
        from repro_torch.kernels.ops import launch_counts

        return launch_counts()


def load_kernels() -> float:
    """Build (first run in a checkout: one nvcc process a source, all four
    at once) or load the solver's four kernel libraries; seconds taken."""
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    started = [b for name in SOLVER_SOURCES if (b := build._start_build(name)) is not None]
    try:
        for proc, tmp, out in started:
            build._finish_build(proc, tmp, out)
    finally:  # a failed build leaves no compiler running
        for proc, _, _ in started:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for name in SOLVER_SOURCES:
        build.load(name)
    return time.perf_counter() - t0


class _Card:
    def __init__(self, device: torch.device):
        self.device, self.cuda = device, device.type == "cuda"

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def allocated(self) -> int:
        return torch.cuda.memory_allocated(self.device) if self.cuda else 0

    def reset_peak(self) -> None:
        if self.cuda:
            torch.cuda.reset_peak_memory_stats(self.device)

    def peak(self) -> int:
        return torch.cuda.max_memory_allocated(self.device) if self.cuda else 0


# ---------------------------------------------------------------------------
# One run
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RunRecord:
    """What a metric reader reads (``ctx``)."""

    cell: Cell
    peaks: Optional[dict]  # the device's row of peaks.json, or None
    setup_s: float
    window_s: float
    latencies_s: list[float]
    rhs_per_request: int
    iterations: list[list[float]]  # per request, per right-hand side
    solved: int  # right-hand sides whose solve converged
    attempted: int
    failed: int
    work_mem_bytes: int
    spans: dict[str, list[float]]  # program span name -> durations (s), traced runs
    trace: Optional[tracing.TraceSummary]
    work = work

    @staticmethod
    def percentile(values: list[float], q: float) -> float:
        return percentile(values, q)


def make_inputs(cell: Cell, seed: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The cell's systems (its pool, or the one it factors) and the buffer
    each request's right-hand sides are drawn into."""
    cfg, tr = cell.config, cell.traffic
    count = cell.generator.systems(tr)
    bands = make_bands(count, cfg["n"], cfg["k"], cfg["d"], seed, device)
    r = tr["rhs_per_request"]
    b = torch.empty((cfg["n"], r), dtype=torch.float32, device=device)
    return bands, b


def judge(cell: Cell, bands: torch.Tensor, sample: Sample, solver=None) -> dict:
    """Compare the sampled answers with the plain reference in float64.

    ``solver(bands, rhs)`` (default: the sampled x) puts another solver's
    x in the program's place -- the control.  Returns the compared
    numbers, each the worst over the sample's right-hand sides, with their
    limits, and each sampled request's own numbers."""
    ref = load_module(cell.root / "sapbench" / "reference" / f"{cell.config['reference']}.py",
                      "sapbench_reference_" + cell.config["reference"])
    limits = cell.config["limits"]
    groups: dict[int, list[int]] = {}  # system -> its sampled slots
    for slot in sample.kept():
        groups.setdefault(sample.system[slot], []).append(slot)
    if not groups:
        return {"checks": {k: {"value": float("inf"), "limit": v} for k, v in limits.items()},
                "judged": 0, "reference_resid": float("nan"), "per_request": []}
    systems = sorted(groups)
    r = sample.b.shape[-1]
    width = r * max(len(g) for g in groups.values())
    columns = [(j, c, slot) for j, sys_ in enumerate(systems)
               for c, slot in enumerate(s for s in groups[sys_] for _ in range(r))]

    def side_by_side(t: torch.Tensor) -> torch.Tensor:
        """Each system's sampled (N, R) blocks as one zero-padded (N, width)."""
        out = t.new_zeros((len(systems), t.shape[1], width))
        for j, sys_ in enumerate(systems):
            out[j, :, : r * len(groups[sys_])] = torch.cat([t[s] for s in groups[sys_]], dim=-1)
        return out

    sel = bands[systems]
    rhs = side_by_side(sample.b)
    x = side_by_side(sample.x) if solver is None else solver(sel, rhs)
    x_ref = ref.solve(sel, rhs)
    rhs64, x64 = rhs.double(), x.double()

    def ratios(num: torch.Tensor, den: torch.Tensor) -> list[float]:
        q = (torch.linalg.vector_norm(num, dim=1) / torch.linalg.vector_norm(den, dim=1)).cpu()
        return [float(q[j, c]) for j, c, _ in columns]

    per_column = {
        "x_relerr": ratios(x64 - x_ref, x_ref),
        "resid": ratios(rhs64 - ref.matvec(sel, x64), rhs64),
    }

    def worst(vals: list[float]) -> float:
        return max(vals) if all(math.isfinite(v) for v in vals) else float("inf")

    per_request = [
        {"request": sample.request[slot], "system": sample.system[slot],
         **{k: worst([v[i] for i, col in enumerate(columns) if col[2] == slot])
            for k, v in per_column.items()}}
        for slot in sorted(sample.kept(), key=lambda s: sample.request[s])]
    checks = {k: {"value": worst(v), "limit": limits[k]} for k, v in per_column.items()}
    return {"checks": checks, "judged": len(columns), "per_request": per_request,
            "reference_resid": worst(ratios(rhs64 - ref.matvec(sel, x_ref), rhs64))}


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device="cuda",
             t_process: Optional[float] = None, log=sys.stderr) -> dict:
    """One run of ``cell``: returns the result line's dict (``checks``
    last).  ``t_process`` is the process's start on ``time.time()``."""
    t_process = time.time() if t_process is None else t_process
    dev = torch.device(device)
    card = _Card(dev)
    cfg, tr, gen = cell.config, cell.traffic, cell.generator
    r = tr["rhs_per_request"]

    build_s = load_kernels() if card.cuda else 0.0
    prog = Program(cfg, dev)
    bands, b = make_inputs(cell, seed, dev)
    sample = Sample(tr["judge_sample"], cfg["n"], r, seed, dev)
    inputs_bytes = card.allocated()
    g_rhs = torch.Generator(device=dev).manual_seed(sub_seed(seed, 1))
    g_warm = torch.Generator(device=dev).manual_seed(sub_seed(seed, 3))

    request = gen.start(prog, bands, tr)
    for i in range(tr["warmup"]):
        b.normal_(generator=g_warm)
        request(i, b)
    card.sync()
    setup_s = time.time() - t_process

    latencies, iterations, systems, solved, failed = [], [], [], 0, 0
    launches0 = prog.launches()
    tracer = prof = None
    rf, tracing_on, profiling = _no_range, contextlib.nullcontext(), contextlib.nullcontext()
    if trace:
        from repro_torch.obs.trace import Tracer, use_tracer

        tracer = Tracer(annotate_device=True)
        activities = [torch.profiler.ProfilerActivity.CPU]
        if card.cuda:
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = profiling = torch.profiler.profile(activities=activities)
        rf, tracing_on = torch.profiler.record_function, use_tracer(tracer)
    setup_peak = card.peak()
    card.reset_peak()
    with tracing_on, profiling:
        cpu_start = time.process_time()
        t_start = time.perf_counter()
        t_stop = t_start + seconds
        i = 0
        while time.perf_counter() < t_stop:
            with rf("sapbench.rhs"):
                b.normal_(generator=g_rhs)
            with rf(tracing.WINDOW_RANGE):
                t0 = time.perf_counter()
                res = request(i, b)
                card.sync()
                t1 = time.perf_counter()
            latencies.append(t1 - t0)
            system = gen.system(tr, i)
            its = [float(v) for v in res.iterations.reshape(-1).tolist()]
            conv = [bool(v) for v in res.converged.reshape(-1).tolist()]
            iterations.append(its)
            systems.append(system)
            solved += sum(conv)
            failed += not all(conv)
            sample.offer(i, system, res.x, b)
            del res
            i += 1
        card.sync()
        t_end = time.perf_counter()
        cpu_s = time.process_time() - cpu_start
    window_s = t_end - t_start
    window_peak = card.peak()
    launched = {k: v - launches0[k] for k, v in prog.launches().items() if v > launches0[k]}

    summary, spans = None, {}
    t_trace = time.perf_counter()
    if trace:
        host_names = {sp.name for sp in tracer.walk()} | {tracing.WINDOW_RANGE, "sapbench.rhs"}
        ranges, device_events = tracing.from_profiler(prof, host_names)
        summary = tracing.summarize(ranges, device_events, STAGES)
        spans = {name: [sp.duration_s for sp in tracer.find(name)] for name in STAGES}
        del prof, tracer, ranges, device_events
    trace_read_s = time.perf_counter() - t_trace

    del request  # the program's held state
    if card.cuda:
        torch.cuda.empty_cache()
    t_judge = time.perf_counter()
    verdict = judge(cell, bands, sample)
    judge_s = time.perf_counter() - t_judge

    device_name = torch.cuda.get_device_name(dev) if card.cuda else "cpu"
    peaks = json.loads((cell.root / "sapbench" / "peaks.json").read_text()).get(device_name)
    rec = RunRecord(
        cell=cell, peaks=peaks, setup_s=setup_s, window_s=window_s,
        latencies_s=latencies, rhs_per_request=r, iterations=iterations, solved=solved,
        attempted=len(latencies), failed=failed,
        work_mem_bytes=window_peak - inputs_bytes, spans=spans, trace=summary)
    metrics = {}
    for m in cell_metrics(cell, trace):
        value = reader(cell.root, m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    checks = verdict["checks"]
    correct = verdict["judged"] > 0 and all(c["value"] <= c["limit"] for c in checks.values())
    out = {"correct": correct, "attempted": rec.attempted, "failed": failed, "metrics": metrics,
           "device": {"platform": "gpu" if card.cuda else "cpu", "kind": device_name,
                      "count": 1, "memory_peak_bytes": max(setup_peak, window_peak)}}
    if summary is not None:
        out["device"]["busy_s"] = summary.busy_s
        out["device"]["window_s"] = summary.window_s
        out["breakdown"] = {"device_ops": summary.device_ops, "idle_gaps": summary.idle_gaps}
    out["checks"] = checks
    print(json.dumps({
        "cell": cell.name, "seed": seed, "kernels_load_s": build_s, "setup_s": setup_s,
        "window_s": window_s, "requests": rec.attempted, "judge_s": judge_s,
        "process_cpu_s": cpu_s, "trace_read_s": trace_read_s,
        "latency_ms": {q: percentile(latencies, q) * 1e3 for q in (0, 50, 95, 100)} if latencies else None,
        "judged_rhs": verdict["judged"], "reference_resid": verdict["reference_resid"],
        "sample": [{**q, "iterations": iterations[q["request"]]} for q in verdict["per_request"]],
        "launches": launched,
        "iterations_by_system": _iteration_counts(systems, iterations),
        "device_events": summary.device_events if summary else None,
        "stage_device_s": summary.stage_device_s if summary else None,
    }), file=log, flush=True)
    return out


def _iteration_counts(systems: list[int], iterations: list[list[float]]) -> dict:
    """Right-hand sides by system and iteration count: {system: {its: n}}."""
    out: dict = {}
    for system, its in zip(systems, iterations):
        for v in its:
            hist = out.setdefault(str(system), {})
            hist[str(v)] = hist.get(str(v), 0) + 1
    return out


def _no_range(name: str) -> contextlib.nullcontext:
    return contextlib.nullcontext()


def percentile(values: list[float], q: float) -> float:
    """The nearest-rank q-th percentile: the smallest value with at least
    q% of all values at or below it."""
    ordered = sorted(values)
    return ordered[max(math.ceil(q / 100 * len(ordered)) - 1, 0)]
