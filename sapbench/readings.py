"""The two readings a cell's limits are set from, in one process.

    python3 sapbench/readings.py --workload <cell> --seeds 1,2,... \
        --control-seeds 101,102,103 --seconds 2

Lower reading: each compared number of the program's runs (a short window
of the cell's own traffic at its own sizes, judged as a benchmark run
judges it), the largest over ``--seeds``.  Upper reading: the same
numbers of the control -- the plain reference put in the program's
place and computed in TF32, the precision below the float32 the
configurations state -- on the same traffic and sample size, the
smallest over ``--control-seeds``.  Prints a line a seed and a summary
line; with ``--device cpu`` (tests) it runs on the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def control_checks(cell, seed: int, device: str) -> dict:
    """The control's numbers: the first sample-size requests of the cell's
    traffic for ``seed``, each solved by the reference in TF32."""
    import torch

    from sapbench import harness

    cfg, tr = cell.config, cell.traffic
    dev = torch.device(device)
    bands, b = harness.make_inputs(cell, seed, dev)
    sample = harness.Sample(tr["judge_sample"], cfg["n"], tr["rhs_per_request"], seed, dev)
    g_rhs = torch.Generator(device=dev).manual_seed(harness.sub_seed(seed, 1))
    for i in range(tr["judge_sample"]):
        b.normal_(generator=g_rhs)
        sample.offer(i, cell.generator.system(tr, i), torch.zeros_like(b), b)
    ref = harness.load_module(
        cell.root / "sapbench" / "reference" / f"{cfg['reference']}.py", "sapbench_control")
    return harness.judge(
        cell, bands, sample,
        solver=lambda sel, rhs: ref.solve(sel, rhs, dtype=torch.float32, tf32=True))["checks"]


def readings(cell, seeds, control_seeds, seconds: float, device: str, log=sys.stdout) -> dict:
    from sapbench import harness

    program, control = [], []
    for seed in seeds:
        out = harness.run_cell(cell, seed, seconds, False, device, log=sys.stderr)
        nums = {k: c["value"] for k, c in out["checks"].items()}
        program.append(nums)
        print(json.dumps({"side": "program", "seed": seed, "attempted": out["attempted"],
                          "failed": out["failed"], **nums}), file=log, flush=True)
    for seed in control_seeds:
        nums = {k: c["value"] for k, c in control_checks(cell, seed, device).items()}
        control.append(nums)
        print(json.dumps({"side": "control", "seed": seed, **nums}), file=log, flush=True)
    names = list((program or control)[0])
    summary = {
        "cell": cell.name,
        "lower": {k: max(p[k] for p in program) for k in names} if program else None,
        "upper": {k: min(c[k] for c in control) for k in names} if control else None,
        "limits": cell.config["limits"],
    }
    print(json.dumps(summary), file=log, flush=True)
    return summary


def _seeds(text: str) -> list[int]:
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_seeds, default=[])
    ap.add_argument("--control-seeds", type=_seeds, default=[])
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from sapbench import harness

    readings(harness.load_cell(ROOT, args.workload), args.seeds, args.control_seeds,
             args.seconds, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
