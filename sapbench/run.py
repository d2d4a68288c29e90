"""Run one cell of the benchmark once and print its result line.

    python3 sapbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  Needs a CUDA card: without one, or with
fewer cards than the cell asks for, it exits with code 2 and prints no
result.  The last line of standard output is the result (JSON: correct,
attempted, failed, metrics, device, with ``--trace 1`` breakdown, and
last the checks, each compared number beside its limit); the checks are
also the last lines of standard error.
"""

import time

T_PROCESS = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _power_limit() -> str:
    """The card's name and power limit as nvidia-smi prints them, or why not."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi: {exc}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from sapbench import harness

    cell = harness.load_cell(ROOT, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.workload["chips"]:
        print(f"{cell.name} needs {cell.workload['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_PROCESS)
    print(f"card: {_power_limit()}", file=sys.stderr, flush=True)  # after the window: not set-up
    found = harness.forbidden_modules()
    if found:
        print(f"modules the benchmark may not load are loaded: {', '.join(found)}",
              file=sys.stderr)
        return 3
    for name, check in out["checks"].items():
        print(f"check {name} {check['value']!r} limit {check['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
