"""A copy of the benchmark's files at CPU-sized shapes, for the tests."""

import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
TINY = {"n": 512, "k": 8, "p": 4}
# Limits of the tiny copies: their sound runs read at most 5.0e-6 and the
# TF32 control at least 3.4e-4 (x_relerr and resid alike, at these shapes).
TINY_LIMITS = {"x_relerr": 3e-05, "resid": 3e-05}


def tiny_root(tmp_path: Path) -> Path:
    """BENCHMARK.json and sapbench/ copied under ``tmp_path``, every
    configuration cut to N=512, K=8, P=4 and every mix to one warm-up
    request."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "sapbench", root / "sapbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    for path in (root / "sapbench" / "configs").glob("*.json"):
        cfg = json.loads(path.read_text())
        cfg.update(TINY, limits=dict(TINY_LIMITS))
        path.write_text(json.dumps(cfg))
    for path in (root / "sapbench" / "traffic").glob("*.json"):
        path.write_text(json.dumps({**json.loads(path.read_text()), "warmup": 1}))
    return root
