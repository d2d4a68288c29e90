"""Nothing the benchmark runs loads JAX, the JAX package ``repro`` or the
old ``benchmarks``; the plain reference loads nothing of the program.
Top-level module names are compared whole (``repro_torch`` is not
``repro``)."""

import ast
import json
import os
import subprocess
import sys

from sapbench.harness import FORBIDDEN_MODULES
from sapbench.tests.helpers import ROOT

SAPBENCH = ROOT / "sapbench"
PROGRAM = "repro_torch"


def _imported_top_levels(path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_sources_import_nothing_forbidden():
    for path in SAPBENCH.rglob("*.py"):
        found = _imported_top_levels(path) & set(FORBIDDEN_MODULES)
        assert not found, f"{path.relative_to(ROOT)} imports {found}"
    for path in (SAPBENCH / "reference").rglob("*.py"):
        found = _imported_top_levels(path) & {PROGRAM, "sapbench"}
        assert not found, f"{path.relative_to(ROOT)} imports {found}"


CHILD = r"""
import json, os, sys
from pathlib import Path
root, tiny = Path(sys.argv[1]), Path(sys.argv[2])
sys.path[:0] = [str(root), str(root / "src")]

def tops():
    return sorted({m.split(".")[0] for m in sys.modules})

import importlib.util
for path in sorted((root / "sapbench" / "reference").glob("*.py")):
    spec = importlib.util.spec_from_file_location("ref_" + path.stem, path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
after_reference = tops()
from sapbench import harness, readings, tracing, work
for path in sorted((root / "sapbench" / "metrics").glob("*.py")):
    harness.reader(root, path.stem)
with open(os.devnull, "w") as devnull:  # E, with BCR: every solver module the cells load
    harness.run_cell(harness.load_cell(tiny, "dense200k-d06.newsys"), 1, 0.02, False, "cpu",
                     log=devnull)
print(json.dumps({"after_reference": after_reference, "after_runs": tops()}))
"""


def test_a_run_loads_nothing_forbidden(tmp_path):
    from sapbench.tests.helpers import tiny_root

    tiny = tiny_root(tmp_path)
    out = subprocess.run([sys.executable, "-c", CHILD, str(ROOT), str(tiny)],
                         capture_output=True, text=True, timeout=240,
                         env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr[-3000:]
    mods = json.loads(out.stdout.strip().splitlines()[-1])
    assert PROGRAM not in mods["after_reference"]
    assert not set(mods["after_runs"]) & set(FORBIDDEN_MODULES)
    assert PROGRAM in mods["after_runs"]
