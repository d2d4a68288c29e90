"""Build and load the CUDA kernels in ``csrc/`` at first use.

Each ``csrc/<name>.cu`` (with the shared headers ``csrc/*.cuh``) is compiled by
``nvcc`` for ``sm_90a`` into a shared library with a plain C interface and
loaded with ``ctypes``.  Libraries go to ``build/torch_kernels/`` at the
repository root, named by a hash of the source, every header and the
flags, so an edited source or header is rebuilt and an unchanged one is
reused.  Nothing is compiled at
import time: :func:`load` runs on a kernel wrapper's first launch, and
:func:`build_all` compiles every source in parallel up front.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
SOURCES = ("btf", "bts", "fused_spike", "bcr", "wkv", "ssd", "flash_attn")
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas=-v",  # registers and spills per kernel, reported by build_all
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_D = ctypes.c_double
_L = ctypes.c_long
# C signatures of every exported float32 entry point: name -> (restype,
# argtypes).  The solver kernels' float arguments are the boost threshold,
# which the float64 entry points take as a double.
SIGNATURES = {
    "btf": {
        "btf_launch": (_I, [_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _P]),
        "btf_workspace_floats": (_L, [_I, _I]),
        "btf_cluster_size": (_I, [_I, _I]),
    },
    "bts": {
        "bts_launch": (_I, [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]),
        "bts_cluster_size": (_I, [_I, _I, _I]),
        "bts_ring_stages": (_I, [_I, _I, _I]),
        "bts_workspace_floats": (_L, [_I, _I, _I, _I]),
        "bts_bulk_route": (_I, [_P, _P, _P, _I]),
    },
    "fused_spike": {
        "fused_launch": (
            _I,
            [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _P],
        ),
        "fused_workspace_floats": (_L, [_I, _I]),
        "fused_cluster_size": (_I, [_I, _I]),
    },
    "bcr": {
        "bcr_inv_launch": (_I, [_P, _P, _P, _I, _I, _I, _F, _I, _P]),
        "bcr_inv_workspace_floats": (_L, [_I, _I]),
        "bcr_inv_max_clusters": (_I, [_I, _I]),
        "bcr_inv_cluster_size": (_I, [_I]),
        "bcr_reduce_launch": (_I, [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P]),
        "bcr_reduce_workspace_floats": (_L, [_I, _I]),
        "bcr_reduce_tile": (_I, [_I, _I]),
        "bcr_rhs_reduce_launch": (_I, [_P, _P, _P, _P, _I, _I, _I, _I, _P]),
        "bcr_rhs_reduce_split": (_I, [_I, _I, _I]),
        "bcr_backsub_launch": (_I, [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]),
        "bcr_backsub_cluster": (_I, [_I, _I, _I]),
        "bcr_backsub_max_clusters": (_I, [_I, _I, _I]),
        "bcr_solve_warps": (_I, [_I, _I]),
        "bcr_solve_vec": (_I, [_P, _P, _P, _I]),
    },
    "wkv": {
        "wkv_launch": (_I, [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]),
        "wkv_workspace_floats": (_L, [_I, _I, _I, _I]),
    },
    "ssd": {
        "ssd_launch": (_I, [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]),
        "ssd_workspace_floats": (_L, [_I, _I, _I, _I, _I]),
        "ssd_split_head_group": (_I, [_I, _I, _I, _I]),
    },
    "flash_attn": {
        "flash_launch": (_I, [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P]),
    },
}
# One entry point per storage dtype (csrc/common.cuh: SAP_DTYPE_ENTRIES):
# the solver sources export every function above again as NAME_bf16 and
# NAME_f64, the scans their launch and workspace functions as NAME_bf16.
_TYPED = {"btf": ("_bf16", "_f64"), "bts": ("_bf16", "_f64"),
          "fused_spike": ("_bf16", "_f64"), "bcr": ("_bf16", "_f64"),
          "wkv": ("_bf16",), "ssd": ("_bf16",)}
for _src, _suffixes in _TYPED.items():
    for _name, (_res, _args) in list(SIGNATURES[_src].items()):
        if _name == "ssd_split_head_group":
            continue
        for _suf in _suffixes:
            SIGNATURES[_src][_name + _suf] = (
                _res, [_D if a is _F and _suf == "_f64" else a for a in _args])
for _fns in SIGNATURES.values():
    _fns["sap_error_string"] = (ctypes.c_char_p, [_I])

_libs: dict[str, ctypes.CDLL] = {}
_load_lock = threading.Lock()  # one first build and load at a time, whatever the thread


def nvcc() -> str:
    """Path of the CUDA compiler; raises when there is none."""
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def _library_path(name: str) -> Path:
    h = hashlib.sha256()
    for part in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        h.update(part.name.encode())
        h.update(part.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start_build(name: str) -> tuple[subprocess.Popen, Path, Path] | None:
    """Start nvcc for one source unless its library is already built."""
    out = _library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, Path(tmp), out


def _finish_build(proc: subprocess.Popen, tmp: Path, out: Path) -> str:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {out.name}:\n{log}")
    os.replace(tmp, out)  # atomic: concurrent builders never see half a file
    return log


def build_all() -> dict[str, list[str]]:
    """Compile every kernel source, one nvcc process each, all in parallel.

    Returns, for each source it compiled, ptxas's lines naming each entry
    function (mangled) and giving its registers and spills.
    """
    started = {n: b for n in SOURCES if (b := _start_build(n)) is not None}
    report, errors = {}, []
    for name, (proc, tmp, out) in started.items():
        try:
            log = _finish_build(proc, tmp, out)
        except RuntimeError as exc:
            errors.append(str(exc))
            continue
        report[name] = [
            line.split(":", 1)[-1].strip()
            for line in log.splitlines()
            if "registers" in line or "spill" in line or "Compiling entry function" in line
        ]
    if errors:
        raise RuntimeError("\n".join(errors))
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if needed.
    Thread-safe: a library is built and loaded once."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _load_lock:
        lib = _libs.get(name)
        if lib is None:
            started = _start_build(name)
            if started is not None:
                _finish_build(*started)
            lib = ctypes.CDLL(str(_library_path(name)))
            for fn, (restype, argtypes) in SIGNATURES[name].items():
                getattr(lib, fn).restype = restype
                getattr(lib, fn).argtypes = argtypes
            _libs[name] = lib
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise when a launch function returned a CUDA error code."""
    if code != 0:
        msg = lib.sap_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {code} ({msg})")
