"""Checkpointing: atomic, restart-capable, with an asynchronous writer.

A port of :mod:`repro.train.checkpoint`.  Format: one
``step_XXXXXXXX.npz`` per checkpoint holding every leaf under a path key
(``"params/blocks.0.attn.wq"``, ``"opt/m/embed"``, ``"opt/step"``: the
port's parameter and state names joined by ``/``), written to a temp file
and atomically renamed, then ``manifest.json``.  The oldest files beyond
``keep`` are removed after each write.  bfloat16 leaves are stored as
float32 (npz has no bfloat16) and restored to the template's dtype and
device.  A tree is nested dicts and dataclasses (``AdamWState``) with
tensor, numpy or Python-number leaves; ``None`` leaves are skipped.

A background thread writes the arrays (copied to the host on the
caller's thread), so the train loop does not wait on the disk;
``wait()`` joins it, and every save waits for the previous one first.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
from pathlib import Path

import numpy as np
import torch


def _items(tree):
    if isinstance(tree, dict):
        return list(tree.items())
    if dataclasses.is_dataclass(tree):
        return [(f.name, getattr(tree, f.name)) for f in dataclasses.fields(tree)]
    return None


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(leaf)


def flatten_with_paths(tree, prefix: str = "") -> dict:
    """{path key: numpy array} for every leaf of ``tree`` (None skipped)."""
    items = _items(tree)
    if items is None:
        return {} if tree is None else {prefix: _host(tree)}
    out = {}
    for name, value in items:
        out.update(flatten_with_paths(value, f"{prefix}/{name}" if prefix else str(name)))
    return out


def _rebuild(template, data, prefix: str):
    items = _items(template)
    if items is None:
        if template is None:
            return None
        arr = data[prefix]
        if isinstance(template, torch.Tensor):
            return torch.from_numpy(np.array(arr)).to(dtype=template.dtype,
                                                      device=template.device)
        if isinstance(template, np.ndarray):
            return arr.astype(template.dtype)
        return type(template)(arr)
    new = {name: _rebuild(value, data, f"{prefix}/{name}" if prefix else str(name))
           for name, value in items}
    return new if isinstance(template, dict) else dataclasses.replace(template, **new)


class CheckpointManager:
    """Saves and restores trees under ``directory``, keeping ``keep``."""

    def __init__(self, directory: str | Path, keep: int = 3, async_save: bool = True):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_save = async_save
        self._thread: threading.Thread | None = None

    # ---- save ----------------------------------------------------------------
    def save(self, step: int, tree) -> None:
        """Write ``tree`` as step ``step`` (on the writer thread unless
        ``async_save`` is off)."""
        arrays = flatten_with_paths(tree)  # host copies on the caller's thread
        if self.async_save:
            self.wait()
            self._thread = threading.Thread(target=self._write, args=(step, arrays),
                                            daemon=True)
            self._thread.start()
        else:
            self._write(step, arrays)

    def _write(self, step: int, arrays: dict) -> None:
        tmp = self.dir / f".tmp_step_{step:08d}.npz"
        final = self.dir / f"step_{step:08d}.npz"
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
        tmp.rename(final)  # atomic on POSIX
        manifest = {"latest_step": step, "time": time.time()}
        mtmp = self.dir / ".manifest.tmp"
        mtmp.write_text(json.dumps(manifest))
        mtmp.rename(self.dir / "manifest.json")
        self._gc()

    def _gc(self) -> None:
        ckpts = sorted(self.dir.glob("step_*.npz"))
        for old in ckpts[: -self.keep]:
            old.unlink(missing_ok=True)

    def wait(self) -> None:
        """Join the writer thread, if one is running."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    # ---- restore --------------------------------------------------------------
    def latest_step(self) -> int | None:
        """The manifest's step, else the newest file's, else None."""
        mf = self.dir / "manifest.json"
        if not mf.exists():
            ckpts = sorted(self.dir.glob("step_*.npz"))
            if not ckpts:
                return None
            return int(ckpts[-1].stem.split("_")[1])
        return int(json.loads(mf.read_text())["latest_step"])

    def restore(self, step: int, template):
        """A tree shaped like ``template`` from step ``step``'s file: each
        tensor leaf in the template's dtype, on its device."""
        with np.load(self.dir / f"step_{step:08d}.npz") as data:
            return _rebuild(template, data, "")

    def restore_latest(self, template):
        """(step, tree) of the latest checkpoint, or (None, None)."""
        step = self.latest_step()
        if step is None:
            return None, None
        return step, self.restore(step, template)
