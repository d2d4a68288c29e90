"""Training loop: microbatched, with int8 gradient compression, restartable.

A port of :mod:`repro.train.loop`:

* ``make_train_step``: loss and gradients (``backward`` through the
  family's ``loss``; on the card through the kernels' autograd Functions,
  :mod:`repro_torch.kernels.autograd`), optionally accumulated over
  microbatches, optionally through the int8 error-feedback round trip,
  then AdamW -- every update in place.
* ``TrainLoop``: data -> step -> metrics with periodic asynchronous
  checkpoints, restart from the latest checkpoint, a straggler monitor
  (each step's wall time against the running median) and a fault hook the
  tests use to prove crash recovery.  It runs on the card unless
  ``device`` names another.

Left out: the JAX loop's ``mesh`` argument and ``TrainConfig.zero1``
(read by none of its training code) -- the distributed path, a later
slice, adds what it reads.
"""

from __future__ import annotations

import dataclasses
import tempfile
import time
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from .. import optim
from ..data.pipeline import DataConfig, make_source
from ..device import resolve_device
from ..models import get_family
from ..models.api import ModelConfig
from .checkpoint import CheckpointManager


@dataclasses.dataclass
class TrainConfig:
    """The JAX package's loop settings, with its defaults (the checkpoint
    directory under the temp directory), less its unread ``zero1``."""

    steps: int = 100
    microbatches: int = 1  # gradient accumulation factor
    checkpoint_every: int = 50
    checkpoint_dir: str = dataclasses.field(
        default_factory=lambda: str(Path(tempfile.gettempdir()) / "repro_torch_ckpt"))
    keep_checkpoints: int = 3
    log_every: int = 10
    grad_compress: bool = False  # int8 error-feedback round trip of every gradient
    straggler_factor: float = 2.5  # flag a step slower than factor * median
    seed: int = 0


def _microbatches(batch: dict, n: int) -> list[dict]:
    """``batch`` split along its leading axis into ``n`` equal parts, in
    order (the JAX loop's reshape to (n, B / n, ...))."""
    for name, x in batch.items():
        if x.shape[0] % n:
            raise ValueError(f"batch[{name!r}] has {x.shape[0]} rows, not a multiple of "
                             f"microbatches={n}")
    parts = {name: x.chunk(n, dim=0) for name, x in batch.items()}
    return [{name: p[i] for name, p in parts.items()} for i in range(n)]


def make_train_step(cfg: ModelConfig, opt_cfg: optim.AdamWConfig, train_cfg: TrainConfig):
    """``step(model, opt_state, err_state, batch) -> metrics``: one
    optimizer step on ``batch`` (a dict of tensors: ``tokens``, and
    ``patches`` or ``frames`` where the family reads them).  The model's
    parameters, ``opt_state`` and ``err_state`` are updated in place; the
    metrics (``loss``, ``nll``, ``aux``, ``grad_norm``, ``lr``) are 0-d
    tensors but ``lr``.  With microbatches the gradient is the mean of the
    microbatches' and ``loss`` their mean loss (``aux`` 0), as in the JAX
    loop.  A parameter the loss does not reach gets a zero gradient."""
    fam = get_family(cfg)
    nmicro = train_cfg.microbatches

    def step(model, opt_state, err_state, batch):
        params = dict(model.named_parameters())
        for p in params.values():
            p.grad = None
        if nmicro == 1:
            total, metrics = fam.loss(cfg, model, batch)
            total.backward()
            loss = total.detach()
            metrics = {name: v.detach() for name, v in metrics.items()}
        else:
            lsum = None
            for mb in _microbatches(batch, nmicro):
                total, _ = fam.loss(cfg, model, mb)
                total.backward()  # sums into .grad
                lsum = total.detach() if lsum is None else lsum + total.detach()
            loss = lsum / nmicro
            metrics = {"nll": loss, "aux": torch.zeros((), device=loss.device)}
        grads = {}
        for name, p in params.items():
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            grads[name] = g / nmicro if nmicro > 1 else g
        if train_cfg.grad_compress:
            grads, new_err = optim.compress.compress_tree(grads, err_state)
            err_state.update(new_err)
        om = optim.apply_updates(opt_cfg, params, grads, opt_state)
        for p in params.values():
            p.grad = None
        return {**metrics, **om, "loss": loss}

    return step


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class TrainLoop:
    """Single-process training driver with restart and a straggler monitor."""

    def __init__(
        self,
        cfg: ModelConfig,
        opt_cfg: optim.AdamWConfig,
        train_cfg: TrainConfig,
        data_cfg: Optional[DataConfig] = None,
        fault_hook: Optional[Callable[[int], None]] = None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.opt_cfg = opt_cfg
        self.train_cfg = train_cfg
        self.fam = get_family(cfg)
        self.data_cfg = data_cfg or DataConfig(
            vocab=cfg.vocab, seq_len=256, global_batch=8, seed=train_cfg.seed
        )
        self.source = make_source(self.data_cfg)
        self.ckpt = CheckpointManager(train_cfg.checkpoint_dir, keep=train_cfg.keep_checkpoints)
        self.fault_hook = fault_hook
        self.step_fn = make_train_step(cfg, opt_cfg, train_cfg)
        self.metrics_log: list[dict] = []

    # ------------------------------------------------------------------
    def init_state(self):
        """(model with trainable parameters from ``train_cfg.seed``, AdamW
        state, error state -- empty without ``grad_compress``)."""
        gen = torch.Generator(self.device).manual_seed(self.train_cfg.seed)
        model = self.fam.init(self.cfg, gen, device=self.device).requires_grad_(True)
        params = dict(model.named_parameters())
        opt_state = optim.init(params)
        err_state = (optim.compress.init_error_state(params) if self.train_cfg.grad_compress
                     else {})
        return model, opt_state, err_state

    def batch(self, step: int) -> dict:
        """The source's batch for ``step``, on the loop's device."""
        return {name: torch.from_numpy(x).to(self.device)
                for name, x in self.source.batch(step).items()}

    def run(self, resume: bool = True) -> dict:
        """Train to ``train_cfg.steps`` (from the latest checkpoint when
        ``resume``): {"params": the model, "opt", "final_loss", "log",
        "last_step"}."""
        model, opt_state, err_state = self.init_state()
        params = dict(model.named_parameters())
        start_step = 0
        if resume:
            latest = self.ckpt.latest_step()
            if latest is not None:
                tmpl = {"params": params, "opt": opt_state, "err": err_state}
                restored = self.ckpt.restore(latest, tmpl)
                with torch.no_grad():
                    for name, p in params.items():
                        p.copy_(restored["params"][name])
                opt_state = restored["opt"]
                err_state = restored["err"]
                start_step = latest
        times: list[float] = []
        step = start_step
        metrics = {"loss": float("nan"), "grad_norm": float("nan"), "lr": float("nan")}
        while step < self.train_cfg.steps:
            batch = self.batch(step)
            t0 = time.perf_counter()
            if self.fault_hook is not None:
                self.fault_hook(step)  # may raise to simulate a crash
            metrics = self.step_fn(model, opt_state, err_state, batch)
            _sync(self.device)
            dt = time.perf_counter() - t0
            times.append(dt)
            med = float(np.median(times[-50:]))
            straggler = len(times) > 5 and dt > self.train_cfg.straggler_factor * med
            step += 1
            if step % self.train_cfg.log_every == 0 or step == self.train_cfg.steps:
                self.metrics_log.append({
                    "step": step,
                    "loss": float(metrics["loss"]),
                    "grad_norm": float(metrics["grad_norm"]),
                    "lr": float(metrics["lr"]),
                    "step_time_s": dt,
                    "straggler": bool(straggler),
                })
            if step % self.train_cfg.checkpoint_every == 0:
                self.ckpt.save(step, {"params": params, "opt": opt_state, "err": err_state})
        self.ckpt.wait()
        return {
            "params": model,
            "opt": opt_state,
            "final_loss": float(metrics["loss"]),
            "log": self.metrics_log,
            "last_step": step,
        }


def run_with_restarts(loop_factory: Callable[[], TrainLoop], max_restarts: int = 3):
    """Supervisor: build a loop and run it, restarting from the latest
    checkpoint after a RuntimeError, at most ``max_restarts`` times:
    (result, restarts)."""
    attempts = 0
    while True:
        loop = loop_factory()
        try:
            return loop.run(resume=True), attempts
        except RuntimeError:
            attempts += 1
            if attempts > max_restarts:
                raise
