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

With a rank mesh (:mod:`repro_torch.launch.mesh`), ``make_train_step``
returns the step that ``jax.jit`` makes of the JAX package's step given
parameter and optimizer-state shardings (``launch/dryrun.py``): each rank
takes its blocks of the parameters (``fam.param_pspecs``,
:func:`repro_torch.models.sharded.shard_model`), of the batch
(``fam.batch_pspecs``) and of the AdamW state (``opt_state_pspecs(...,
zero1=train_cfg.zero1)``, :func:`init_sharded_opt_state`), and updates
them in place.  ``TrainLoop`` drives the single process only: it has no
``mesh`` argument (the JAX loop stores one and reads it nowhere); a
sharded run calls ``make_train_step(..., mesh=...)`` on each rank.
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
    directory under the temp directory).  ``zero1`` is read by the sharded
    step only."""

    steps: int = 100
    microbatches: int = 1  # gradient accumulation factor
    checkpoint_every: int = 50
    checkpoint_dir: str = dataclasses.field(
        default_factory=lambda: str(Path(tempfile.gettempdir()) / "repro_torch_ckpt"))
    keep_checkpoints: int = 3
    log_every: int = 10
    zero1: bool = False  # shard AdamW's moments over "data" (sharded step)
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


def make_train_step(cfg: ModelConfig, opt_cfg: optim.AdamWConfig, train_cfg: TrainConfig,
                    mesh=None):
    """``step(model, opt_state, err_state, batch) -> metrics``: one
    optimizer step on ``batch`` (a dict of tensors: ``tokens``, and
    ``patches`` or ``frames`` where the family reads them).  The model's
    parameters, ``opt_state`` and ``err_state`` are updated in place; the
    metrics (``loss``, ``nll``, ``aux``, ``grad_norm``, ``lr``) are 0-d
    tensors but ``lr``.  With microbatches the gradient is the mean of the
    microbatches' and ``loss`` their mean loss (``aux`` 0), as in the JAX
    loop.  A parameter the loss does not reach gets a zero gradient.

    With ``mesh``: the sharded step (:func:`_sharded_step`)."""
    if mesh is not None:
        return _sharded_step(cfg, opt_cfg, train_cfg, mesh)
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


def zero1_dims(cfg: ModelConfig, model, mesh, zero1: bool) -> dict:
    """``{parameter name: the dimension its moments split over "data", or
    None}`` by ``zero1_pspecs`` (None everywhere without ``zero1``)."""
    from ..models.sharded import param_specs

    specs = param_specs(cfg, mesh)
    params = dict(model.named_parameters())
    if not zero1:
        return {n: None for n in params}
    mspecs = optim.zero1_pspecs({n: specs[n] for n in params}, params, mesh)
    out = {}
    for n in params:
        m, s = tuple(mspecs[n]), tuple(specs[n])
        s += (None,) * (len(m) - len(s))
        out[n] = next((i for i, (a, b) in enumerate(zip(m, s)) if a == "data" and b != "data"),
                      None)
    return out


def _zero1_view(t: torch.Tensor, dim: Optional[int], mesh) -> torch.Tensor:
    """The data rank's slice of ``t`` along ``dim`` (``t`` for None)."""
    if dim is None:
        return t
    n = t.shape[dim] // mesh.shape["data"]
    return t.narrow(dim, mesh.axis_index(("data",)) * n, n)


def init_sharded_opt_state(cfg: ModelConfig, model, mesh, zero1: bool = False):
    """The rank's block of a fresh AdamW state of the rank's model
    (:func:`repro_torch.models.sharded.shard_model`): by the parameters'
    specs, or by ``zero1_pspecs`` -- each data rank's slice of ``m`` and
    ``v`` -- with ``zero1``."""
    dims = zero1_dims(cfg, model, mesh, zero1)
    return optim.init({n: _zero1_view(p.detach(), dims[n], mesh)
                       for n, p in model.named_parameters()})


def init_sharded_error_state(cfg: ModelConfig, model, mesh) -> dict:
    """Zero int8 error feedback for the sharded step with
    ``grad_compress``: the rank's block of every parameter of its model
    (:func:`repro_torch.models.sharded.shard_model`), float32 (never
    sliced by ZeRO-1: the round trip comes before the slicing)."""
    return optim.compress.init_error_state(dict(model.named_parameters()))


def scale_over_model(top: torch.Tensor, mesh, split_leaf: bool) -> torch.Tensor:
    """A compressed leaf's largest ``|g + err|`` from the rank's block:
    the max over "model" where the leaf is split there (every rank then
    quantizes its block with the whole leaf's scale), the block's own for
    a replicated leaf."""
    from ..models.tensor_parallel import max_over_model

    return max_over_model(top.reshape(1), mesh).reshape(()) if split_leaf else top


def _sharded_step(cfg: ModelConfig, opt_cfg: optim.AdamWConfig, train_cfg: TrainConfig, mesh):
    """``step(model, opt_state, err_state, batch) -> metrics`` on the rank's
    blocks: ``model`` from ``shard_model``, ``opt_state`` from
    :func:`init_sharded_opt_state` (with ``train_cfg.zero1``), ``batch``
    the rank's block by ``batch_pspecs``.  The gradient is averaged over
    the data axes; the global norm sums the squares of a "model"-split
    leaf over "model" and counts a replicated leaf once; with ZeRO-1 each
    data rank updates its slice of every parameter (and of ``m``, ``v``)
    and the slices are gathered over "data" after the update.  Metrics as
    the single process's (``nll`` = ``loss``, ``aux`` 0).  With
    ``grad_compress`` the averaged gradients go through the int8 round
    trip first, as the single process's do: ``err_state`` from
    :func:`init_sharded_error_state`, a split leaf's scale the whole
    leaf's (:func:`scale_over_model`), and the global norm and the update
    taken from the compressed gradients."""
    from ..core.distributed import all_reduce_axis
    from ..launch.sharding import P, gather_shards, spec_axes
    from ..models import sharded

    nmicro = train_cfg.microbatches
    specs = sharded.param_specs(cfg, mesh)
    split = {n for n, sp in specs.items() if "model" in spec_axes(sp)}
    dims_cache: dict = {}

    def step(model, opt_state, err_state, batch):
        params = dict(model.named_parameters())
        if nmicro == 1:
            loss, grads = sharded.value_and_grad(cfg, model, batch, mesh)
        else:
            loss, grads = None, None
            for mb in _microbatches(batch, nmicro):
                l_mb, g_mb = sharded.value_and_grad(cfg, model, mb, mesh)
                loss = l_mb if loss is None else loss + l_mb
                if grads is None:
                    grads = g_mb
                else:
                    for n in grads:
                        grads[n] += g_mb[n]
            loss = loss / nmicro
            grads = {n: g / nmicro for n, g in grads.items()}
        if train_cfg.grad_compress:
            leaves: dict = {}
            for n in grads:
                leaves.setdefault(optim.compress.leaf_key(n), []).append(n)
            for names in leaves.values():  # a leaf at a time: one leaf's copies held
                out, new_err = optim.compress.compress_tree(
                    {n: grads[n] for n in names}, err_state,
                    leaf_max=lambda names_, top: scale_over_model(top, mesh, names_[0] in split))
                grads.update(out)
                err_state.update(new_err)
        dev = loss.device
        sq_split = torch.zeros((), dtype=torch.float32, device=dev)
        sq_rep = torch.zeros((), dtype=torch.float32, device=dev)
        for n, g in grads.items():
            sq = g.float().pow(2).sum()
            if n in split:
                sq_split += sq
            else:
                sq_rep += sq
        if mesh.shape.get("model", 1) > 1:
            sq_split = all_reduce_axis(sq_split, mesh, "model")
        gnorm = torch.sqrt(sq_split + sq_rep)
        if "dims" not in dims_cache:
            dims_cache["dims"] = zero1_dims(cfg, model, mesh, train_cfg.zero1)
        dims = dims_cache["dims"]
        with torch.no_grad():
            p_views = {n: _zero1_view(p, dims[n], mesh) for n, p in params.items()}
            g_views = {n: _zero1_view(g, dims[n], mesh) for n, g in grads.items()}
            om = optim.apply_updates(opt_cfg, p_views, g_views, opt_state, gnorm=gnorm)
            for n, d in dims.items():
                if d is not None:
                    spec = P(*([None] * d + ["data"]))
                    params[n].copy_(gather_shards(p_views[n].contiguous(), spec, mesh))
        zero = torch.zeros((), device=dev)
        return {"nll": loss, "aux": zero, **om, "loss": loss}

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
