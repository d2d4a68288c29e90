"""The port's entry points a user runs: the JAX package's seven example
scripts on PyTorch, each ``python -m repro_torch.examples.<name>`` with the
script's own flags plus ``--device`` (the card when it is not given; no
card is an error, ``--device cpu`` runs the plain versions on the CPU)::

    PYTHONPATH=src python -m repro_torch.examples.quickstart
    PYTHONPATH=src python -m repro_torch.examples.fleet_solve
    PYTHONPATH=src python -m repro_torch.examples.serve_async
    PYTHONPATH=src python -m repro_torch.examples.traced_solve [--smoke] [--out DIR]
    PYTHONPATH=src python -m repro_torch.examples.distributed_solve [--ranks 8]
    PYTHONPATH=src python -m repro_torch.examples.serve_lm [--arch stablelm-1.6b]
    PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 300] [--simulate-crash]

Each times the way its JAX script does, with ``torch.cuda.synchronize()``
where the script blocks on a result, after one warm call wherever the
script warms its jit cache, and serve_lm after one short request through
an engine of its own (so a first kernel build stays out of the timed
window).
"""

from __future__ import annotations

import argparse

import torch

from ..device import resolve_device


def add_device_flag(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: the card; 'cpu' for the CPU)")


def sync(device: torch.device) -> None:
    """Wait for the card's queued work (the JAX scripts' block_until_ready)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


__all__ = ["add_device_flag", "resolve_device", "sync"]
