"""Deterministic, shard-aware data pipeline (numpy only).

The port's own copy of :mod:`repro.data.pipeline`: the same sources give
the same batches bit for bit for every ``(seed, step, shard_id)``.

Two sources:

* ``SyntheticLM`` -- an infinite stream with a learnable affine-bigram
  structure (t_{i+1} = (a t_i + b) mod V with noise), so integration tests
  can assert the training loss actually decreases.
* ``BinTokenDataset`` -- memmap-backed flat token files (production path).

Determinism & elasticity: every batch is derived from (seed, step,
shard_id), never from iterator state, so a restarted or re-sharded job
resumes bit-identically -- the data-side half of fault tolerance.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    noise: float = 0.1  # fraction of random tokens in the synthetic stream
    mult: int = 5
    add: int = 17


class SyntheticLM:
    """Infinite synthetic LM stream; batch(step) is a pure function."""

    def __init__(self, cfg: DataConfig, shard_id: int = 0, n_shards: int = 1):
        assert cfg.global_batch % n_shards == 0
        self.cfg = cfg
        self.shard_id = shard_id
        self.n_shards = n_shards
        self.local_batch = cfg.global_batch // n_shards

    def batch(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, self.shard_id])
        )
        b, s, v = self.local_batch, cfg.seq_len, cfg.vocab
        toks = np.empty((b, s), dtype=np.int32)
        toks[:, 0] = rng.integers(0, v, size=b)
        noise_mask = rng.random((b, s)) < cfg.noise
        noise_vals = rng.integers(0, v, size=(b, s))
        for t in range(1, s):
            nxt = (cfg.mult * toks[:, t - 1] + cfg.add) % v
            toks[:, t] = np.where(noise_mask[:, t], noise_vals[:, t], nxt)
        return {"tokens": toks}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch(step)
            step += 1


class BinTokenDataset:
    """Flat .bin int32 token file, memmap'd; deterministic strided batches."""

    def __init__(self, path: str | Path, cfg: DataConfig, shard_id: int = 0,
                 n_shards: int = 1):
        self.cfg = cfg
        self.tokens = np.memmap(path, dtype=np.int32, mode="r")
        self.shard_id = shard_id
        self.n_shards = n_shards
        self.local_batch = cfg.global_batch // n_shards
        self.n_windows = (len(self.tokens) - 1) // cfg.seq_len

    def batch(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, self.shard_id])
        )
        idx = rng.integers(0, self.n_windows, size=self.local_batch)
        out = np.stack(
            [self.tokens[i * cfg.seq_len : (i + 1) * cfg.seq_len] for i in idx]
        )
        return {"tokens": out.astype(np.int32)}


def make_source(cfg: DataConfig, path: str | None = None, shard_id: int = 0,
                n_shards: int = 1):
    if path:
        return BinTokenDataset(path, cfg, shard_id, n_shards)
    return SyntheticLM(cfg, shard_id, n_shards)
