"""The port's data pipeline against the JAX package's: the same batches,
bit for bit, for every (seed, step, shard) -- the synthetic stream and the
memmapped token file, each built directly and through ``make_source`` --
and the ports of the JAX package's unit tests of both sources."""

import numpy as np
import pytest

from repro import data as jdata
from repro_torch import data


@pytest.mark.parametrize("seed", [0, 1, 17])
@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_synthetic_batches_equal_the_jax_packages(seed, n_shards):
    kw = dict(vocab=97, seq_len=33, global_batch=8, seed=seed, noise=0.2)
    mine, theirs = data.DataConfig(**kw), jdata.DataConfig(**kw)
    for shard in range(n_shards):
        a = data.SyntheticLM(mine, shard, n_shards)
        b = jdata.SyntheticLM(theirs, shard, n_shards)
        c = data.make_source(mine, shard_id=shard, n_shards=n_shards)
        assert isinstance(c, data.SyntheticLM)
        for step in (0, 1, 5, 123):
            got, want = a.batch(step)["tokens"], b.batch(step)["tokens"]
            assert got.dtype == want.dtype == np.int32
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(c.batch(step)["tokens"], want)


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("n_shards", [1, 2])
def test_bin_batches_equal_the_jax_packages(tmp_path, seed, n_shards):
    path = tmp_path / "toks.bin"
    np.random.default_rng(seed).integers(0, 50_000, size=20_000, dtype=np.int32).tofile(path)
    kw = dict(vocab=50_000, seq_len=64, global_batch=4, seed=seed)
    for shard in range(n_shards):
        a = data.BinTokenDataset(path, data.DataConfig(**kw), shard, n_shards)
        b = jdata.BinTokenDataset(path, jdata.DataConfig(**kw), shard, n_shards)
        c = data.make_source(data.DataConfig(**kw), str(path), shard, n_shards)
        assert isinstance(c, data.BinTokenDataset)
        for step in (0, 3, 77):
            want = b.batch(step)["tokens"]
            np.testing.assert_array_equal(a.batch(step)["tokens"], want)
            np.testing.assert_array_equal(c.batch(step)["tokens"], want)


def test_synthetic_iterator_and_config_fields_match():
    import dataclasses

    kw = dict(vocab=31, seq_len=8, global_batch=2)
    assert dataclasses.asdict(data.DataConfig(**kw)) == dataclasses.asdict(jdata.DataConfig(**kw))
    it = iter(data.SyntheticLM(data.DataConfig(**kw)))
    ref = jdata.SyntheticLM(jdata.DataConfig(**kw))
    for step in range(3):
        np.testing.assert_array_equal(next(it)["tokens"], ref.batch(step)["tokens"])


def test_synthetic_structure_learnable():
    dc = data.DataConfig(vocab=97, seq_len=32, global_batch=4, noise=0.0)
    b = data.SyntheticLM(dc).batch(0)["tokens"]
    nxt = (dc.mult * b[:, :-1] + dc.add) % dc.vocab
    np.testing.assert_array_equal(b[:, 1:], nxt)


def test_bin_dataset(tmp_path):
    path = tmp_path / "toks.bin"
    np.arange(10_000, dtype=np.int32).tofile(path)
    dc = data.DataConfig(vocab=50_000, seq_len=64, global_batch=4)
    b = data.BinTokenDataset(path, dc).batch(3)
    assert b["tokens"].shape == (4, 64)
    np.testing.assert_array_equal(b["tokens"], data.BinTokenDataset(path, dc).batch(3)["tokens"])
