"""The port's data pipeline against the JAX package's: the same synthetic
shard files, and the same batches, bit for bit and in the same order."""

from __future__ import annotations

import os

import numpy as np
import pytest

from gpt_2_distributed_tpu.data import dataloader as jax_loader
from gpt_2_distributed_tpu.data.synthetic import write_synthetic_shards as jax_write
from gpt_2_distributed_torch.data import dataloader
from gpt_2_distributed_torch.data.synthetic import write_synthetic_shards


def test_synthetic_shards_are_the_jax_packages_files(tmp_path):
    kw = dict(num_shards=3, tokens_per_shard=3000, vocab_size=257, seed=5)
    ours = write_synthetic_shards(str(tmp_path / "torch"), **kw)
    theirs = jax_write(str(tmp_path / "jax"), **kw)
    assert [os.path.basename(p) for p in ours] == [os.path.basename(p) for p in theirs]
    for a, b in zip(ours, theirs):
        assert open(a, "rb").read() == open(b, "rb").read()


def _batches(mod, shard_dir, workers, epoch, skip=0, **kw):
    ds = mod.TokenShardDataset(mod.get_shard_paths(shard_dir, "train"), seq_len=32,
                               process_index=0, process_count=1, num_workers=workers,
                               vocab_size=257, **kw)
    ds.set_epoch(epoch)
    loader = mod.create_dataloader(ds, batch_size=3, prefetch_factor=2, skip_batches=skip)
    return ds.batches_per_epoch(3), list(loader)


@pytest.mark.parametrize("workers", [1, 2])
def test_loader_yields_the_jax_loaders_batches(shard_dir, workers):
    for epoch, skip in ((0, 0), (1, 0), (1, 7)):
        n, ours = _batches(dataloader, shard_dir, workers, epoch, skip)
        n_j, theirs = _batches(jax_loader, shard_dir, workers, epoch, skip)
        assert n == n_j and len(ours) == len(theirs) == n - skip > 0
        for (x, y), (xj, yj) in zip(ours, theirs):
            assert x.dtype == np.int32 and x.shape == (3, 32)
            np.testing.assert_array_equal(x, xj)
            np.testing.assert_array_equal(y, yj)


def test_eval_window_striding_matches_jax(shard_dir):
    ours = _batches(dataloader, shard_dir, 1, 0, shard_windows=True)[1]
    theirs = _batches(jax_loader, shard_dir, 1, 0, shard_windows=True)[1]
    assert len(ours) == len(theirs) > 0
    assert all(np.array_equal(a[0], b[0]) for a, b in zip(ours, theirs))


def test_corrupt_token_fails_loudly(tmp_path):
    path = tmp_path / "bad_train_000001.bin"
    np.full(200, 300, "<u2").tofile(path)
    ds = dataloader.TokenShardDataset([str(path)], seq_len=16, num_workers=1, vocab_size=257)
    with pytest.raises(RuntimeError, match="data worker 0 failed") as exc:
        list(dataloader.create_dataloader(ds, batch_size=2))
    assert "vocab_size" in str(exc.value.__cause__)
