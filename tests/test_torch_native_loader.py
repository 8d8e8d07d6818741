"""The port's loader (penroz_tpu_torch/data/loaders.py) over the native
mmap stream (native/penroz_loader.cpp built by
penroz_tpu_torch/utils/native_build.py) against its numpy path and the
JAX package's ``Loader.next_batch``: the same batches across shard
boundaries and the wraparound, rank-strided windows, a stream rebuilt on
a same-name rewrite and on a new shard, and the numpy path for a shard
that is not uint16."""

import numpy as np
import pytest

from penroz_tpu.data import loaders as jloaders
from penroz_tpu_torch.data import loaders
from penroz_tpu_torch.utils import native_build


def _make_shards(workdir, sizes, dataset, seed=0):
    data_dir = workdir / "data"
    data_dir.mkdir(exist_ok=True)
    rng = np.random.default_rng(seed)
    for i, size in enumerate(sizes):
        np.save(data_dir / f"{dataset}_{i:06d}",
                rng.integers(0, 65536, size).astype(np.uint16))
    return dataset


def _batches(loader, n, target_offset=1):
    return [loader.next_batch(target_offset) for _ in range(n)]


def _assert_same(got, want):
    assert len(got) == len(want)
    for (x, y), (xw, yw) in zip(got, want):
        assert x.dtype == np.int32
        np.testing.assert_array_equal(x, np.asarray(xw))
        if yw is None:
            assert y is None
        else:
            np.testing.assert_array_equal(y, np.asarray(yw))


@pytest.fixture
def native(monkeypatch):
    monkeypatch.delenv(loaders.NATIVE_LOADER_ENV, raising=False)
    assert loaders._native_loader_module() is not None
    assert native_build.loaded()["penroz_loader"] is True
    return monkeypatch


@pytest.mark.parametrize("target_offset", [1, 0])
@pytest.mark.parametrize("sizes,buffer", [([100, 70, 30], 64),
                                          ([128, 128], 32),
                                          ([50], 120)])
def test_native_equals_numpy_and_jax(workdir, native, sizes, buffer,
                                     target_offset):
    """Across shard boundaries and several wraparounds (8 windows over
    fewer tokens), the native stream's batches equal the numpy path's and
    the JAX package's (its numpy path)."""
    dataset = _make_shards(workdir, sizes, "nat")
    ours = loaders.Loader(dataset, buffer_size=buffer)
    got = _batches(ours, 8, target_offset)
    assert ours._stream is not None          # really the native path
    native.setenv(loaders.NATIVE_LOADER_ENV, "0")
    plain = loaders.Loader(dataset, buffer_size=buffer)
    _assert_same(got, _batches(plain, 8, target_offset))
    assert plain._stream is None
    theirs = jloaders.Loader(dataset, buffer_size=buffer)
    _assert_same(got, _batches(theirs, 8, target_offset))
    assert (ours.shard, ours.idx) == (plain.shard, plain.idx)


def test_rank_strided_windows(workdir, native):
    dataset = _make_shards(workdir, [128, 128], "rank")
    for rank in range(2):
        kw = dict(begin_idx=32 * rank, buffer_size=32, idx_offset=64)
        native.delenv(loaders.NATIVE_LOADER_ENV, raising=False)
        got = _batches(loaders.Loader(dataset, **kw), 6)
        native.setenv(loaders.NATIVE_LOADER_ENV, "0")
        _assert_same(got, _batches(jloaders.Loader(dataset, **kw), 6))


def test_stream_rebuilt_on_rewrite_and_new_shard(workdir, native):
    dataset = _make_shards(workdir, [64], "re")
    loader = loaders.Loader(dataset, buffer_size=32)
    first, _ = loader.next_batch()
    assert loader._stream.total_tokens == 64
    # a same-name rewrite after a delete and a new download
    loader.delete()
    (workdir / "data").mkdir(exist_ok=True)
    np.save(workdir / "data" / "re_000000", np.full(64, 7, np.uint16))
    loader.shard = loader.idx = 0
    fresh, _ = loader.next_batch()
    assert (fresh == 7).all() and not np.array_equal(first, fresh)
    # a shard appended by a concurrent download
    np.save(workdir / "data" / "re_000001", np.full(64, 9, np.uint16))
    loader.next_batch()
    assert loader._stream.total_tokens == 128


def test_non_uint16_shard_takes_the_numpy_path(workdir, native):
    data_dir = workdir / "data"
    data_dir.mkdir(exist_ok=True)
    np.save(data_dir / "wide_000000", np.arange(100, dtype=np.int32))
    loader = loaders.Loader("wide", buffer_size=16)
    x, y = loader.next_batch()
    assert loader._stream is None
    np.testing.assert_array_equal(x, np.arange(16))
    np.testing.assert_array_equal(y, np.arange(1, 17))
