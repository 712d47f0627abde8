"""The port's input pipeline (``horovod_tpu_torch/data``) against the JAX
package's (``horovod_tpu/data``): on the same arrays and files the loaders
give the same batches, equal as numpy arrays, in the same order; and
``prefetch`` on the CPU (order, depth, early stop, the knob).  The card's
transfer (pinned memory, the copy stream) is in test_torch_zero_cuda.py."""

import threading
import time

import numpy as np
import pytest
import torch

from horovod_tpu import data as JD
from horovod_tpu.data import loader as JDL
from horovod_tpu.spark.store import FilesystemStore

import horovod_tpu_torch as hvd
from horovod_tpu_torch import data as TD
from horovod_tpu_torch.data import loader as TDL


def _same_batches(a, b):
    a, b = list(a), list(b)
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        if isinstance(x, dict):
            assert sorted(x) == sorted(y)
            x, y = [x[k] for k in sorted(x)], [y[k] for k in sorted(y)]
        for u, v in zip(x, y):
            assert u.dtype == v.dtype
            np.testing.assert_array_equal(u, v)
    return a


@pytest.mark.parametrize("n,workers", [(10, 4), (100, 3), (7, 8), (64, 1)])
@pytest.mark.parametrize("shuffle", [False, True])
def test_shard_indices(n, workers, shuffle):
    for r in range(workers):
        np.testing.assert_array_equal(
            TD.shard_indices(n, r, workers, shuffle=shuffle, seed=5),
            JD.shard_indices(n, r, workers, shuffle=shuffle, seed=5))


@pytest.mark.parametrize("kw", [
    dict(batch_size=4), dict(batch_size=4, drop_last=True),
    dict(batch_size=3, rank=1, num_workers=3),
    dict(batch_size=5, rank=2, num_workers=4, shuffle=True, seed=3)],
    ids=["plain", "drop_last", "sharded", "sharded-shuffled"])
def test_numpy_loader(kw):
    x = np.arange(60).reshape(30, 2)
    y = np.arange(30, dtype=np.int32)
    t, j = TD.NumpyDataLoader([x, y], **kw), JD.NumpyDataLoader([x, y], **kw)
    assert len(t) == len(j)
    for epoch in (0, 1):
        t.set_epoch(epoch)
        j.set_epoch(epoch)
        _same_batches(t, j)


def test_async_numpy_loader():
    x = np.arange(64).reshape(32, 2)
    t = TD.AsyncNumpyDataLoader([x], batch_size=5, async_loader_queue_size=2)
    j = JD.AsyncNumpyDataLoader([x], batch_size=5, async_loader_queue_size=2)
    _same_batches(t, j)
    _same_batches(t, TD.NumpyDataLoader([x], batch_size=5))


def test_async_loader_propagates_exceptions_and_stops_on_break():
    class Bad(TDL.AsyncDataLoaderMixin, TDL.BaseDataLoader):
        def _iterate(self):
            yield 1
            raise RuntimeError("boom")
    it = iter(Bad(async_loader_queue_size=2))
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="boom"):
        next(it)
    before = threading.active_count()
    dl = TD.AsyncNumpyDataLoader([np.arange(1000)], batch_size=1,
                                 async_loader_queue_size=2)
    for _ in dl:
        break
    time.sleep(0.3)
    assert threading.active_count() <= before + 1


def _parquet(tmp_path, name, columns):
    store = FilesystemStore(str(tmp_path))
    return store.write_parquet(str(tmp_path / name), columns)


@pytest.mark.parametrize("workers", [1, 2, 3, 6])
def test_parquet_loaders(tmp_path, workers):
    rng = np.random.RandomState(0)
    path = _parquet(tmp_path, "ds", {
        "x": rng.randn(20, 3).astype(np.float32),
        "y": np.arange(20, dtype=np.int64)})
    for r in range(workers):
        for tcls, jcls in ((TD.ParquetDataLoader, JD.ParquetDataLoader),
                           (TD.StreamingParquetDataLoader,
                            JDL.StreamingParquetDataLoader),
                           (TD.AsyncParquetDataLoader,
                            JD.AsyncParquetDataLoader)):
            t = tcls(path, 6, rank=r, num_workers=workers)
            j = jcls(path, 6, rank=r, num_workers=workers)
            assert len(t) == len(j) and t.num_rows == j.num_rows
            _same_batches(t, j)


def test_parquet_loader_more_workers_than_rows(tmp_path):
    path = _parquet(tmp_path, "tiny", {"y": np.arange(4, dtype=np.int64)})
    for r in range(6):
        _same_batches(TD.ParquetDataLoader(path, 2, rank=r, num_workers=6),
                      JD.ParquetDataLoader(path, 2, rank=r, num_workers=6))


@pytest.mark.parametrize("rows,buffer_rows", [(100, 5), (100, 32),
                                              (96, 96), (100, 200)])
def test_shuffle_buffer(tmp_path, rows, buffer_rows):
    path = _parquet(tmp_path, "ds", {"x": np.arange(rows, dtype=np.float64)})
    t = TD.ShuffleBufferLoader(TD.StreamingParquetDataLoader(path, 8),
                               buffer_rows=buffer_rows, seed=1)
    j = JDL.ShuffleBufferLoader(JDL.StreamingParquetDataLoader(path, 8),
                                buffer_rows=buffer_rows, seed=1)
    assert len(t) == len(j)
    for epoch in (0, 1):
        t.set_epoch(epoch)
        j.set_epoch(epoch)
        got = _same_batches(t, j)
    assert len(got) == len(t)
    with pytest.raises(ValueError, match="buffer_rows"):
        TD.ShuffleBufferLoader(None, buffer_rows=0)


def _images(root, per_class=7, size=12):
    from PIL import Image
    rng = np.random.RandomState(0)
    for c in ("cat", "dog", "owl"):
        d = root / c
        d.mkdir(parents=True)
        for i in range(per_class):
            Image.fromarray(rng.randint(0, 255, (size, size, 3),
                                        dtype=np.uint8)).save(d / f"img{i}.png")


@pytest.mark.parametrize("kw", [dict(), dict(rank=1, num_workers=2),
                                dict(shuffle=True, seed=4)],
                         ids=["plain", "sharded", "shuffled"])
def test_image_folder_loaders(tmp_path, kw):
    _images(tmp_path)
    t = TD.ImageFolderDataLoader(str(tmp_path), 4, image_size=8, **kw)
    j = JD.ImageFolderDataLoader(str(tmp_path), 4, image_size=8, **kw)
    assert t.classes == j.classes == ["cat", "dog", "owl"]
    _same_batches(t, j)
    a = TD.AsyncImageFolderDataLoader(str(tmp_path), 4, image_size=8,
                                      async_loader_queue_size=3, **kw)
    _same_batches(a, j)
    a.close()
    with pytest.raises(ValueError, match="class directories"):
        TD.ImageFolderDataLoader(str(tmp_path / "cat"), 2)


def test_list_parquet_files(tmp_path):
    d = tmp_path / "ds"
    d.mkdir()
    for name in ("part-000000011.parquet", "part-0000000000002.parquet",
                 "part-000000001.parquet", "extra.parquet", "notes.txt"):
        (d / name).write_bytes(b"")
    assert TD.list_parquet_files(str(d)) == JDL.list_parquet_files(str(d))
    assert TD.list_parquet_files(str(d / "x.parquet")) == [
        str(d / "x.parquet")]


# ------------------------------------------------------------------ prefetch
class _Source:
    """Batches 0..n-1 as ``(ids, labels)`` numpy pairs, recording how many
    were pulled."""

    def __init__(self, n):
        self.n, self.pulled = n, 0

    def __iter__(self):
        for i in range(self.n):
            self.pulled += 1
            yield (np.full((2, 3), i, np.int64), np.array([i], np.float32))


@pytest.mark.parametrize("depth", [1, 2, 5])
def test_prefetch_order_and_depth(depth):
    src = _Source(6)
    it = hvd.prefetch(src, depth=depth, device="cpu")
    first = next(it)
    assert src.pulled == min(depth, 6)  # depth batches staged before the first
    assert isinstance(first[0], torch.Tensor)
    assert first[0].device.type == "cpu" and first[0].dtype == torch.int64
    got = [first] + list(it)
    assert [int(b[1][0]) for b in got] == list(range(6))
    for i, (ids, labels) in enumerate(got):
        assert torch.equal(ids, torch.full((2, 3), i, dtype=torch.int64))


def test_prefetch_early_stop():
    src = _Source(100)
    it = hvd.prefetch(src, depth=3, device="cpu")
    for i, _ in enumerate(it):
        if i == 4:
            break
    it.close()
    # the five taken and two staged: the refill after the fifth runs only
    # when a sixth is asked for
    assert src.pulled == 7


def test_prefetch_knob_and_transfer(monkeypatch):
    monkeypatch.setenv("HOROVOD_PREFETCH_DEPTH", "4")
    src = _Source(10)
    it = hvd.prefetch(src, transfer=lambda b: ("moved", b))
    assert next(it)[0] == "moved"
    assert src.pulled == 4
    monkeypatch.setenv("HOROVOD_PREFETCH_DEPTH", "0")
    with pytest.raises(ValueError, match="HOROVOD_PREFETCH_DEPTH"):
        next(hvd.prefetch(_Source(2)))
    with pytest.raises(ValueError, match="prefetch depth"):
        next(hvd.prefetch(_Source(2), depth=0, device="cpu"))


def test_prefetch_dict_batches_and_the_runtime_device(monkeypatch):
    monkeypatch.delenv("HOROVOD_PREFETCH_DEPTH", raising=False)
    hvd.shutdown()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            next(hvd.prefetch(iter([{"x": np.zeros(2)}])))
    hvd.init(device="cpu")
    try:
        got = list(hvd.prefetch(TD.NumpyDataLoader([np.arange(6)], 4)))
        assert [b[0].tolist() for b in got] == [[0, 1, 2, 3], [4, 5]]
        d = next(hvd.prefetch(iter([{"x": np.ones(3, np.float32)}])))
        assert torch.equal(d["x"], torch.ones(3))
    finally:
        hvd.shutdown()
