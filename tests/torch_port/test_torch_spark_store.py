"""``horovod_tpu_torch.spark.store`` against ``horovod_tpu.spark.store``:
the port writes and the JAX ``FilesystemStore.read_parquet`` reads, and the
other way round, multi-dimensional columns and their shapes restored; the
13-digit part names and the ``base_index`` namespaces; checkpoint and log
round trips, each written as tmp + rename; ``Store.create``'s dispatch on
``dbfs:/``, ``/dbfs`` and ``hdfs://`` (an injected fake namenode, as the
JAX tests use: neither this machine nor the card's has libhdfs), and
``HDFSStore``'s two errors.  Host code only: no device, no tasks."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import pickle  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from horovod_tpu.spark import store as JS  # noqa: E402
from horovod_tpu_torch.data.fs import BaseFS, LocalFS  # noqa: E402
from horovod_tpu_torch.spark import store as S  # noqa: E402
from horovod_tpu_torch.spark import (DBFSLocalStore, FilesystemStore,  # noqa: E402
                                     LocalStore, Store)


def _columns(seed=0, n=11):
    rng = np.random.RandomState(seed)
    return {"img": rng.randn(n, 3, 4).astype(np.float32),
            "vec": rng.randn(n, 5),
            "label": rng.randint(0, 10, n).astype(np.int64),
            "w": rng.rand(n)}


def _assert_same(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_parquet_crosses_between_the_packages(tmp_path, writer):
    """Written by one package, read by the other's ``read_parquet`` and by
    its own, shapes restored; the files are byte-identical."""
    cols = _columns()
    port = FilesystemStore(str(tmp_path / "port"))
    jax = JS.FilesystemStore(str(tmp_path / "jax"))
    src, dst = (port, jax) if writer == "port" else (jax, port)
    path = src.write_parquet(os.path.join(src.prefix_path, "ds"), cols)
    _assert_same(dst.read_parquet(path), cols)
    _assert_same(src.read_parquet(path), cols)
    # the same bytes from either writer
    p = port.write_parquet(str(tmp_path / "a"), cols)
    j = jax.write_parquet(str(tmp_path / "b"), cols)
    read = [open(os.path.join(d, os.listdir(d)[0]), "rb").read()
            for d in (p, j)]
    assert read[0] == read[1]


def test_encode_table_metadata_is_the_jax_schema():
    cols = _columns(seed=1)
    got, want = S._encode_table(cols), JS._encode_table(cols)
    assert got.schema.metadata == want.schema.metadata
    assert got.equals(want)
    assert S.SHAPES_KEY in got.schema.metadata


def test_part_names_and_base_index_namespaces(tmp_path):
    store = FilesystemStore(str(tmp_path))
    path = str(tmp_path / "ds")
    w0 = store.part_writer(path)
    w3 = store.part_writer(path, overwrite=False, base_index=3)
    names = [os.path.basename(w.write({"x": np.arange(2.0) + i}))
             for i, w in enumerate((w0, w0, w3))]
    assert names == ["part-0000000000000.parquet",
                     "part-0000000000001.parquet",
                     f"part-{3 << 20:013d}.parquet"]
    assert (w0.parts_written, w3.parts_written) == (2, 1)
    assert not any(f.endswith(".tmp") for f in os.listdir(path))
    # the JAX writer names the same parts; both read back in part order
    jw = JS.FilesystemStore(str(tmp_path)).part_writer(
        str(tmp_path / "j"), base_index=3)
    assert os.path.basename(jw.write({"x": np.zeros(1)})) == names[2]
    np.testing.assert_array_equal(store.read_parquet(path)["x"],
                                  [0.0, 1.0, 1.0, 2.0, 2.0, 3.0])
    # overwrite clears the dataset first
    store.part_writer(path).write({"x": np.ones(1)})
    assert len(os.listdir(path)) == 1
    assert store.is_parquet_dataset(path)
    assert not store.is_parquet_dataset(str(tmp_path / "missing"))


def test_paths_match_the_jax_store(tmp_path):
    port, jax = (m.FilesystemStore(str(tmp_path)) for m in (S, JS))
    for name in ("get_train_data_path", "get_val_data_path"):
        for idx in (None, "r1"):
            assert getattr(port, name)(idx) == getattr(jax, name)(idx)
    for name in ("get_checkpoint_path", "get_logs_path"):
        assert getattr(port, name)("r7") == getattr(jax, name)("r7")
    assert LocalStore is FilesystemStore


def test_checkpoint_and_log_round_trips(tmp_path):
    store = FilesystemStore(str(tmp_path))
    jax = JS.FilesystemStore(str(tmp_path))
    assert store.read_checkpoint("r9") is None
    assert store.read_log("r9") is None
    blob = pickle.dumps({"epoch": 2, "w": np.arange(4.0)})
    p = store.save_checkpoint("r9", blob)
    assert p.endswith("checkpoint.bin") and not os.path.exists(p + ".tmp")
    assert store.read_checkpoint("r9") == blob == jax.read_checkpoint("r9")
    store.save_checkpoint("r9", b"named", name="other.bin")
    assert store.read_checkpoint("r9", name="other.bin") == b"named"
    jax.save_log("r9", b"epoch 0 done")
    assert store.read_log("r9") == b"epoch 0 done"
    store.save_log("r9", b"epoch 1 done")
    assert jax.read_log("r9") == b"epoch 1 done"


class FakeHDFS(BaseFS):
    """A strict fake namenode: only ``hdfs://nn/`` URIs (a bare local path
    raises), kept under a local root; picklable."""

    def __init__(self, root):
        self._root = str(root)
        self._local = LocalFS()

    def _resolve(self, path):
        if not path.startswith("hdfs://nn/"):
            raise ValueError(f"non-hdfs path reached FakeHDFS: {path!r}")
        return os.path.join(self._root, path[len("hdfs://nn/"):])

    def open(self, path, mode="rb"):
        return self._local.open(self._resolve(path), mode)

    def exists(self, path):
        return self._local.exists(self._resolve(path))

    def isdir(self, path):
        return self._local.isdir(self._resolve(path))

    def listdir(self, path):
        return self._local.listdir(self._resolve(path))

    def mkdirs(self, path):
        self._local.mkdirs(self._resolve(path))

    def rmtree(self, path):
        self._local.rmtree(self._resolve(path))

    def rename(self, src, dst):
        self._local.rename(self._resolve(src), self._resolve(dst))


def test_store_create_dispatches_on_scheme(tmp_path, monkeypatch):
    assert type(Store.create(str(tmp_path))) is FilesystemStore
    s = Store.create("hdfs://nn/base", fs=FakeHDFS(tmp_path))
    assert isinstance(s, S.HDFSStore)
    assert s.get_train_data_path().startswith("hdfs://nn/base/")
    cols = _columns(seed=2, n=4)
    _assert_same(s.read_parquet(s.write_parquet(
        s.get_train_data_path("r0"), cols)), cols)
    s.save_checkpoint("r0", b"ckpt")
    assert (tmp_path / "base" / "checkpoints" / "r0" /
            "checkpoint.bin").read_bytes() == b"ckpt"
    # dbfs:/ and /dbfs go to DBFSLocalStore, on the fuse mount's paths
    made = []
    monkeypatch.setattr(S.FilesystemStore, "__init__",
                        lambda self, prefix, **kw: made.append(prefix))
    for prefix in ("dbfs:/warehouse/x", "/dbfs/warehouse/x"):
        assert type(Store.create(prefix)) is DBFSLocalStore
    assert made == ["/dbfs/warehouse/x", "/dbfs/warehouse/x"]
    for path in ("dbfs:/foo/bar", "dbfs://foo", "/other"):
        assert DBFSLocalStore.normalize_path(path) == \
            JS.DBFSLocalStore.normalize_path(path)


def test_hdfs_store_errors(tmp_path):
    with pytest.raises(ValueError, match="hdfs:// prefix"):
        S.HDFSStore("/local/path", fs=FakeHDFS(tmp_path))
    # no client passed and no libhdfs: the actionable error
    with pytest.raises(RuntimeError, match="HDFS client"):
        Store.create("hdfs://unreachable-namenode/base")
    with pytest.raises(RuntimeError, match="HDFS client"):
        S.HDFSStore("hdfs://unreachable-namenode/base")


@pytest.mark.parametrize("path,want", [
    ("hdfs://nn:8020/a/b", "/a/b"), ("hdfs://nn", "/"), ("/x/y", "/x/y")])
def test_strip_scheme_matches_jax(path, want):
    assert S._strip_scheme(path) == JS._strip_scheme(path) == want


def test_pyarrow_fs_adapter_over_a_local_pyarrow_client(tmp_path):
    """``PyArrowFS`` speaks the fs protocol over any pyarrow FileSystem;
    pyarrow's local one stands in for HDFS's here."""
    from pyarrow import fs as pafs
    fs = S.PyArrowFS(pafs.LocalFileSystem())
    root = str(tmp_path / "pa")
    store = FilesystemStore(root, fs=fs)
    cols = _columns(seed=3, n=6)
    path = store.write_parquet(store.get_train_data_path(), cols)
    assert fs.isdir(path) and fs.exists(path)
    _assert_same(store.read_parquet(path), cols)
    store.save_checkpoint("r", b"abc")
    assert store.read_checkpoint("r") == b"abc"
    assert pickle.loads(pickle.dumps(store)).read_checkpoint("r") == b"abc"
    fs.rmtree(path)
    assert not fs.exists(path)
