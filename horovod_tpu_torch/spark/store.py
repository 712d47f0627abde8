"""Store: where prepared training data, checkpoints and run logs live; the
port of ``horovod_tpu/spark/store.py``.

Reference: horovod/spark/common/store.py:36-530 — FilesystemStore keeps
train/val parquet, per-run checkpoints and logs under a base directory;
HDFS/DBFS variants change only path handling and the byte-transport
client.  Here that boundary is explicit: ONE store implementation
(:class:`FilesystemStore`) runs over the seven-method filesystem protocol
of the port's ``data/fs.py``, and the remote variants swap the fs object:
:class:`HDFSStore` takes an ``hdfs://`` prefix plus an injected (or
pyarrow-constructed) client, :class:`DBFSLocalStore` rewrites ``dbfs:/``
paths onto the fuse mount.

Datasets are DIRECTORIES of ``part-NNNNNNNNNNNNN.parquet`` files.  The
prepare step appends parts (from one driver streaming chunks, or from many
Spark partitions writing in parallel; ``spark/prepare.py``), so no single
process ever has to hold the dataset.  The files are the JAX package's
format, shape metadata included, so a Store written by either package
reads and resumes in the other.  This is host code: nothing here touches a
device.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Optional

import numpy as np

from ..data.fs import BaseFS, LocalFS

SHAPES_KEY = b"horovod_tpu_shapes"  # the schema metadata data/loader.py reads


class Store:
    """Abstract store surface (reference: store.py:36-100)."""

    fs: BaseFS

    def get_train_data_path(self, idx: Optional[str] = None) -> str:
        raise NotImplementedError

    def get_val_data_path(self, idx: Optional[str] = None) -> str:
        raise NotImplementedError

    def get_checkpoint_path(self, run_id: str) -> str:
        raise NotImplementedError

    def get_logs_path(self, run_id: str) -> str:
        raise NotImplementedError

    def exists(self, path: str) -> bool:
        raise NotImplementedError

    def is_parquet_dataset(self, path: str) -> bool:
        raise NotImplementedError

    def save_log(self, run_id: str, payload: bytes) -> str:
        raise NotImplementedError

    def read_log(self, run_id: str) -> Optional[bytes]:
        raise NotImplementedError

    @staticmethod
    def create(prefix_path: str, **kwargs) -> "Store":
        """The store for ``prefix_path``'s scheme (reference: store.py
        Store.create): ``dbfs:/`` and ``/dbfs`` to :class:`DBFSLocalStore`,
        ``hdfs://`` to :class:`HDFSStore`, anything else to
        :class:`FilesystemStore`."""
        if prefix_path.startswith("dbfs:/") or \
                prefix_path.startswith("/dbfs"):
            return DBFSLocalStore(prefix_path, **kwargs)
        if prefix_path.startswith("hdfs://"):
            return HDFSStore(prefix_path, **kwargs)
        return FilesystemStore(prefix_path, **kwargs)


def _encode_table(columns: Dict[str, np.ndarray]):
    """A column dict as a pyarrow table.  Parquet columns are 1-D, so a
    multi-dimensional column is stored as one flat list a row, and its
    trailing shape rides the schema metadata under ``horovod_tpu_shapes``
    (decoded by ``data/loader.py`` ``decode_table``)."""
    import pyarrow as pa

    flat = {}
    meta: Dict[str, Any] = {}
    for name, arr in columns.items():
        arr = np.asarray(arr)
        if arr.ndim > 1:
            meta[name] = list(arr.shape[1:])
            flat[name] = list(arr.reshape(arr.shape[0], -1))
        else:
            flat[name] = arr
    table = pa.table(flat)
    return table.replace_schema_metadata({SHAPES_KEY: json.dumps(meta)
                                          .encode()})


def _write_atomic(fs: BaseFS, path: str, write) -> None:
    """``write(f)`` into ``path + ".tmp"``, then rename onto ``path``, so a
    reader never sees a half-written file."""
    tmp = path + ".tmp"
    with fs.open(tmp, "wb") as f:
        write(f)
    fs.rename(tmp, path)


class ParquetPartWriter:
    """Appends column-dict chunks to a dataset as part files.
    ``base_index`` namespaces the part numbers, so N writers (one per
    Spark partition) append to the same dataset without coordination:
    partition p writes parts p * stride + i.  Names have 13 digits, which
    covers ``base_index`` up to about 9.5e6 at the default 2**20 stride and
    keeps the lexicographic listing in numeric order."""

    def __init__(self, store: "FilesystemStore", path: str,
                 base_index: int = 0, stride: int = 1 << 20):
        self.store = store
        self.path = path
        self._next = base_index * stride
        self._wrote = 0

    def write(self, columns: Dict[str, np.ndarray]) -> str:
        import pyarrow.parquet as pq

        fs = self.store.fs
        fs.mkdirs(self.path)
        out = fs.join(self.path, f"part-{self._next:013d}.parquet")
        table = _encode_table(columns)
        _write_atomic(fs, out, lambda f: pq.write_table(table, f))
        self._next += 1
        self._wrote += 1
        return out

    @property
    def parts_written(self) -> int:
        return self._wrote


class FilesystemStore(Store):
    """Storage over a filesystem object (reference: store.py:103-330).
    With the default ``LocalFS`` this is local, NFS or fuse-mounted
    storage; remote stores pass another fs with POSIX path joining."""

    def __init__(self, prefix_path: str,
                 train_path: Optional[str] = None,
                 val_path: Optional[str] = None,
                 checkpoint_path: Optional[str] = None,
                 logs_path: Optional[str] = None,
                 fs: Optional[BaseFS] = None):
        self.fs = fs or LocalFS()
        j = self.fs.join
        self.prefix_path = prefix_path
        self._train = train_path or j(prefix_path, "intermediate_train_data")
        self._val = val_path or j(prefix_path, "intermediate_val_data")
        self._ckpt = checkpoint_path or j(prefix_path, "checkpoints")
        self._logs = logs_path or j(prefix_path, "logs")
        self.fs.mkdirs(prefix_path)

    def get_train_data_path(self, idx: Optional[str] = None) -> str:
        return self._train if idx is None else f"{self._train}.{idx}"

    def get_val_data_path(self, idx: Optional[str] = None) -> str:
        return self._val if idx is None else f"{self._val}.{idx}"

    def get_checkpoint_path(self, run_id: str) -> str:
        return self.fs.join(self._ckpt, run_id)

    def get_logs_path(self, run_id: str) -> str:
        return self.fs.join(self._logs, run_id)

    def exists(self, path: str) -> bool:
        return self.fs.exists(path)

    def is_parquet_dataset(self, path: str) -> bool:
        if not self.fs.exists(path):
            return False
        if not self.fs.isdir(path):
            return path.endswith(".parquet")
        return any(f.endswith(".parquet") for f in self.fs.listdir(path))

    # ---- data prep -------------------------------------------------------
    def part_writer(self, path: str, overwrite: bool = True,
                    base_index: int = 0) -> ParquetPartWriter:
        """A writer of one part file per chunk of rows.  ``overwrite``
        clears the dataset first: only one caller (the driver, before it
        fans out) should pass it."""
        if overwrite and self.fs.exists(path):
            self.fs.rmtree(path)
        return ParquetPartWriter(self, path, base_index=base_index)

    def write_parquet(self, path: str, columns: Dict[str, np.ndarray],
                      overwrite: bool = True) -> str:
        """An in-memory column dict as a dataset of one part."""
        self.part_writer(path, overwrite=overwrite).write(columns)
        return path

    def read_parquet(self, path: str) -> Dict[str, np.ndarray]:
        """A dataset read back whole, multi-dimensional columns restored
        (``data/loader.py`` ``decode_table``)."""
        import pyarrow as pa
        import pyarrow.parquet as pq

        from ..data.loader import decode_table, list_parquet_files
        tables = []
        for fpath in list_parquet_files(path, fs=self.fs):
            with self.fs.open(fpath, "rb") as f:
                tables.append(pq.read_table(f))
        return decode_table(pa.concat_tables(tables))

    # ---- checkpoints and run logs ----------------------------------------
    def _save_bytes(self, d: str, name: str, payload: bytes) -> str:
        self.fs.mkdirs(d)
        p = self.fs.join(d, name)
        _write_atomic(self.fs, p, lambda f: f.write(payload))
        return p

    def _read_bytes(self, d: str, name: str) -> Optional[bytes]:
        p = self.fs.join(d, name)
        if not self.fs.exists(p):
            return None
        with self.fs.open(p, "rb") as f:
            return f.read()

    def save_checkpoint(self, run_id: str, payload: bytes,
                        name: str = "checkpoint.bin") -> str:
        return self._save_bytes(self.get_checkpoint_path(run_id), name,
                                payload)

    def read_checkpoint(self, run_id: str,
                        name: str = "checkpoint.bin") -> Optional[bytes]:
        return self._read_bytes(self.get_checkpoint_path(run_id), name)

    def save_log(self, run_id: str, payload: bytes) -> str:
        return self._save_bytes(self.get_logs_path(run_id), "history.bin",
                                payload)

    def read_log(self, run_id: str) -> Optional[bytes]:
        return self._read_bytes(self.get_logs_path(run_id), "history.bin")


LocalStore = FilesystemStore


class HDFSStore(FilesystemStore):
    """Remote-scheme store (reference: store.py HDFSStore:333-530): paths
    are ``hdfs://namenode/...`` URIs and every byte moves through an HDFS
    client speaking the fs protocol (``data/fs.py``).

    ``fs`` is the client: anything implementing the seven-method protocol
    (tests inject a fake namenode).  With ``fs=None`` a pyarrow-backed
    client is attempted, and a machine without Hadoop's native libraries
    gets an actionable error instead of a deep pyarrow stack."""

    def __init__(self, prefix_path: str, fs: Optional[BaseFS] = None,
                 **kwargs):
        if not prefix_path.startswith("hdfs://"):
            raise ValueError(f"HDFSStore requires an hdfs:// prefix, got "
                             f"{prefix_path!r}")
        if fs is None:
            fs = _pyarrow_hdfs(prefix_path)
        super().__init__(prefix_path, fs=fs, **kwargs)


class PyArrowFS(BaseFS):
    """The fs protocol over a pyarrow FileSystem.  Module-level and holding
    only the (picklable) pyarrow client, because the Store rides inside the
    train tasks that ``spark.run`` pickles to its workers."""

    def __init__(self, pafs_client):
        self._c = pafs_client

    def open(self, path, mode="rb"):
        # a random-access file for reads: parquet seeks to its footer (the
        # JAX adapter's input stream cannot seek, so its reads fail)
        p = _strip_scheme(path)
        return (self._c.open_input_file(p) if "r" in mode
                else self._c.open_output_stream(p))

    def exists(self, path):
        from pyarrow import fs as pafs
        info = self._c.get_file_info(_strip_scheme(path))
        return info.type != pafs.FileType.NotFound

    def isdir(self, path):
        from pyarrow import fs as pafs
        info = self._c.get_file_info(_strip_scheme(path))
        return info.type == pafs.FileType.Directory

    def listdir(self, path):
        from pyarrow import fs as pafs
        sel = pafs.FileSelector(_strip_scheme(path))
        return [i.base_name for i in self._c.get_file_info(sel)]

    def mkdirs(self, path):
        self._c.create_dir(_strip_scheme(path), recursive=True)

    def rmtree(self, path):
        p = _strip_scheme(path)
        if self.isdir(p):
            self._c.delete_dir(p)
        elif self.exists(p):
            self._c.delete_file(p)

    def rename(self, src, dst):
        self._c.move(_strip_scheme(src), _strip_scheme(dst))


def _pyarrow_hdfs(uri: str) -> BaseFS:
    """A :class:`PyArrowFS` over pyarrow's HadoopFileSystem, or an error
    that says what to do instead."""
    try:
        from pyarrow import fs as pafs
        hdfs, _ = pafs.FileSystem.from_uri(uri)
    except Exception as e:
        raise RuntimeError(
            "hdfs:// stores need an HDFS client: pass "
            "HDFSStore(prefix, fs=<client>) with any object speaking the "
            "horovod_tpu_torch.data.fs protocol, or install Hadoop's native "
            "libraries for pyarrow; mounting the cluster (fuse/NFS) and "
            "using FilesystemStore also works") from e
    return PyArrowFS(hdfs)


def _strip_scheme(path: str) -> str:
    """``hdfs://host[:port]/a/b`` -> ``/a/b`` (pyarrow clients address
    paths relative to the connected namenode)."""
    if path.startswith("hdfs://"):
        rest = path[len("hdfs://"):]
        slash = rest.find("/")
        return rest[slash:] if slash >= 0 else "/"
    return path


class DBFSLocalStore(FilesystemStore):
    """Databricks DBFS store (reference: store.py DBFSLocalStore): paths
    given as ``dbfs:/...`` are reached through the ``/dbfs/`` fuse mount;
    everything else is :class:`FilesystemStore`."""

    def __init__(self, prefix_path: str, **kwargs):
        super().__init__(self.normalize_path(prefix_path), **kwargs)

    @staticmethod
    def normalize_path(path: str) -> str:
        """``dbfs:/foo`` -> ``/dbfs/foo``."""
        if path.startswith("dbfs:/"):
            return "/dbfs/" + path[len("dbfs:/"):].lstrip("/")
        return path
