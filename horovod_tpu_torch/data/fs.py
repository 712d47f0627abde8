"""Minimal filesystem protocol behind the parquet and image readers: the
port's copy of ``horovod_tpu/data/fs.py``.

Reference: horovod/spark/common/store.py:36-530 — the reference's Store
family (FilesystemStore / HDFSStore / DBFSLocalStore) differs only in
how paths are joined and bytes are moved; HDFSStore carries a pyarrow
``hdfs`` client around.  Here that boundary is an explicit seven-method
protocol, so a remote store is "FilesystemStore + a different fs object"
instead of a parallel implementation — and tests can prove the
abstraction by injecting a fake remote filesystem.

Protocol (duck-typed; subclassing :class:`BaseFS` is optional):

    open(path, mode)      -> file object ("rb"/"wb"; "wb" creates parents)
    exists(path)          -> bool
    isdir(path)           -> bool
    listdir(path)         -> [name, ...]           (names, not full paths)
    mkdirs(path)          -> None                  (mkdir -p)
    rmtree(path)          -> None                  (file or directory)
    rename(src, dst)      -> None                  (atomic where possible)

Paths are whatever the fs understands — POSIX paths for LocalFS,
``hdfs://namenode/...`` URIs for an HDFS client.  Joining is posixpath
on every non-local fs (``join`` below).
"""

from __future__ import annotations

import os
import posixpath
import shutil
from typing import IO, List


class BaseFS:
    """Optional base with the protocol spelled out (duck typing is fine)."""

    def open(self, path: str, mode: str = "rb") -> IO:
        raise NotImplementedError

    def exists(self, path: str) -> bool:
        raise NotImplementedError

    def isdir(self, path: str) -> bool:
        raise NotImplementedError

    def listdir(self, path: str) -> List[str]:
        raise NotImplementedError

    def mkdirs(self, path: str) -> None:
        raise NotImplementedError

    def rmtree(self, path: str) -> None:
        raise NotImplementedError

    def rename(self, src: str, dst: str) -> None:
        raise NotImplementedError

    # path joining: remote schemes are POSIX regardless of host OS
    def join(self, *parts: str) -> str:
        return posixpath.join(*parts)


class LocalFS(BaseFS):
    """The local filesystem (also NFS/fuse mounts, such as a
    gcsfuse-mounted bucket: reference store.py's guidance for non-HDFS
    clusters)."""

    def open(self, path: str, mode: str = "rb") -> IO:
        if "w" in mode or "a" in mode:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        return open(path, mode)

    def exists(self, path: str) -> bool:
        return os.path.exists(path)

    def isdir(self, path: str) -> bool:
        return os.path.isdir(path)

    def listdir(self, path: str) -> List[str]:
        return os.listdir(path)

    def mkdirs(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)

    def rmtree(self, path: str) -> None:
        if os.path.isdir(path):
            shutil.rmtree(path)
        elif os.path.exists(path):
            os.remove(path)

    def rename(self, src: str, dst: str) -> None:
        os.replace(src, dst)

    def join(self, *parts: str) -> str:
        return os.path.join(*parts)


LOCAL_FS = LocalFS()
