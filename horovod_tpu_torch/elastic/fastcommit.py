"""Raw per-rank commit store: the fast path for elastic durable commits;
the port of ``horovod_tpu/elastic/fastcommit.py``.

The elastic restart path needs no portable checkpoint format: the same
process layout that wrote a commit restores it (a restarted round keeps
its world size), templates are in hand, and the files are local.  So each
rank writes its tensors as ONE flat binary blob plus a manifest, and
restores them with a thread pool: reads from an ``mmap``, each tensor's
bytes viewed in place (``torch.frombuffer(...).view(dtype)``) and copied
to its template's device in one copy, no codec in between.  bf16 goes
byte for byte.  Moves to another layout stay on the portable path
(``checkpoint.CheckpointManager``); ``restore`` detects a layout mismatch
(rank count, leaf count, shape, dtype or device kind) and returns None.

The JAX store writes one copy of each distinct shard a process holds, so a
replicated array is written once per process.  Every rank of the port
holds whole tensors, so each rank writes each of its tensors once: a
replicated tensor is written once per rank.

A tree is a nest of dicts, lists and tuples whose leaves are tensors or
plain picklable values (a model's ``state_dict()``, an optimizer's
``state_dict()``): the tensors go into the blob, the other leaves into
the manifest.

Durability protocol: data and manifest land via tmp+rename, then the
rank's ``COMMIT_<rank>`` marker; a step without this rank's marker is
ignored at restore, so a crash mid-commit can never be read back.  The
chaos plane's ``crash_commit`` events fire between those writes
(``chaos.crash_point``).
"""

from __future__ import annotations

import mmap
import os
import pickle
import re
import shutil
import threading
import warnings
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import torch

_STEP_RE = re.compile(r"^step_(\d+)$")
_WORKERS = 8
_CHUNK = 64 << 20  # bytes a writer thread copies and writes at a time


# ------------------------------------------------------------------ trees
def flatten(tree: Any) -> Tuple[List[Any], Any]:
    """``(leaves, treedef)``: dicts (in their order), lists and tuples are
    nodes; anything else is a leaf.  Two trees of one structure have equal
    treedefs."""
    leaves: List[Any] = []

    def walk(node):
        if isinstance(node, dict):
            return ("dict", tuple(node), tuple(walk(v)
                                              for v in node.values()))
        if isinstance(node, (list, tuple)):
            return (type(node).__name__, len(node),
                    tuple(walk(v) for v in node))
        leaves.append(node)
        return None

    return leaves, walk(tree)


def unflatten(treedef: Any, leaves: List[Any]) -> Any:
    it = iter(leaves)

    def build(d):
        if d is None:
            return next(it)
        kind, keys, children = d
        if kind == "dict":
            return {k: build(c) for k, c in zip(keys, children)}
        vals = [build(c) for c in children]
        return tuple(vals) if kind == "tuple" else vals

    return build(treedef)


def _rank_and_size() -> Tuple[int, int]:
    """This process's rank and the world size: the runtime's when it is
    up, else the launcher's env (one process when neither says)."""
    from .. import runtime as _rt
    if _rt.is_initialized():
        rt = _rt.get()
        return rt.rank(), rt.size()
    from ..common.knobs import Knobs
    knobs = Knobs()
    return max(knobs["HOROVOD_RANK"], 0), max(knobs["HOROVOD_SIZE"], 1)


def _chaos_crash(point: str, step: int) -> None:
    """Chaos crash hooks at the durability protocol's weak spots (between
    data and marker): a crash_commit event hard-exits here, and the
    restore path must never see the torn step."""
    from .. import chaos
    chaos.crash_point(point, step)


def _open_in_step_dir(d: str, path: str):
    """open(path, 'wb') that survives a peer racing the directory away:
    another rank's purge or GC may rmdir a just-created (still empty) step
    dir between our makedirs and the first open; re-create and retry
    once.  Own files are never touched by peers."""
    try:
        return open(path, "wb")
    except FileNotFoundError:
        os.makedirs(d, exist_ok=True)
        return open(path, "wb")


def _pwrite_all(fd: int, buf, offset: int) -> None:
    """pwrite the WHOLE buffer: a single pwrite may write short (and is
    capped at ~2 GiB on Linux)."""
    view = memoryview(buf).cast("B")
    while len(view):
        n = os.pwrite(fd, view, offset)
        view = view[n:]
        offset += n


def _write_tensors(fd: int, jobs) -> None:
    """pwrite each ``(offset, tensor)``'s bytes at its offset (bf16 and
    every other dtype byte for byte; a 0-d tensor as one element), in
    pieces of ``_CHUNK`` bytes over ``_WORKERS`` threads.  A card's piece
    goes through a pinned buffer of the thread's own, copied on a stream
    of its own, so the device-to-host copies of some pieces run while
    others are written; a host tensor's bytes are written in place."""
    pieces = []
    for off, t in jobs:
        flat = t.detach().reshape(-1).contiguous().view(torch.uint8)
        pieces += [(off + k, flat[k:k + _CHUNK])
                   for k in range(0, flat.numel(), _CHUNK)]
    if any(src.device.type == "cuda" for _, src in pieces):
        torch.cuda.synchronize()  # every producer of the tensors is done
    local = threading.local()

    def write(piece):
        off, src = piece
        if src.device.type != "cuda":
            _pwrite_all(fd, src.numpy(), off)
            return
        if not hasattr(local, "buf"):
            local.buf = torch.empty(_CHUNK, dtype=torch.uint8,
                                    pin_memory=True)
            local.stream = torch.cuda.Stream(device=src.device)
        n = src.numel()
        with torch.cuda.stream(local.stream):
            local.buf[:n].copy_(src, non_blocking=True)
        local.stream.synchronize()
        _pwrite_all(fd, local.buf[:n].numpy(), off)

    with ThreadPoolExecutor(max_workers=_WORKERS) as pool:
        list(pool.map(write, pieces))


class FastCommitStore:
    """Per-rank raw blobs with a manifest; same-layout restore."""

    def __init__(self, directory: str, max_to_keep: int = 2,
                 fsync: bool = False):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        # fsync=True survives a whole-MACHINE crash but costs physical disk
        # bandwidth per commit.  The failure this store serves is a killed
        # PROCESS, where the page cache survives; tmp+rename ordering is
        # kept either way, so a torn commit is never visible.
        self.fsync = fsync
        self._rank, self._size = _rank_and_size()
        os.makedirs(self.directory, exist_ok=True)

    def _names(self) -> Tuple[str, str, str]:
        r = self._rank
        return f"rank_{r}.bin", f"rank_{r}.manifest", f"COMMIT_{r}"

    # ------------------------------------------------------------------ save
    def save(self, step: int, trees: Dict[str, Any],
             meta: Optional[Dict[str, Any]] = None) -> int:
        """Write this rank's tensors of every tree; durable on return.
        Returns the bytes of tensor data written."""
        # A commit counter that restarted below steps still on disk begins
        # a NEW timeline: the stale higher steps would shadow
        # latest_step() and make _gc delete the commit being written, so
        # purge them first; markerless leftovers of a crashed commit hold
        # state-sized blobs, reap those too.
        for s in self.steps():
            if s >= step:
                self._remove_step(s)
        self._purge_incomplete()
        d = os.path.join(self.directory, f"step_{step}")
        os.makedirs(d, exist_ok=True)
        manifest: Dict[str, Any] = {"rank": self._rank,
                                    "world_size": self._size,
                                    "meta": meta or {}, "trees": {}}
        # lay out every tensor's byte range from metadata only, so the
        # writers pipeline one piece's device->host copy with another's
        # pwrite
        jobs = []  # (offset, tensor)
        offset = 0
        for name, tree in trees.items():
            if tree is None:
                manifest["trees"][name] = None
                continue
            leaves, treedef = flatten(tree)
            entries = []
            for leaf in leaves:
                if isinstance(leaf, torch.Tensor):
                    nbytes = leaf.numel() * leaf.element_size()
                    entries.append({"offset": offset, "nbytes": nbytes,
                                    "shape": tuple(leaf.shape),
                                    "dtype": str(leaf.dtype).split(".")[-1],
                                    "device": leaf.device.type})
                    jobs.append((offset, leaf))
                    offset += nbytes
                else:
                    entries.append({"value": leaf})
            manifest["trees"][name] = {"treedef": treedef,
                                       "entries": entries}

        data_name, man_name, marker_name = self._names()
        data_path = os.path.join(d, data_name)
        tmp = data_path + ".tmp"
        with _open_in_step_dir(d, tmp) as f:
            f.truncate(offset)
            fd = f.fileno()
            _write_tensors(fd, jobs)
            f.flush()
            if self.fsync:
                os.fsync(fd)
        os.replace(tmp, data_path)
        _chaos_crash("fastcommit.pre_manifest", step)

        man_path = os.path.join(d, man_name)
        with open(man_path + ".tmp", "wb") as f:
            pickle.dump(manifest, f)
            if self.fsync:
                os.fsync(f.fileno())
        os.replace(man_path + ".tmp", man_path)
        _chaos_crash("fastcommit.pre_marker", step)
        # the marker is what restore trusts; everything above is invisible
        # until it exists
        with open(os.path.join(d, marker_name), "w") as f:
            f.write("ok")
            if self.fsync:
                f.flush()
                os.fsync(f.fileno())
        if self.fsync:
            # the renames and the marker are directory entries
            dfd = os.open(d, os.O_RDONLY)
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)
        self._gc()
        return offset

    def _remove_step(self, s: int) -> None:
        d = os.path.join(self.directory, f"step_{s}")
        data_name, man_name, marker_name = self._names()
        # marker FIRST: a kill mid-removal must leave the step invisible,
        # never marker-bearing with missing data
        for fn in (marker_name, data_name, man_name):
            try:
                os.remove(os.path.join(d, fn))
            except OSError:
                pass
        try:  # last rank out removes the dir
            os.rmdir(d)
        except OSError:
            pass

    def _purge_incomplete(self) -> None:
        """Remove this rank's files from step dirs that lack its marker:
        leftovers of a commit that crashed between data and marker.  Only
        our own files: another rank may be mid-commit in the same dir."""
        try:
            names = os.listdir(self.directory)
        except OSError:
            return
        data_name, man_name, marker_name = self._names()
        for n in names:
            if not _STEP_RE.match(n):
                continue
            d = os.path.join(self.directory, n)
            if os.path.exists(os.path.join(d, marker_name)):
                continue
            for fn in (data_name, data_name + ".tmp", man_name,
                       man_name + ".tmp"):
                try:
                    os.remove(os.path.join(d, fn))
                except OSError:
                    pass
            try:
                os.rmdir(d)
            except OSError:
                pass

    def _gc(self) -> None:
        steps = sorted(self.steps())
        for s in steps[:-self.max_to_keep] if self.max_to_keep else []:
            self._remove_step(s)

    # --------------------------------------------------------------- restore
    def steps(self) -> List[int]:
        """Steps with THIS rank's durability marker."""
        out = []
        try:
            names = os.listdir(self.directory)
        except OSError:
            return out
        marker = self._names()[2]
        for n in names:
            m = _STEP_RE.match(n)
            if m and os.path.exists(os.path.join(self.directory, n, marker)):
                out.append(int(m.group(1)))
        return out

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return max(steps) if steps else None

    def marker_mtime(self, step: int) -> Optional[float]:
        """When this rank's commit of ``step`` became durable (orders
        commits ACROSS stores, whose step counters share no timeline)."""
        try:
            return os.path.getmtime(os.path.join(
                self.directory, f"step_{step}", self._names()[2]))
        except OSError:
            return None

    def restore(self, step: int, templates: Dict[str, Any]
                ) -> Optional[Dict[str, Any]]:
        """The committed trees, each tensor read into a new tensor on its
        template's device (one host-to-device copy a tensor, from a thread
        pool), ``meta`` beside them.  Returns None when the commit cannot
        be mapped onto the templates (another world size, leaf count,
        shape, dtype or device kind) or cannot be read."""
        d = os.path.join(self.directory, f"step_{step}")
        data_name, man_name, marker_name = self._names()
        man_path = os.path.join(d, man_name)
        data_path = os.path.join(d, data_name)
        if not (os.path.exists(os.path.join(d, marker_name))
                and os.path.exists(man_path)
                and os.path.exists(data_path)):
            return None
        try:
            with open(man_path, "rb") as f:
                manifest = pickle.load(f)
        except (OSError, EOFError, pickle.UnpicklingError, ValueError):
            return None  # corrupt commit: the caller decides
        if manifest.get("world_size") != self._size:
            return None

        out: Dict[str, Any] = {"meta": manifest.get("meta") or {}}
        try:
            with open(data_path, "rb") as f:
                try:
                    # copy-on-write: a private, writable view, so
                    # frombuffer has a writable buffer; nothing writes it
                    mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
                except ValueError:  # zero-length data file (no tensors)
                    mm = None
            try:
                for name, tmpl_tree in templates.items():
                    stored = manifest["trees"].get(name)
                    if stored is None or tmpl_tree is None:
                        out[name] = None
                        continue
                    out[name] = self._rebuild(mm, tmpl_tree, stored)
            finally:
                if mm is not None:
                    try:
                        mm.close()
                    except BufferError:
                        pass  # a view still alive: the collector closes it
        except _LayoutMismatch:
            return None
        except (ValueError, OSError, KeyError, IndexError, TypeError,
                RuntimeError):
            # a marker-bearing commit with an unreadable blob (machine
            # crash under fsync=False, disk corruption): "None means the
            # caller decides", never an exception, or peers would hang in
            # the outcome agreement
            return None
        return out

    @staticmethod
    def _rebuild(mm, tmpl_tree: Any, stored: Dict[str, Any]) -> Any:
        leaves, treedef = flatten(tmpl_tree)
        entries = stored["entries"]
        if treedef != stored["treedef"] or len(leaves) != len(entries):
            raise _LayoutMismatch()
        for tmpl, e in zip(leaves, entries):
            if isinstance(tmpl, torch.Tensor) != ("nbytes" in e):
                raise _LayoutMismatch()
            if "nbytes" not in e:
                continue
            if tuple(tmpl.shape) != tuple(e["shape"]) \
                    or str(tmpl.dtype).split(".")[-1] != e["dtype"] \
                    or tmpl.device.type != e["device"]:
                # a precision or placement change is a layout change:
                # silently restoring the old one would train wrong
                raise _LayoutMismatch()

        def build(pair):
            tmpl, e = pair
            if "nbytes" not in e:
                return e["value"]
            out = torch.empty_like(tmpl, memory_format=torch.contiguous_format)
            if e["nbytes"]:
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore")
                    raw = torch.frombuffer(mm, dtype=torch.uint8,
                                           count=e["nbytes"],
                                           offset=e["offset"])
                out.copy_(raw.view(tmpl.dtype).reshape(tmpl.shape))
            return out

        with ThreadPoolExecutor(max_workers=_WORKERS) as pool:
            rebuilt = list(pool.map(build, zip(leaves, entries)))
        if any(isinstance(t, torch.Tensor) and t.device.type == "cuda"
               for t in rebuilt):
            # the copies read the mapping, which closes on return
            torch.cuda.synchronize()
        return unflatten(treedef, rebuilt)

    def clear(self) -> None:
        shutil.rmtree(self.directory, ignore_errors=True)


class _LayoutMismatch(Exception):
    """The commit does not map onto the templates."""
