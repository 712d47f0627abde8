"""Data-loader utilities: async queue-backed loading + sharded sources, the
port of ``horovod_tpu/data/loader.py``.

The reference's loader stack (reference:
horovod/data/data_loader_base.py:20-130 BaseDataLoader +
AsyncDataLoaderMixin; spark/data_loaders/pytorch_data_loaders.py): the
host must keep batches flowing into device memory while the card runs the
previous step, so the async mixin's producer thread is the core utility.
The loaders are host numpy code, the JAX package's own; ``prefetch``
copies to the card through pinned memory on a copy stream.  Instead
of petastorm, the parquet reader is a thin pyarrow wrapper
(ParquetDataLoader) and sharding is explicit (shard_indices — one shard
per worker, the ElasticSampler convention).
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterator, List, Optional, Sequence

import numpy as np


class BaseDataLoader:
    """Iteration contract (reference: data_loader_base.py:20-45)."""

    def __len__(self) -> int:
        raise NotImplementedError

    def _iterate(self) -> Iterator[Any]:
        raise NotImplementedError

    def _process_batch(self, batch: Any) -> Any:
        """Hook for trainers to reshape batches (reference semantics)."""
        return batch

    def __iter__(self) -> Iterator[Any]:
        for batch in self._iterate():
            yield self._process_batch(batch)


class AsyncDataLoaderMixin:
    """Producer-thread async loading (reference: data_loader_base.py:48-130).

    Mix in FRONT of a BaseDataLoader implementation:

        class AsyncNumpyLoader(AsyncDataLoaderMixin, NumpyDataLoader): ...

    ``async_loader_queue_size=0`` disables the thread (synchronous mode).
    Exceptions in the producer surface in the consumer.  Unlike the
    reference (whose producer loops forever and replays epochs), one
    ``__iter__`` == one epoch — the thread parks between epochs.
    """

    def __init__(self, *args, async_loader_queue_size: int = 64, **kwargs):
        self.async_loader_queue_size = async_loader_queue_size
        super().__init__(*args, **kwargs)
        self._queue: Optional[queue.Queue] = None
        self._thread: Optional[threading.Thread] = None
        self._finished: Optional[threading.Event] = None

    def close(self) -> None:
        if self._thread is not None:
            self._finished.set()
            try:
                self._queue.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=5)
            # Even if the join timed out, the producer owns THIS epoch's
            # queue/event objects only (passed by argument), so a straggler
            # can never inject stale batches into a later epoch.
            self._thread = None

    def __del__(self):  # pragma: no cover - best effort
        try:
            self.close()
        except Exception:
            pass

    @staticmethod
    def _safe_put(q: queue.Queue, finished: threading.Event, item) -> bool:
        """put() that aborts when the consumer closed the epoch — a plain
        blocking put on a full queue after close() would deadlock the
        producer thread forever."""
        while True:
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                if finished.is_set():
                    return False

    def _producer(self, q: queue.Queue, finished: threading.Event) -> None:
        try:
            for batch in self._iterate():
                if finished.is_set() or not self._safe_put(q, finished,
                                                           batch):
                    return
        except Exception as e:  # surface in the consumer
            self._safe_put(q, finished, e)
        self._safe_put(q, finished, None)

    def __iter__(self) -> Iterator[Any]:
        if self.async_loader_queue_size <= 0:
            yield from super().__iter__()
            return
        self.close()  # retire any straggler from an abandoned epoch
        finished = threading.Event()
        q = queue.Queue(self.async_loader_queue_size)
        self._finished, self._queue = finished, q
        self._thread = threading.Thread(target=self._producer,
                                        args=(q, finished), daemon=True)
        self._thread.start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    break
                if isinstance(batch, Exception):
                    raise batch
                yield self._process_batch(batch)
        finally:
            # Abandoned iteration (break / consumer exception / GC of the
            # generator) must stop the producer — otherwise it spins in
            # _safe_put forever with queue_size batches pinned.
            self.close()


def _tree_map(fn: Callable[[Any], Any], batch: Any) -> Any:
    """``fn`` on every array of a batch (a tuple, list or dict of arrays,
    nested, or one array)."""
    if isinstance(batch, dict):
        return {k: _tree_map(fn, v) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(_tree_map(fn, v) for v in batch)
    return fn(batch)


class _Staged:
    """One batch in flight to the card: its device tensors, their pinned
    host sources and the copy stream's event after the last copy."""

    __slots__ = ("batch", "pinned", "event")

    def __init__(self, batch, pinned, event):
        self.batch, self.pinned, self.event = batch, pinned, event


class CudaTransfer:
    """The default transfer of :func:`prefetch` on a CUDA device: each array
    of a host batch goes into pinned host memory and is copied with
    ``non_blocking=True`` on a dedicated copy stream, which records an
    event after the batch's last copy.  ``handoff`` makes the consumer's
    stream wait on that event and marks the device tensors as used on it
    (``record_stream``), so the allocator does not hand their memory back
    to the copy stream while the consumer's work on them is queued."""

    def __init__(self, device, stream=None):
        import torch
        self.device = torch.device(device)
        self.stream = stream or torch.cuda.Stream(self.device)

    def __call__(self, batch) -> _Staged:
        import torch
        pinned = []

        def put(x):
            src = torch.as_tensor(x)
            host = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
            host.copy_(src)
            pinned.append(host)
            dst = torch.empty(src.shape, dtype=src.dtype, device=self.device)
            dst.copy_(host, non_blocking=True)
            return dst
        with torch.cuda.stream(self.stream):
            out = _tree_map(put, batch)
            event = torch.cuda.Event()
            event.record(self.stream)
        return _Staged(out, pinned, event)

    def handoff(self, staged: _Staged):
        """The batch, ready for the consumer's current stream."""
        import torch
        consumer = torch.cuda.current_stream(self.device)
        consumer.wait_event(staged.event)

        def mark(t):
            t.record_stream(consumer)
            return t
        return _tree_map(mark, staged.batch)


def _resolve_depth(depth: Optional[int]) -> int:
    if depth is None:
        from ..common.knobs import current
        depth = int(current("HOROVOD_PREFETCH_DEPTH"))
    depth = int(depth)
    if depth < 1:
        raise ValueError(f"prefetch depth {depth} invalid; must be >= 1 "
                         "(HOROVOD_PREFETCH_DEPTH)")
    return depth


def prefetch(iterator, depth: Optional[int] = None, transfer=None,
             device=None) -> Iterator[Any]:
    """Device prefetch: start the host-to-device copies of batches
    i+1..i+depth while the card runs step i, so a step finds its batch on
    the card unless the host falls ``depth`` batches behind.

    ``depth`` defaults to the HOROVOD_PREFETCH_DEPTH knob (2 = double
    buffered).  ``transfer`` maps one host batch (arrays, or tuples, lists
    and dicts of them) to what is yielded; by default the batch is copied
    to ``device`` (the runtime's device when None): on a CUDA device
    through :class:`CudaTransfer` (pinned memory, a copy stream, the
    consumer's stream waiting on the copy's event), elsewhere with
    ``torch.as_tensor(...).to(device)``.  A pinned source is kept until
    its copy's event has completed.  A :class:`CudaTransfer` given as
    ``transfer`` (on a stream of the caller's) is handed off the same way.
    The time spent pulling and staging batches goes to the perf ledger's
    host-input leg (``perf.add_input_wait``)."""
    depth = _resolve_depth(depth)
    if transfer is None:
        import torch

        from .. import runtime as _rt
        dev = _rt.resolve_device(device)
        if dev.type == "cuda":
            transfer = CudaTransfer(dev)
        else:
            transfer = lambda b: _tree_map(  # noqa: E731
                lambda x: torch.as_tensor(x).to(dev), b)
    cuda = transfer if isinstance(transfer, CudaTransfer) else None

    import collections
    import time
    queue: "collections.deque" = collections.deque()
    retired: "collections.deque" = collections.deque()
    it = iter(iterator)

    def account(dt: float) -> None:
        # the time spent pulling and staging the next batch is host input
        # on the step's critical path: the perf ledger's host_input leg
        # (best-effort: accounting never breaks a loader)
        try:
            from ..perf.ledger import add_input_wait
            add_input_wait(dt)
        except Exception:
            pass

    def enqueue(k: int) -> None:
        t0 = time.perf_counter()
        for _ in range(k):
            try:
                batch = next(it)
            except StopIteration:
                break
            queue.append(transfer(batch))
        account(time.perf_counter() - t0)

    enqueue(depth)
    try:
        while queue:
            staged = queue.popleft()
            if cuda is None:
                yield staged
            else:
                out = cuda.handoff(staged)
                staged.batch = None
                retired.append(staged)
                while retired and retired[0].event.query():
                    retired.popleft()  # its pinned sources are free
                yield out
                del out
            enqueue(1)
    finally:
        for staged in retired:
            staged.event.synchronize()


def shard_indices(n: int, rank: int, num_workers: int,
                  shuffle: bool = False, seed: int = 0) -> np.ndarray:
    """Rank's index shard with wrap-padding so every worker sees the same
    number of samples (the reference's DistributedSampler/ElasticSampler
    convention, torch/elastic/sampler.py:24-131)."""
    idx = np.arange(n)
    if shuffle:
        np.random.RandomState(seed).shuffle(idx)
    per = -(-n // num_workers)  # ceil
    pad = per * num_workers - n
    if pad:
        idx = np.concatenate([idx, idx[:pad]])
    return idx[rank::num_workers]


class _ShardedIndexLoader(BaseDataLoader):
    """Shared sharded-index machinery: per-epoch reshuffled shard
    (DistributedSampler convention), ceil-div length, drop_last
    truncation.  Subclasses call ``_init_sharding`` and consume
    ``_batched_indices()`` — ONE definition of the shard/epoch/seed
    convention, so index-dependent loaders cannot drift."""

    def _init_sharding(self, n: int, rank: int, num_workers: int,
                       shuffle: bool, seed: int) -> None:
        self._epoch = 0
        self._base = dict(n=n, rank=rank, num_workers=num_workers,
                          shuffle=shuffle, seed=seed)

    def set_epoch(self, epoch: int) -> None:
        """Reshuffle per epoch (DistributedSampler convention)."""
        self._epoch = epoch

    def _indices(self) -> np.ndarray:
        b = self._base
        return shard_indices(b["n"], b["rank"], b["num_workers"],
                             shuffle=b["shuffle"],
                             seed=b["seed"] + self._epoch)

    def __len__(self) -> int:
        n = -(-self._base["n"] // self._base["num_workers"])  # shard rows
        return n // self.batch_size if self.drop_last else \
            -(-n // self.batch_size)

    @property
    def num_rows(self) -> int:
        """Rows this shard actually yields per epoch (drop_last trims).
        O(1): shard_indices wrap-pads every shard to ceil(n/workers)."""
        n = -(-self._base["n"] // self._base["num_workers"])
        if self.drop_last:
            n = n // self.batch_size * self.batch_size
        return n

    def _batched_indices(self):
        idx = self._indices()
        end = (len(idx) // self.batch_size * self.batch_size
               if self.drop_last else len(idx))
        for s in range(0, end, self.batch_size):
            yield idx[s:s + self.batch_size]


class NumpyDataLoader(_ShardedIndexLoader):
    """In-memory arrays -> batches, optionally sharded per worker."""

    def __init__(self, arrays: Sequence[np.ndarray], batch_size: int,
                 rank: int = 0, num_workers: int = 1,
                 shuffle: bool = False, seed: int = 0,
                 drop_last: bool = False):
        self.arrays = [np.asarray(a) for a in arrays]
        n = len(self.arrays[0])
        for a in self.arrays:
            if len(a) != n:
                raise ValueError("arrays must share the first dimension")
        self.batch_size = batch_size
        self.drop_last = drop_last
        self._init_sharding(n, rank, num_workers, shuffle, seed)

    def _iterate(self):
        for sel in self._batched_indices():
            yield tuple(a[sel] for a in self.arrays)


class AsyncNumpyDataLoader(AsyncDataLoaderMixin, NumpyDataLoader):
    """The standard composition (reference: PytorchAsyncDataLoader)."""


def list_parquet_files(path: str, fs=None) -> List[str]:
    """A dataset path is either one .parquet file or a directory of them
    (single definition shared by ParquetDataLoader and the Store).
    ``fs`` speaks the data/fs.py protocol; None = local filesystem."""
    from .fs import LOCAL_FS
    fs = fs or LOCAL_FS
    if not fs.isdir(path):
        return [path]

    def order_key(name: str):
        # part-<N>.parquet sorts by numeric index so zero-pad width is
        # irrelevant (datasets can mix widths across writer versions);
        # anything else falls back to lexicographic after the parts.
        stem = name[:-len(".parquet")]
        if stem.startswith("part-") and stem[5:].isdigit():
            return (0, int(stem[5:]), name)
        return (1, 0, name)

    return [fs.join(path, f)
            for f in sorted((f for f in fs.listdir(path)
                             if f.endswith(".parquet")), key=order_key)]


def decode_table(table) -> dict:
    """pyarrow Table -> {column: np.ndarray}, restoring multi-dim columns
    flattened by FilesystemStore.write_parquet (the single decoder for the
    horovod_tpu_shapes metadata scheme — store.read_parquet uses it too)."""
    import json
    md = table.schema.metadata or {}
    shapes = (json.loads(md[b"horovod_tpu_shapes"])
              if b"horovod_tpu_shapes" in md else {})
    out = {}
    for name in table.column_names:
        col = table.column(name).to_numpy(zero_copy_only=False)
        if name in shapes:  # multi-dim column stored as flat lists
            col = np.stack([np.asarray(r) for r in col]).reshape(
                (-1,) + tuple(shapes[name]))
        out[name] = col
    return out


class ParquetDataLoader(BaseDataLoader):
    """Batches from a parquet file/directory (the petastorm-reader analog
    backing the Estimator/Store path; reference: spark/data_loaders/).

    Sharding is by CONTIGUOUS row block: worker r of W owns rows
    [r*ceil(n/W), (r+1)*ceil(n/W)) (wrapping at the end like
    shard_indices), and only the row groups overlapping that block are
    read — workers never materialize each other's data.  Columns are
    decoded once at construction, not per epoch."""

    def __init__(self, path: str, batch_size: int, columns=None,
                 rank: int = 0, num_workers: int = 1, fs=None):
        import pyarrow as pa
        import pyarrow.parquet as pq

        from .fs import LOCAL_FS
        self.path = path
        self.batch_size = batch_size
        self.columns = list(columns) if columns else None
        self.rank = rank
        self.num_workers = num_workers
        self.fs = fs or LOCAL_FS

        readers = [pq.ParquetFile(self.fs.open(f, "rb"))
                   for f in list_parquet_files(path, fs=self.fs)]
        total = sum(r.metadata.num_rows for r in readers)
        if total == 0:
            raise ValueError(f"empty parquet dataset at {path}")
        # Balanced contiguous blocks: floor boundaries guarantee every
        # worker a non-empty block whenever total >= num_workers; tiny
        # datasets (total < num_workers) give spare workers one wrapped
        # row so collectives never lose a participant.
        start = rank * total // num_workers
        stop = (rank + 1) * total // num_workers
        if stop <= start:
            start = rank % total
            stop = start + 1
        per = -(-total // num_workers)  # ceil: common per-worker row count

        # Read only the row groups overlapping [start, stop).
        pieces, offset = [], 0
        for r in readers:
            for g in range(r.num_row_groups):
                rows = r.metadata.row_group(g).num_rows
                g_start, g_stop = offset, offset + rows
                if g_stop > start and g_start < stop:
                    t = r.read_row_group(g, columns=self.columns)
                    lo = max(start - g_start, 0)
                    hi = min(stop - g_start, rows)
                    pieces.append(t.slice(lo, hi - lo))
                offset += rows
        self._cols = decode_table(pa.concat_tables(pieces))
        for r in readers:
            try:
                r.close()
            except Exception:
                pass
        self._n = stop - start
        # Wrap-pad short shards to `per` rows from own data so every worker
        # yields the same number of batches (collective-friendly, the
        # ElasticSampler convention).
        if self._n < per:
            reps = -(-per // self._n)
            self._cols = {k: np.concatenate([v] * reps)[:per]
                          for k, v in self._cols.items()}
            self._n = per

    def __len__(self) -> int:
        return -(-self._n // self.batch_size)

    @property
    def num_rows(self) -> int:
        """Rows this shard yields per epoch."""
        return self._n

    def _iterate(self):
        for s in range(0, self._n, self.batch_size):
            yield {name: col[s:s + self.batch_size]
                   for name, col in self._cols.items()}


class AsyncParquetDataLoader(AsyncDataLoaderMixin, ParquetDataLoader):
    pass


class StreamingParquetDataLoader(BaseDataLoader):
    """Row-group-lazy parquet batches: the petastorm-reader analog for
    shards bigger than worker memory (reference: spark/torch/remote.py
    streams with petastorm readers; spark/common/util.py prepare_data
    writes the partitioned dataset it streams from).

    Construction touches METADATA only (row counts per row group); each
    epoch re-opens the files and holds at most one row group plus one
    batch in memory.  Shard layout, wrap-padding, and batch boundaries
    match ParquetDataLoader exactly — the eager loader is the
    small-data fast path, this is the big-data path, and tests hold
    their outputs equal."""

    def __init__(self, path: str, batch_size: int, columns=None,
                 rank: int = 0, num_workers: int = 1, fs=None):
        import pyarrow.parquet as pq

        from .fs import LOCAL_FS
        self.path = path
        self.batch_size = batch_size
        self.columns = list(columns) if columns else None
        self.rank = rank
        self.num_workers = num_workers
        self.fs = fs or LOCAL_FS

        # Metadata pass: per-(file, row group) row spans + shape metadata.
        self._shapes_md = None
        spans = []  # (file, group_idx, rows)
        total = 0
        for fpath in list_parquet_files(path, fs=self.fs):
            with self.fs.open(fpath, "rb") as fh:
                r = pq.ParquetFile(fh)
                if self._shapes_md is None:
                    self._shapes_md = r.schema_arrow.metadata
                for g in range(r.num_row_groups):
                    rows = r.metadata.row_group(g).num_rows
                    spans.append((fpath, g, rows))
                    total += rows
        if total == 0:
            raise ValueError(f"empty parquet dataset at {path}")
        start = rank * total // num_workers
        stop = (rank + 1) * total // num_workers
        if stop <= start:  # tiny dataset: one wrapped row (see eager)
            start = rank % total
            stop = start + 1
        # Slices of this worker's contiguous block, in order.
        self._pieces = []  # (file, group_idx, lo, hi)
        offset = 0
        for fpath, g, rows in spans:
            g_start, g_stop = offset, offset + rows
            if g_stop > start and g_start < stop:
                lo = max(start - g_start, 0)
                hi = min(stop - g_start, rows)
                self._pieces.append((fpath, g, lo, hi))
            offset += rows
        self._block = stop - start
        self._n = max(self._block, -(-total // num_workers))  # wrap-pad

    def __len__(self) -> int:
        return -(-self._n // self.batch_size)

    @property
    def num_rows(self) -> int:
        """Rows this shard yields per epoch."""
        return self._n

    def _rows(self):
        """Yield decoded column-dict chunks (one per row-group slice),
        cycling over the shard until the padded row count is emitted."""
        import pyarrow.parquet as pq
        emitted = 0
        while emitted < self._n:
            for fpath, g, lo, hi in self._pieces:
                if emitted >= self._n:
                    return
                with self.fs.open(fpath, "rb") as fh:
                    t = pq.ParquetFile(fh).read_row_group(
                        g, columns=self.columns)
                if self._shapes_md:
                    t = t.replace_schema_metadata(self._shapes_md)
                take = min(hi - lo, self._n - emitted)
                yield decode_table(t.slice(lo, take))
                emitted += take

    def _iterate(self):
        buf: dict = {}
        have = 0
        for chunk in self._rows():
            if not buf:
                buf = {k: [v] for k, v in chunk.items()}
            else:
                for k, v in chunk.items():
                    buf[k].append(v)
            have += len(next(iter(chunk.values())))
            while have >= self.batch_size:
                cat = {k: np.concatenate(v) if len(v) > 1 else v[0]
                       for k, v in buf.items()}
                yield {k: v[:self.batch_size] for k, v in cat.items()}
                buf = {k: [v[self.batch_size:]] for k, v in cat.items()}
                have -= self.batch_size
        if have:
            yield {k: np.concatenate(v) if len(v) > 1 else v[0]
                   for k, v in buf.items()}


class AsyncStreamingParquetDataLoader(AsyncDataLoaderMixin,
                                      StreamingParquetDataLoader):
    """Producer-thread streaming reads: the host decodes the next row
    group while the card runs the current step — the standard input
    pipeline shape."""


class ShuffleBufferLoader(BaseDataLoader):
    """Streaming shuffle over dict-batch loaders (the petastorm
    ``shuffle_buffer_size`` semantics the reference estimators expose,
    spark/common/params.py): rows from the inner loader fill a
    ``buffer_rows`` reservoir; each emitted batch draws uniformly from
    the full buffer, which refills as it drains.  Randomness quality
    scales with the buffer (buffer >= dataset = a true shuffle); memory
    is bounded by ``buffer_rows`` regardless of dataset size.

    ``set_epoch`` reseeds so epochs see different orders
    (DistributedSampler convention, like the index-based loaders)."""

    def __init__(self, inner: BaseDataLoader, buffer_rows: int,
                 seed: int = 0):
        if buffer_rows < 1:
            raise ValueError(f"buffer_rows must be >= 1, got {buffer_rows}")
        self.inner = inner
        self.buffer_rows = buffer_rows
        self.seed = seed
        self._epoch = 0
        self.batch_size = getattr(inner, "batch_size", None)

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch
        if hasattr(self.inner, "set_epoch"):
            self.inner.set_epoch(epoch)

    @property
    def num_rows(self):
        """The shuffle preserves the inner row multiset exactly."""
        return getattr(self.inner, "num_rows", None)

    def __len__(self) -> int:
        # The wrapper changes the batch count: the fill phase absorbs
        # whole inner batches (no yield), and the drain re-chunks the
        # final buffer by batch_size.  For a uniform-batch inner loader
        # with >= buffer_rows total rows that is exactly
        #   len(inner) - floor(buffer/bs) + ceil(buffer/bs).
        # Without a batch_size we cannot count absorbed batches, so the
        # value falls back to len(inner); exact when the inner loader
        # reports its row count (num_rows), else the last inner batch is
        # assumed full and the value is approximate for ragged tails.
        n = len(self.inner)
        if not self.batch_size:
            return n
        rows = getattr(self.inner, "num_rows", None)
        if rows is None:
            rows = n * self.batch_size
        if self.buffer_rows >= rows:
            # Everything is absorbed; the drain re-chunks the dataset.
            return -(-rows // self.batch_size)
        absorbed = self.buffer_rows // self.batch_size
        drained = -(-self.buffer_rows // self.batch_size)
        return n - absorbed + drained

    def _iterate(self):
        # The standard exchange reservoir (TF/petastorm shuffle-buffer
        # algorithm, vectorized): once the buffer is full, an incoming
        # batch of k rows picks k DISTINCT slots, emits their occupants,
        # and takes their places — O(k) row traffic per batch, never a
        # whole-buffer copy.  The multiset of rows is preserved exactly.
        rng = np.random.RandomState(self.seed + self._epoch)
        buf: dict = {}
        have = 0

        for batch in self.inner:
            batch = {k: np.asarray(v) for k, v in batch.items()}
            k_rows = len(next(iter(batch.values())))
            if have < self.buffer_rows:
                take = min(self.buffer_rows - have, k_rows)
                # .copy(): the buffer is written in place by the
                # exchange below, but arrow-backed batches arrive
                # read-only and v[:take] would stay a view of them.
                head = {k: v[:take].copy() for k, v in batch.items()}
                if not buf:
                    buf = head
                else:
                    buf = {k: np.concatenate([buf[k], head[k]])
                           for k in buf}
                have += take
                batch = {k: v[take:] for k, v in batch.items()}
                k_rows -= take
                if k_rows == 0:
                    continue
            sel = rng.choice(have, size=min(k_rows, have), replace=False)
            out = {k: buf[k][sel].copy() for k in buf}
            for k in buf:
                buf[k][sel] = batch[k][:len(sel)]
            if k_rows > len(sel):  # batch bigger than the buffer: pass
                out = {k: np.concatenate([out[k], batch[k][len(sel):]])
                       for k in out}
            yield out
        # drain: remaining buffered rows in one random order, chunked
        if have:
            order = rng.permutation(have)
            step = self.batch_size or have
            for s in range(0, have, step):
                sel = order[s:s + step]
                yield {k: buf[k][sel] for k in buf}


class ImageFolderDataLoader(_ShardedIndexLoader):
    """Directory-per-class image batches (the torchvision-ImageFolder
    analog backing the reference's ImageNet examples, e.g.
    examples/pytorch/pytorch_imagenet_resnet50.py's train_dataset):

        root/
          cat/  img0.png img1.jpg ...
          dog/  img7.png ...

    Class ids are the sorted directory names' indices.  Construction
    SCANS paths only; images decode lazily per batch (PIL), resized to
    ``image_size``² RGB — so a dataset far larger than host memory
    streams.  Sharding/shuffling come from _ShardedIndexLoader (the one
    convention every loader here shares); compose AsyncDataLoaderMixin
    (below) to decode the next batch while the card runs the current
    step.  ``fs`` speaks the data/fs.py protocol like the parquet
    loaders, so the tree may live on remote storage.

    Batches are ``(uint8 [B, H, W, 3], int32 [B])`` — normalization
    belongs on-device (one fused op, not a host-side float blow-up).
    """

    EXTENSIONS = (".png", ".jpg", ".jpeg", ".bmp", ".gif", ".webp")

    def __init__(self, root: str, batch_size: int, image_size: int = 224,
                 rank: int = 0, num_workers: int = 1,
                 shuffle: bool = False, seed: int = 0,
                 drop_last: bool = False, fs=None):
        from .fs import LOCAL_FS
        self.root = root
        self.batch_size = batch_size
        self.image_size = image_size
        self.drop_last = drop_last
        self.fs = fs or LOCAL_FS
        self.classes = sorted(
            d for d in self.fs.listdir(root)
            if self.fs.isdir(self.fs.join(root, d)))
        if not self.classes:
            raise ValueError(f"no class directories under {root}")
        self._files: List[str] = []
        self._labels: List[int] = []
        for ci, cname in enumerate(self.classes):
            cdir = self.fs.join(root, cname)
            for f in sorted(self.fs.listdir(cdir)):
                if f.lower().endswith(self.EXTENSIONS):
                    self._files.append(self.fs.join(cdir, f))
                    self._labels.append(ci)
        if not self._files:
            raise ValueError(f"no images under {root} "
                             f"(extensions: {self.EXTENSIONS})")
        self._init_sharding(len(self._files), rank, num_workers, shuffle,
                            seed)

    def _decode(self, path: str) -> np.ndarray:
        from PIL import Image
        with self.fs.open(path, "rb") as fh:
            with Image.open(fh) as im:
                im = im.convert("RGB").resize(
                    (self.image_size, self.image_size))
                return np.asarray(im, np.uint8)

    def _iterate(self):
        for sel in self._batched_indices():
            x = np.stack([self._decode(self._files[i]) for i in sel])
            y = np.asarray([self._labels[i] for i in sel], np.int32)
            yield x, y


class AsyncImageFolderDataLoader(AsyncDataLoaderMixin,
                                 ImageFolderDataLoader):
    """Decode-ahead composition: PIL decode of batch k+1 overlaps the
    card's step k (the reference's PytorchAsyncDataLoader pattern)."""

