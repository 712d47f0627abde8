"""Data prepare: a DataFrame or a stream of chunks as partitioned parquet in
the Store; the port of ``horovod_tpu/spark/prepare.py``.

Reference: horovod/spark/common/util.py prepare_data — the reference
writes the training DataFrame as a distributed Spark job (each partition
becomes parquet written by its executor) and the workers stream it back;
the driver never holds the dataset.

Three input shapes, one output (a dataset of part files per split,
readable by the port's parquet loaders and by the JAX package's):

* a pyspark DataFrame (anything with ``.rdd``), written partition by
  partition: ``rdd.mapPartitionsWithIndex`` runs :class:`_PartitionWriter`
  on the executors, each writing its own part files straight into the
  Store (namespaced part numbers, no coordination);
* an iterator of column-dict chunks, streamed chunk by chunk through one
  part writer: the driver's memory stays bounded by a chunk;
* an in-memory column dict or pandas DataFrame: split, then one write.

The validation split draws the JAX module's masks (``RandomState(seed)``,
and a seed per partition and chunk), so both packages write the same rows
in the same order.  Host code: nothing here touches a device.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from .store import FilesystemStore, Store


def _as_columns(df, feature_cols=None, label_cols=None, extra_cols=()
                ) -> Dict[str, np.ndarray]:
    """A column dict from a column dict, or a pyspark or pandas DataFrame.
    With no column lists every column converts (``transform`` keeps the
    caller's id and label columns beside the predictions)."""
    if isinstance(df, dict):
        return {k: np.asarray(v) for k, v in df.items()}
    if hasattr(df, "toPandas"):  # pyspark DataFrame (transform time only)
        df = df.toPandas()
    cols = (list(feature_cols or []) + list(label_cols or []) +
            list(extra_cols)) or list(df.columns)
    return {c: np.stack(df[c].to_numpy()) for c in cols}


def _split_validation(cols: Dict[str, np.ndarray], validation,
                      seed: int = 0):
    """``(train, val)`` by the reference's ``validation`` param
    (common/params.py): a float in (0, 1) holds out a random fraction
    (``RandomState(seed).rand(n) < frac``); a string names a boolean column
    marking the val rows, dropped from both splits.  ``val`` is None when
    no validation was asked for or the split came out empty."""
    if not validation:
        return cols, None
    if isinstance(validation, str):
        if validation not in cols:
            raise ValueError(f"validation column {validation!r} not in "
                             f"columns {sorted(cols)}")
        mask = np.asarray(cols[validation]).astype(bool).ravel()
        base = {k: np.asarray(v) for k, v in cols.items()
                if k != validation}
    else:
        frac = float(validation)
        if not 0.0 < frac < 1.0:
            raise ValueError(f"validation fraction must be in (0,1), got "
                             f"{frac}")
        n = len(next(iter(cols.values())))
        mask = np.random.RandomState(seed).rand(n) < frac
        base = {k: np.asarray(v) for k, v in cols.items()}
    train = {k: v[~mask] for k, v in base.items()}
    val = {k: v[mask] for k, v in base.items()}
    return train, (val if mask.any() else None)


def _row_to_dict(row) -> Dict:
    """A pyspark Row (it has ``asDict``) or a plain mapping."""
    if hasattr(row, "asDict"):
        return row.asDict()
    return dict(row)


def _write_split_chunk(tw, vw, cols: Dict[str, np.ndarray], columns,
                       validation, seed: int) -> Tuple[int, int]:
    """Select ``columns``, split train and val, append the non-empty parts;
    returns ``(train_rows, val_rows)``.  The one chunk-level write of the
    partition and chunk-stream paths."""
    if columns:
        missing = [c for c in columns if c not in cols]
        if missing:
            raise ValueError(f"prepare_data: column(s) {missing} not in "
                             f"the data (columns: {sorted(cols)})")
        cols = {c: cols[c] for c in columns}
    tr, va = _split_validation(cols, validation, seed=seed)
    t = len(next(iter(tr.values())))
    v = 0
    if t:
        tw.write(tr)
    if va is not None:
        v = len(next(iter(va.values())))
        vw.write(va)
    return t, v


class _PartitionWriter:
    """The picklable prepare task of one partition: buffer rows, split
    train and val, write every ``chunk_rows`` rows as a part file.  Part
    numbers are namespaced by the partition's index
    (``ParquetPartWriter.base_index``), so N executors append to one
    dataset without coordination."""

    def __init__(self, store: FilesystemStore, train_path: str,
                 val_path: str, columns: List[str], validation, seed: int,
                 chunk_rows: int):
        self.store = store
        self.train_path = train_path
        self.val_path = val_path
        self.columns = columns
        self.validation = validation
        self.seed = seed
        self.chunk_rows = chunk_rows

    def __call__(self, idx: int, it) -> Iterable[Tuple[int, int, int]]:
        tw = self.store.part_writer(self.train_path, overwrite=False,
                                    base_index=idx)
        vw = self.store.part_writer(self.val_path, overwrite=False,
                                    base_index=idx)
        buf: List[Dict] = []
        counts = [0, 0]  # train, val rows
        chunk_i = 0

        def flush():
            nonlocal buf, chunk_i
            if not buf:
                return
            cols = {c: np.stack([np.asarray(r[c]) for r in buf])
                    for c in (self.columns or sorted(buf[0]))}
            # seeded per (partition, chunk), reduced to numpy's 32 bits: a
            # re-run of the same layout draws the same split
            t, v = _write_split_chunk(
                tw, vw, cols, None, self.validation,
                seed=(self.seed + 1000003 * idx + chunk_i) % (1 << 32))
            chunk_i += 1
            counts[0] += t
            counts[1] += v
            buf = []

        for row in it:
            buf.append(_row_to_dict(row))
            if len(buf) >= self.chunk_rows:
                flush()
        flush()
        yield (idx, counts[0], counts[1])


def prepare_data(store: Store, df, feature_cols, label_cols,
                 validation=None, seed: int = 0,
                 chunk_rows: int = 65536,
                 train_path: Optional[str] = None,
                 val_path: Optional[str] = None,
                 run_id: str = "run0",
                 extra_cols: Sequence[str] = ()) -> Tuple[str, Optional[str]]:
    """Write ``df`` into the Store as a train dataset and, when the split
    holds rows, a val dataset; returns ``(train_path, val_path or None)``.

    The input's shape picks the path (module docstring).  ``extra_cols``
    (a sample-weight column, say) are written beside the features and
    labels; a column the data lacks raises, naming it."""
    train_path = train_path or store.get_train_data_path(run_id)
    val_path = val_path or store.get_val_data_path(run_id)
    extra = (validation,) if isinstance(validation, str) else ()
    columns = (list(feature_cols or []) + list(label_cols or []) +
               list(extra) + [c for c in extra_cols if c])

    if hasattr(df, "rdd"):  # pyspark DataFrame: the executors write
        # both datasets cleared once, on the driver; executors append
        store.part_writer(train_path, overwrite=True)
        store.part_writer(val_path, overwrite=True)
        task = _PartitionWriter(store, train_path, val_path, columns,
                                validation, seed, chunk_rows)
        counts = df.rdd.mapPartitionsWithIndex(task).collect()
        train_rows = sum(t for _, t, _ in counts)
        val_rows = sum(v for _, _, v in counts)
        if train_rows == 0:
            raise ValueError("prepare_data: DataFrame produced 0 train "
                             "rows")
        return train_path, (val_path if val_rows else None)

    if not isinstance(df, dict) and not hasattr(df, "toPandas") and \
            not hasattr(df, "columns") and hasattr(df, "__iter__"):
        # a stream of column-dict chunks through one writer
        tw = store.part_writer(train_path, overwrite=True)
        vw = store.part_writer(val_path, overwrite=True)
        train_rows = val_rows = 0
        for i, chunk in enumerate(df):
            cols = {k: np.asarray(v) for k, v in chunk.items()}
            t, v = _write_split_chunk(tw, vw, cols, columns, validation,
                                      seed=seed + i)
            train_rows += t
            val_rows += v
        if train_rows == 0:
            raise ValueError("prepare_data: chunk stream produced 0 train "
                             "rows")
        return train_path, (val_path if val_rows else None)

    # an in-memory dict or pandas DataFrame
    extras = tuple(extra) + tuple(c for c in extra_cols if c)
    if isinstance(df, dict):
        missing = [c for c in columns if c not in df]
        if missing:
            raise ValueError(f"prepare_data: column(s) {missing} not in "
                             f"the data (columns: {sorted(df)})")
    cols = _as_columns(df, feature_cols, label_cols, extra_cols=extras)
    train_cols, val_cols = _split_validation(cols, validation, seed)
    store.write_parquet(train_path, train_cols)
    if val_cols is not None:
        store.write_parquet(val_path, val_cols)
        return train_path, val_path
    return train_path, None
