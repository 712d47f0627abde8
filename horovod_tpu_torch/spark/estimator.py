"""Estimator API: fit on a dataset, get back a servable model; the port of
the Linear and Torch parts of ``horovod_tpu/spark/estimator.py``.

Reference: horovod/spark/common/estimator.py:25-103 — ``Estimator.fit(df)``
persists the DataFrame as parquet in the Store, trains inside
horovod-on-spark workers that stream their shards, checkpoints every
epoch, and returns a Model transformer.

Data arrives as a pyspark DataFrame (written partition by partition,
``spark/prepare.py``), an iterator of column-dict chunks (streamed through
the driver) or an in-memory column dict; training runs through the port's
``spark.run`` on any ``TaskExecutor``; each worker streams its shard row
group by row group (``StreamingParquetDataLoader``), rank 0 checkpoints an
epoch envelope to the Store, and ``fit`` returns an :class:`EstimatorModel`
whose ``transform`` predicts.

The port's rules beside the JAX module's:

- **Devices.**  Every train task calls ``hvd.init()``, even alone, so its
  model and batches sit on ``cuda:<local rank>``, or on the CPU when the
  caller asked for it (``utils/platform.py`` ``force_cpu``, or a task
  handed no card); with no card and no such request the task raises.
  Batches are staged to the device through ``data/loader.py``
  ``prefetch`` (pinned memory and a copy stream on a card).
- **Sync.**  Gradients (and, at the first epoch, the initial parameters)
  are averaged by one ``grouped_allreduce(..., op=Average)`` of the eager
  API on the device tensors: NCCL on cards, gloo on the CPU.
- **Linear.**  ``LinearEstimator``'s state is float64 tensors on the
  device; its envelope's ``model`` is still a pickle of a dict of float64
  numpy arrays, and a torch envelope's a ``state_dict`` of CPU tensors, as
  the JAX package writes them: a Store written by either package resumes
  in the other.
- **Ports.**  ``coordinator_port`` names the store port of the tasks'
  process group (``spark.run``'s); the JAX estimator has no such knob.
  The native controller's port is the ``HOROVOD_CONTROLLER_PORT`` knob of
  the tasks' env.

The Keras and Lightning estimators are not ported here.
"""

from __future__ import annotations

import io
import itertools
import os
import pickle
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from ..data.loader import (ParquetDataLoader, ShuffleBufferLoader,
                           StreamingParquetDataLoader, prefetch)
from .prepare import _as_columns, prepare_data
from .runner import TaskExecutor, run as spark_run
from .store import Store


# ---------------------------------------------------------------------------
# metrics and the epoch envelope (shared by every train task)

_NAMED_METRICS = {
    "mse": lambda p, y: float(np.mean((p - y) ** 2)),
    "mae": lambda p, y: float(np.mean(np.abs(p - y))),
    "accuracy": lambda p, y: float(np.mean(
        (np.argmax(p, axis=-1) if p.ndim > 1 and p.shape[-1] > 1
         else (p > 0.5).astype(np.int64)).ravel() ==
        np.asarray(y).ravel().astype(np.int64))),
}


def _resolve_metrics(metrics) -> List:
    """Names or callables -> ``[(name, fn(pred, y) -> float)]`` (reference:
    common/params.py's metrics param)."""
    out = []
    for m in metrics or ():
        if callable(m):
            out.append((getattr(m, "__name__", "metric"), m))
        elif m in _NAMED_METRICS:
            out.append((m, _NAMED_METRICS[m]))
        else:
            raise ValueError(f"unknown metric {m!r}; named metrics: "
                             f"{sorted(_NAMED_METRICS)}")
    return out


def _save_epoch_checkpoint(store: Store, run_id: str, epoch: int,
                           model_bytes: bytes, history: Dict) -> None:
    """The durable epoch envelope ``{fmt: 1, epoch, model, history}``;
    resume keys off the stored epoch."""
    store.save_checkpoint(run_id, pickle.dumps(
        {"fmt": 1, "epoch": int(epoch), "model": model_bytes,
         "history": history}))


def _load_epoch_checkpoint(store: Store, run_id: str) -> Optional[Dict]:
    """The envelope read back; a raw payload from before the envelope
    loads as epoch -1, so a resume starts over but serving still works."""
    payload = store.read_checkpoint(run_id)
    if payload is None:
        return None
    try:
        obj = pickle.loads(payload)
    except Exception:
        return {"fmt": 0, "epoch": -1, "model": payload, "history": {}}
    if isinstance(obj, dict) and "model" in obj and "epoch" in obj:
        return obj
    return {"fmt": 0, "epoch": -1, "model": payload, "history": {}}


# ---------------------------------------------------------------------------
# the data side of a train task

def _make_train_loader(store, path: str, batch_size: int, rank: int,
                       size: int, opts: Dict):
    """This worker's train reader: streaming, wrapped in a shuffle buffer
    when ``shuffle_buffer_size`` is set."""
    loader = StreamingParquetDataLoader(path, batch_size, rank=rank,
                                        num_workers=size, fs=store.fs)
    if opts.get("shuffle_buffer_size"):
        loader = ShuffleBufferLoader(loader, opts["shuffle_buffer_size"],
                                     seed=opts.get("seed", 0))
    return loader


def _iter_train(loader, epoch: int, opts: Dict):
    """One epoch's batches: the epoch's reshuffle (``set_epoch``), the
    ``train_steps_per_epoch`` cap and the ``transformation_fn`` hook."""
    if hasattr(loader, "set_epoch"):
        loader.set_epoch(epoch)
    cap = opts.get("train_steps_per_epoch")
    transform = opts.get("transformation_fn")
    it = iter(loader) if cap is None else itertools.islice(loader, cap)
    for batch in it:  # islice never pulls a batch past the cap
        yield transform(batch) if transform else batch


def _iter_val_batches(val_path: str, batch_size: int, rank: int,
                      size: int, fs=None, opts: Optional[Dict] = None):
    """This worker's shard of the val set, honouring ``val_batch_size``,
    ``transformation_fn`` and ``validation_steps_per_epoch``."""
    opts = opts or {}
    loader = ParquetDataLoader(val_path,
                               opts.get("val_batch_size") or batch_size,
                               rank=rank, num_workers=size, fs=fs)
    transform = opts.get("transformation_fn")
    val_cap = opts.get("validation_steps_per_epoch")
    it = iter(loader) if val_cap is None else \
        itertools.islice(loader, val_cap)
    for batch in it:
        yield transform(batch) if transform else batch


def _batch_weights(batch, opts) -> Optional[np.ndarray]:
    """Per-row loss weights as an ``(n, 1)`` float64 array, or None
    (reference: ``sample_weight_col``)."""
    col = (opts or {}).get("sample_weight_col")
    if not col:
        return None
    if col not in batch:
        raise ValueError(
            f"sample_weight_col {col!r} not in the batch (columns: "
            f"{sorted(batch)}); the dataset was prepared without it, or "
            "a transformation_fn dropped it")
    return np.asarray(batch[col], np.float64).ravel()[:, None]


def _assemble_batch(batch, feature_cols, label_cols):
    """The feature columns stacked into a 2-D ``x``, the first label column
    a 2-D ``y``."""
    x = np.concatenate([batch[c].reshape(len(batch[c]), -1)
                        for c in feature_cols], axis=1)
    y = batch[label_cols[0]].reshape(len(x), -1)
    return x, y


def _eval_metrics(predict: Callable, val_path: Optional[str],
                  feature_cols, label_cols, metrics, batch_size: int,
                  rank: int, size: int, sync, device=None, fs=None,
                  opts: Optional[Dict] = None) -> Dict[str, float]:
    """The epoch's validation metrics over the sharded val set.  The
    workers' combine is exact: Average(weighted sums) / Average(counts) is
    the global weighted mean whatever the shards' sizes; the sums ride one
    float64 collective on ``device``."""
    if val_path is None or not metrics:
        return {}
    sums = np.zeros((len(metrics) + 1,), np.float64)
    for batch in _iter_val_batches(val_path, batch_size, rank, size,
                                   fs=fs, opts=opts):
        x, y = _assemble_batch(batch, feature_cols, label_cols)
        p = np.asarray(predict(x))
        for j, (_, fn) in enumerate(metrics):
            sums[j] += fn(p, y) * len(x)
        sums[-1] += len(x)
    if size > 1:
        import torch
        sums = sync([torch.from_numpy(sums).to(device)])[0].cpu().numpy()
    denom = max(sums[-1], 1.0)
    return {f"val_{name}": float(sums[j] / denom)
            for j, (name, _) in enumerate(metrics)}


def _epoch_driver(store: Store, run_id: str, epochs: int, metrics,
                  batch_size: int, feature_cols, label_cols,
                  rank: int, size: int, sync,
                  val_path: Optional[str], *,
                  restore: Callable[[bytes], None],
                  serialize: Callable[[], bytes],
                  train_epoch: Callable[[int], float],
                  predict: Callable[[np.ndarray], np.ndarray],
                  device=None,
                  cold_start: Optional[Callable[[], None]] = None,
                  opts: Optional[Dict] = None) -> Dict:
    """The epoch loop every train task shares: resume from the stored
    envelope (or run ``cold_start``, the initial parameter sync), then
    each epoch: train, the val metrics, rank 0's envelope and history log,
    the fault hook."""
    metrics = _resolve_metrics(metrics)
    start_epoch = 0
    history: Dict[str, List[float]] = {}
    env = _load_epoch_checkpoint(store, run_id)
    if env is not None and env["epoch"] >= 0:
        restore(env["model"])
        start_epoch = env["epoch"] + 1
        history = dict(env.get("history") or {})
    elif cold_start is not None:
        cold_start()
    opts = opts or {}
    for epoch in range(start_epoch, epochs):
        history.setdefault("train_loss", []).append(train_epoch(epoch))
        for k, v in _eval_metrics(predict, val_path, feature_cols,
                                  label_cols, metrics, batch_size, rank,
                                  size, sync, device=device, fs=store.fs,
                                  opts=opts).items():
            history.setdefault(k, []).append(v)
        if rank == 0 and opts.get("verbose"):
            parts = [f"{k}={v[-1]:.4f}" for k, v in history.items()]
            print(f"[estimator] epoch {epoch}: " + " ".join(parts),
                  flush=True)
        if rank == 0:
            _save_epoch_checkpoint(store, run_id, epoch, serialize(),
                                   history)
            store.save_log(run_id, pickle.dumps(history))
        _maybe_inject_fault(rank, epoch)
    return history


def _maybe_inject_fault(rank: int, epoch: int) -> None:
    """Fault injection for elastic tests: with
    ``HOROVOD_SPARK_FAULT='<rank>,<epoch>,<marker_path>'`` set and no file
    at the marker yet, the matching worker writes the marker and exits
    hard after that epoch's checkpoint, once."""
    spec = os.environ.get("HOROVOD_SPARK_FAULT")
    if not spec:
        return
    frank, fepoch, marker = spec.split(",", 2)
    if rank == int(frank) and epoch == int(fepoch) and \
            not os.path.exists(marker):
        with open(marker, "w") as f:
            f.write(f"fault injected at rank={rank} epoch={epoch}\n")
        os._exit(17)


def _task_rank_size():
    return (int(os.environ.get("HOROVOD_RANK", "0") or 0),
            int(os.environ.get("HOROVOD_SIZE", "1") or 1))


def _grad_sync_fn():
    """``hvd.init()`` of this task (even alone) and its sync: one
    ``grouped_allreduce(op=Average)`` of a list of device tensors across
    the workers, the identity for one worker.  Returns ``(sync, device,
    owned)``; ``owned`` says this call brought the runtime up."""
    from .. import runtime as _rt
    owned = not _rt.is_initialized()
    rt = _rt.init()
    if rt.size() <= 1:
        return (lambda ts: list(ts)), rt.device, owned
    from ..common.reduce_op import Average
    from ..torch.mpi_ops import grouped_allreduce

    def sync(ts):
        return grouped_allreduce(list(ts), op=Average)
    return sync, rt.device, owned


def _end_task(owned: bool) -> None:
    if owned:
        from .. import runtime as _rt
        _rt.shutdown()


class EstimatorModel:
    """The fitted transformer (reference: HorovodModel,
    common/estimator.py:97-103); ``history`` holds the epochs' train and
    val series."""

    def __init__(self, predict_fn: Callable[[np.ndarray], np.ndarray],
                 feature_cols: Sequence[str], output_col: str = "predict",
                 history: Optional[Dict[str, List[float]]] = None):
        self._predict = predict_fn
        self.feature_cols = list(feature_cols)
        self.output_col = output_col
        self.history = dict(history or {})

    def transform(self, df):
        cols = _as_columns(df)  # every input column stays in the output
        x = np.concatenate(
            [cols[c].reshape(len(cols[c]), -1) for c in self.feature_cols],
            axis=1)
        out = dict(cols)
        out[self.output_col] = self._predict(x)
        return out


class Estimator:
    """The scheduler-agnostic estimator (reference: estimator.py:25-96).
    Subclasses supply ``_make_train_task`` (a picklable callable run in
    each worker) and ``_load_model`` (on the driver: payload -> predict)."""

    def __init__(self, store: Store, num_proc: int = 1,
                 feature_cols: Sequence[str] = ("features",),
                 label_cols: Sequence[str] = ("label",),
                 batch_size: int = 32, epochs: int = 1,
                 run_id: str = "run0",
                 executor: Optional[TaskExecutor] = None,
                 validation=None,
                 metrics: Sequence = (),
                 loss=None,
                 seed: int = 0,
                 shuffle_buffer_size: int = 0,
                 train_steps_per_epoch: Optional[int] = None,
                 validation_steps_per_epoch: Optional[int] = None,
                 val_batch_size: Optional[int] = None,
                 transformation_fn: Optional[Callable] = None,
                 sample_weight_col: Optional[str] = None,
                 verbose: int = 0,
                 coordinator_port: int = 29511):
        """The reference's params (spark/common/params.py):
        ``shuffle_buffer_size`` shuffles each worker's stream in a bounded
        buffer, ``train/validation_steps_per_epoch`` cap the batches of an
        epoch, ``val_batch_size`` sets the eval batch,
        ``transformation_fn`` rewrites each batch dict before assembly,
        ``sample_weight_col`` weights the training loss by row (the val
        metrics stay unweighted, as the reference's), ``verbose`` prints
        rank 0's epochs.  ``coordinator_port``: the tasks' store port."""
        self.store = store
        self.num_proc = num_proc
        self.feature_cols = list(feature_cols)
        self.label_cols = list(label_cols)
        self.batch_size = batch_size
        self.epochs = epochs
        self.run_id = run_id
        self.executor = executor
        self.validation = validation
        self.metrics = list(metrics)
        self.loss = loss
        self.seed = seed
        if int(shuffle_buffer_size) < 0:
            raise ValueError(f"shuffle_buffer_size must be >= 0, got "
                             f"{shuffle_buffer_size}")
        self.shuffle_buffer_size = int(shuffle_buffer_size)
        self.train_steps_per_epoch = train_steps_per_epoch
        self.validation_steps_per_epoch = validation_steps_per_epoch
        self.val_batch_size = val_batch_size
        self.transformation_fn = transformation_fn
        self.sample_weight_col = sample_weight_col
        self.verbose = verbose
        self.coordinator_port = coordinator_port
        _resolve_metrics(self.metrics)  # unknown names fail here

    def _data_opts(self) -> Dict:
        """The data and reporting params every train task takes."""
        return {"shuffle_buffer_size": self.shuffle_buffer_size,
                "train_steps_per_epoch": self.train_steps_per_epoch,
                "validation_steps_per_epoch": self.validation_steps_per_epoch,
                "val_batch_size": self.val_batch_size,
                "transformation_fn": self.transformation_fn,
                "sample_weight_col": self.sample_weight_col,
                "verbose": self.verbose,
                "seed": self.seed}

    def _make_train_task(self) -> Callable:
        raise NotImplementedError

    def _load_model(self, payload: bytes) -> Callable:
        raise NotImplementedError

    def has_checkpoint(self) -> bool:
        """Whether the Store holds this run's envelope: the next ``fit`` or
        ``fit_on_parquet`` then continues from its epoch (reference:
        estimator.py:91-96 ``_has_checkpoint``)."""
        return self.store.read_checkpoint(self.run_id) is not None

    _has_checkpoint = has_checkpoint  # the reference's spelling

    def fit(self, df, elastic: bool = False, min_np: int = 1,
            reset_limit: Optional[int] = 3) -> EstimatorModel:
        """Write ``df`` (with its validation split) into the Store, train
        on ``num_proc`` workers and return the fitted transformer
        (reference: common/estimator.py:25-96).  ``elastic=True`` places
        the job through ``run_elastic``: a task's failure places it again
        at one task fewer (down to ``min_np``), resuming from the last
        epoch envelope."""
        train_path, val_path = prepare_data(
            self.store, df, self.feature_cols, self.label_cols,
            validation=self.validation, seed=self.seed,
            run_id=self.run_id,
            extra_cols=(self.sample_weight_col,)
            if self.sample_weight_col else ())
        return self._fit_on_paths(train_path, val_path, elastic=elastic,
                                  min_np=min_np, reset_limit=reset_limit)

    def fit_on_parquet(self, elastic: bool = False, min_np: int = 1,
                       reset_limit: Optional[int] = 3) -> EstimatorModel:
        """Train on the data already in the Store (reference:
        estimator.fit_on_parquet:37-48): the re-fit after a driver's
        restart, with no prepare step."""
        train_path = self.store.get_train_data_path(self.run_id)
        if not self.store.is_parquet_dataset(train_path):
            raise ValueError(f"no parquet dataset at {train_path}; run "
                             "fit() once (or write the dataset) first")
        val_path = self.store.get_val_data_path(self.run_id)
        if not self.store.is_parquet_dataset(val_path):
            val_path = None
        return self._fit_on_paths(train_path, val_path, elastic=elastic,
                                  min_np=min_np, reset_limit=reset_limit)

    def _fit_on_paths(self, train_path: str, val_path: Optional[str],
                      elastic: bool, min_np: int,
                      reset_limit: Optional[int]) -> EstimatorModel:
        task = self._make_train_task()
        if elastic:
            from .runner import run_elastic
            run_elastic(task, args=(train_path, val_path),
                        num_proc=self.num_proc, min_np=min_np,
                        reset_limit=reset_limit,
                        executor_factory=self._executor_factory(),
                        coordinator_port=self.coordinator_port)
        else:
            spark_run(task, args=(train_path, val_path),
                      num_proc=self.num_proc, executor=self.executor,
                      coordinator_port=self.coordinator_port)
        env = _load_epoch_checkpoint(self.store, self.run_id)
        if env is None:
            raise RuntimeError("training produced no checkpoint")
        return EstimatorModel(self._load_model(env["model"]),
                              self.feature_cols,
                              history=env.get("history"))

    def _executor_factory(self):
        """How ``run_elastic`` rebuilds the placement at a smaller size:
        the executor's own ``with_num_tasks`` keeps its configuration."""
        if self.executor is None:
            return None
        return self.executor.with_num_tasks


# ---------------------------------------------------------------------------
# LinearEstimator

class _SGDTrainTask:
    """The picklable linear-model trainer of :class:`LinearEstimator`: each
    worker streams its shard, each batch's gradients are averaged across
    the workers, rank 0 writes the epoch envelope.  ``w`` and ``b`` are
    float64 tensors on the task's device."""

    def __init__(self, store, run_id, feature_cols, label_cols, batch_size,
                 epochs, lr, metrics=(), opts=None):
        self.store = store
        self.run_id = run_id
        self.feature_cols = feature_cols
        self.label_cols = label_cols
        self.batch_size = batch_size
        self.epochs = epochs
        self.lr = lr
        self.metrics = list(metrics)
        self.opts = dict(opts or {})

    def __call__(self, train_path: str, val_path: Optional[str] = None):
        import torch
        f64 = torch.float64
        rank, size = _task_rank_size()
        sync, dev, owned = _grad_sync_fn()
        loader = _make_train_loader(self.store, train_path,
                                    self.batch_size, rank, size, self.opts)
        # sized through the epochs' own pipeline, so a transformation_fn
        # that changes the shapes sizes w and b
        first = next(_iter_train(loader, 0, self.opts))
        x, y = _assemble_batch(first, self.feature_cols, self.label_cols)
        state = {"w": torch.zeros((x.shape[1], y.shape[1]), dtype=f64,
                                  device=dev),
                 "b": torch.zeros((y.shape[1],), dtype=f64, device=dev)}

        def restore(payload: bytes) -> None:
            for k, v in pickle.loads(payload).items():
                state[k] = torch.from_numpy(
                    np.array(v, np.float64)).to(dev)

        def serialize() -> bytes:
            return pickle.dumps({k: v.cpu().numpy()
                                 for k, v in state.items()})

        def host_batches(epoch: int):
            for batch in _iter_train(loader, epoch, self.opts):
                x, y = _assemble_batch(batch, self.feature_cols,
                                       self.label_cols)
                sw = _batch_weights(batch, self.opts)
                out = {"x": np.asarray(x, np.float64),
                       "y": np.asarray(y, np.float64)}
                if sw is not None:
                    out["sw"] = sw
                yield out

        def train_epoch(epoch: int) -> float:
            total = torch.zeros((), dtype=f64, device=dev)
            nb = 0
            for b in prefetch(host_batches(epoch), device=dev):
                x, y, sw = b["x"], b["y"], b.get("sw")
                diff = x @ state["w"] + state["b"] - y
                err = diff if sw is None else diff * sw
                gw, gb = sync([x.T @ err / len(x), err.mean(dim=0)])
                state["w"] -= self.lr * gw
                state["b"] -= self.lr * gb
                sq = diff ** 2 if sw is None else sw * diff ** 2
                total += sq.mean()
                nb += 1
            return float(total) / max(nb, 1)

        def predict(x: np.ndarray) -> np.ndarray:
            xt = torch.from_numpy(np.asarray(x, np.float64)).to(dev)
            return (xt @ state["w"] + state["b"]).cpu().numpy()

        history = _epoch_driver(
            self.store, self.run_id, self.epochs, self.metrics,
            self.batch_size, self.feature_cols, self.label_cols,
            rank, size, sync, val_path, device=dev, opts=self.opts,
            restore=restore, serialize=serialize, train_epoch=train_epoch,
            predict=predict)
        # w_sum shows every worker ended on the same model
        out = {"mse": history["train_loss"][-1],
               "w_sum": float(state["w"].sum() + state["b"].sum()),
               "device": str(dev)}
        _end_task(owned)
        return out


class LinearEstimator(Estimator):
    """Linear regression by SGD: the whole Store -> parquet -> sharded read
    -> train -> checkpoint -> model flow with no framework model."""

    def __init__(self, *args, lr: float = 0.1, **kwargs):
        super().__init__(*args, **kwargs)
        self.lr = lr

    def _make_train_task(self) -> Callable:
        return _SGDTrainTask(self.store, self.run_id, self.feature_cols,
                             self.label_cols, self.batch_size, self.epochs,
                             self.lr, metrics=self.metrics,
                             opts=self._data_opts())

    def _load_model(self, payload: bytes) -> Callable:
        state = pickle.loads(payload)

        def predict(x: np.ndarray) -> np.ndarray:
            return x @ state["w"] + state["b"]
        return predict


# ---------------------------------------------------------------------------
# TorchEstimator

def _torch_sync_params(model, sync) -> None:
    """Every worker starts from the same weights: ONE grouped average of
    the initial parameters (for an unseeded ``model_fn`` a broadcast would
    give other weights)."""
    import torch
    params = list(model.parameters())
    avgs = sync([p.detach() for p in params])
    with torch.no_grad():
        for p, a in zip(params, avgs):
            p.copy_(a)


def _torch_sync_grads(model, sync) -> None:
    """ONE grouped collective a batch, not one a parameter."""
    with_grads = [p for p in model.parameters() if p.grad is not None]
    for p, g in zip(with_grads, sync([p.grad for p in with_grads])):
        p.grad.copy_(g)


def _forward_numpy(model, x: np.ndarray, device) -> np.ndarray:
    """One no-grad forward of ``x`` (as float32) on ``device``, the output
    on the host; half-precision outputs as float32, which numpy holds."""
    import torch
    with torch.no_grad():
        out = model(torch.from_numpy(np.ascontiguousarray(
            x, np.float32)).to(device))
    if out.dtype in (torch.bfloat16, torch.float16):
        out = out.float()
    return out.cpu().numpy()


def _torch_eval_predict(model, x: np.ndarray, device) -> np.ndarray:
    """One forward in eval mode, train mode restored after."""
    model.eval()
    out = _forward_numpy(model, x, device)
    model.train()
    return out


def _torch_predict_fn(model_fn: Callable, payload: bytes) -> Callable:
    """A state dict's bytes -> an eval-mode predict on the driver's device
    (the runtime's, else the current card; the CPU only when asked for)."""
    import torch
    from .. import runtime as _rt
    dev = _rt.resolve_device()
    model = model_fn().to(dev)
    model.load_state_dict(torch.load(io.BytesIO(payload), map_location=dev,
                                     weights_only=True))
    model.eval()
    return lambda x: _forward_numpy(model, x, dev)


def _torch_loss_fn(loss, weighted: bool = False):
    """The ``loss`` param as a callable(pred, y) -> scalar tensor: a name,
    a torch loss instance or a callable.  ``weighted`` builds a named loss
    unreduced so per-row weights can apply; a custom loss owns its
    reduction, so the two together are refused."""
    import torch
    table = {"mse": torch.nn.MSELoss, "l1": torch.nn.L1Loss,
             "mae": torch.nn.L1Loss, "bce": torch.nn.BCELoss,
             "bce_logits": torch.nn.BCEWithLogitsLoss,
             "cross_entropy": torch.nn.CrossEntropyLoss}
    if isinstance(loss, str) and loss not in table:
        raise ValueError(f"unknown torch loss {loss!r}; named losses: "
                         f"{sorted(table)}")
    if weighted:
        if loss is not None and not isinstance(loss, str):
            raise ValueError(
                "sample_weight_col requires a NAMED loss (or the mse "
                "default) so it can be built unreduced; weight inside "
                "your custom loss instead")
        return table[loss or "mse"](reduction="none")
    if loss is None:
        return torch.nn.MSELoss()
    if isinstance(loss, str):
        return table[loss]()
    return loss


class TorchEstimator(Estimator):
    """Torch estimator (reference: spark/torch/ TorchEstimator): the model
    is built by ``model_fn`` and moved to each worker's device, trained on
    the parquet shards with each batch's gradients averaged across the
    workers, and checkpointed as ``state_dict`` bytes.

    ``loss`` is a name ('mse', 'l1', 'bce', 'bce_logits',
    'cross_entropy'), a torch loss instance or a callable(pred, y);
    ``optimizer_fn`` builds the optimizer from ``model.parameters()``
    (picklable; default SGD at ``lr``)."""

    def __init__(self, store: Store, model_fn: Callable, num_proc: int = 1,
                 lr: float = 1e-3, optimizer_fn: Optional[Callable] = None,
                 **kwargs):
        super().__init__(store, num_proc=num_proc, **kwargs)
        self.model_fn = model_fn
        self.lr = lr
        self.optimizer_fn = optimizer_fn

    def _make_train_task(self) -> Callable:
        return _TorchTrainTask(self.store, self.run_id, self.model_fn,
                               self.feature_cols, self.label_cols,
                               self.batch_size, self.epochs, self.lr,
                               loss=self.loss, metrics=self.metrics,
                               optimizer_fn=self.optimizer_fn,
                               opts=self._data_opts())

    def _load_model(self, payload: bytes) -> Callable:
        return _torch_predict_fn(self.model_fn, payload)


class _TorchTrainTask:
    def __init__(self, store, run_id, model_fn, feature_cols, label_cols,
                 batch_size, epochs, lr, loss=None, metrics=(),
                 optimizer_fn=None, opts=None):
        self.opts = dict(opts or {})
        self.store = store
        self.run_id = run_id
        self.model_fn = model_fn
        self.feature_cols = feature_cols
        self.label_cols = label_cols
        self.batch_size = batch_size
        self.epochs = epochs
        self.lr = lr
        self.loss = loss
        self.metrics = list(metrics)
        self.optimizer_fn = optimizer_fn

    def __call__(self, train_path: str, val_path: Optional[str] = None):
        import torch
        rank, size = _task_rank_size()
        sync, dev, owned = _grad_sync_fn()
        loader = _make_train_loader(self.store, train_path,
                                    self.batch_size, rank, size, self.opts)
        model = self.model_fn().to(dev)
        opt = (self.optimizer_fn(model.parameters()) if self.optimizer_fn
               else torch.optim.SGD(model.parameters(), lr=self.lr))
        weighted = bool(self.opts.get("sample_weight_col"))
        loss_fn = _torch_loss_fn(self.loss, weighted=weighted)
        # class-index losses take (n,) int64 targets, not the (n, 1) float
        # layout of a regression label
        index_target = isinstance(loss_fn, torch.nn.CrossEntropyLoss) or \
            self.loss == "cross_entropy"

        def host_batches(epoch: int):
            for batch in _iter_train(loader, epoch, self.opts):
                x, y = _assemble_batch(batch, self.feature_cols,
                                       self.label_cols)
                out = {"x": np.ascontiguousarray(x, np.float32),
                       "y": (y.ravel().astype(np.int64) if index_target
                             else np.ascontiguousarray(y, np.float32))}
                sw = _batch_weights(batch, self.opts)
                if sw is not None:
                    out["sw"] = np.ascontiguousarray(sw.ravel(), np.float32)
                yield out

        def restore(payload: bytes) -> None:
            model.load_state_dict(torch.load(
                io.BytesIO(payload), map_location=dev, weights_only=True))

        def serialize() -> bytes:
            # CPU tensors, as the JAX package's envelope holds them
            buf = io.BytesIO()
            torch.save({k: v.detach().cpu()
                        for k, v in model.state_dict().items()}, buf)
            return buf.getvalue()

        def train_epoch(epoch: int) -> float:
            total = torch.zeros((), dtype=torch.float64, device=dev)
            nb = 0
            for b in prefetch(host_batches(epoch), device=dev):
                opt.zero_grad()
                loss = loss_fn(model(b["x"]), b["y"])
                if "sw" in b:
                    while loss.dim() > 1:  # per element -> per row
                        loss = loss.mean(dim=-1)
                    loss = (loss * b["sw"]).mean()
                loss.backward()
                if size > 1:
                    _torch_sync_grads(model, sync)
                opt.step()
                total += loss.detach().double()
                nb += 1
            return float(total) / max(nb, 1)

        history = _epoch_driver(
            self.store, self.run_id, self.epochs, self.metrics,
            self.batch_size, self.feature_cols, self.label_cols,
            rank, size, sync, val_path, device=dev, opts=self.opts,
            restore=restore, serialize=serialize, train_epoch=train_epoch,
            predict=lambda x: _torch_eval_predict(model, x, dev),
            cold_start=(lambda: _torch_sync_params(model, sync))
            if size > 1 else None)
        out = history["train_loss"][-1] if history.get("train_loss") \
            else 0.0
        _end_task(owned)
        return out
