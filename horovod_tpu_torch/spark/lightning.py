"""Lightning estimator: train a ``LightningModule`` on Spark-managed data;
the port of ``horovod_tpu/spark/lightning.py``.

Reference: horovod/spark/lightning/estimator.py:100+ (TorchEstimator on
pytorch_lightning) and remote.py's RemoteTrainer: the estimator ships a
LightningModule to every worker, trains it under horovod with the
module's own ``configure_optimizers``/``training_step`` hooks, and returns
a servable model.

The train task drives the LightningModule *protocol*
(``configure_optimizers``, ``training_step``, ``validation_step``,
``on_train_epoch_end``, ``self.log``) over the workers' parquet shards,
with the gradients averaged across the workers every batch.  Any object
with those methods trains: a ``pytorch_lightning.LightningModule``
subclass, or a plain object, and lightning itself is not needed.

The port's rules beside the JAX module's:

- **Placement.**  The task calls ``hvd.init()``, even alone, and trains
  on ``cuda:<local rank>`` (the CPU only when the caller asked for it,
  ``utils/platform.py``; with no card and no such request it raises).  A
  protocol object need not have ``.to``, so ``model_fn`` runs under
  ``with torch.device(dev):``, and ``.to(dev)`` follows where the module
  has it (an ``nn.Module``, a real LightningModule); ``configure_optimizers``
  then sees parameters on the device (``estimator.py`` ``_build_module``).
  Batches are staged to the device through ``data/loader.py``
  ``prefetch``.  The driver's ``transform`` builds the module the same
  way, on its own device.
- **Batches** are float32 features and labels, as the JAX task casts
  them; token ids below 2**24 survive the cast exactly.
- **Sync.**  Gradients: one grouped average a batch, after ``backward``
  and before the clip; the initial parameters: averaged once at more than
  one task (not a broadcast).  The stop flag, the validation sums and the
  validation metrics that ``self.log`` accumulated are float64 device
  tensors through the same sync, with no numpy round trip.
- **Envelope.**  ``torch.save`` of a CPU ``state_dict``, restored with
  ``map_location`` to the task's device: a Store written by either
  package resumes in the other.
"""

from __future__ import annotations

import io
from typing import Callable, Optional

import numpy as np

from ..data.loader import prefetch
from .estimator import (Estimator, _assemble_batch, _build_module,
                        _end_task, _epoch_driver, _grad_sync_fn, _iter_train,
                        _iter_val_batches, _make_train_loader,
                        _resolve_metrics, _task_rank_size,
                        _torch_eval_predict, _torch_predict_fn,
                        _torch_sync_grads, _torch_sync_params)
from .store import Store


def _is_optimizer(obj) -> bool:
    return hasattr(obj, "param_groups")


def _unwrap_scheduler(sched):
    """A scheduler, or Lightning's scheduler config (``{"scheduler": s,
    "interval": "step", "frequency": N}``), as the triple ``(scheduler,
    interval, frequency)``, or None, so the loop keeps the declared
    cadence."""
    if sched is None:
        return None
    if isinstance(sched, dict):
        inner = sched.get("scheduler")
        if inner is None:
            return None
        return (inner, sched.get("interval", "epoch"),
                int(sched.get("frequency", 1)))
    return sched, "epoch", 1


def _first_optimizer(configured):
    """What ``configure_optimizers`` returned (an optimizer, a list or tuple
    of them, an ``(optimizers, schedulers)`` pair, the dict form
    ``{"optimizer": ..., "lr_scheduler": ...}`` or a list of such dicts) as
    ``(optimizer, scheduler triple or None)``.  A 2-tuple of optimizers is
    the multi-optimizer form, not an optimizer and its scheduler; None is
    Lightning's manual optimization, which raises."""
    if configured is None:
        raise NotImplementedError(
            "configure_optimizers returned None (lightning manual "
            "optimization); LightningEstimator drives automatic "
            "optimization — return an optimizer")
    if isinstance(configured, dict):
        return (configured["optimizer"],
                _unwrap_scheduler(configured.get("lr_scheduler")))
    sched = None
    if isinstance(configured, tuple) and len(configured) == 2 and \
            not _is_optimizer(configured[1]):
        opts, scheds = configured
        opt = opts[0] if isinstance(opts, (list, tuple)) else opts
        if isinstance(scheds, (list, tuple)) and scheds:
            sched = scheds[0]
        elif scheds is not None and not isinstance(scheds, (list, tuple)):
            sched = scheds
        return opt, _unwrap_scheduler(sched)
    if isinstance(configured, (list, tuple)):
        first = configured[0]
        if isinstance(first, dict):  # a list of dict configs
            return (first["optimizer"],
                    _unwrap_scheduler(first.get("lr_scheduler")))
        return first, None
    return configured, None


class _TrainerProxy:
    """The stand-in handed to callbacks where Lightning passes its Trainer:
    ``current_epoch``, ``global_step``, ``callback_metrics`` (the
    ``self.log`` sink), ``should_stop`` (writable, synced across the
    workers), ``is_global_zero``, and the flags simple callbacks read."""

    def __init__(self, rank: int):
        self.current_epoch = 0
        self.global_step = 0
        self.callback_metrics: dict = {}
        self.should_stop = False
        self.is_global_zero = rank == 0
        self.sanity_checking = False
        self.fast_dev_run = False


class _CallbackList:
    """Duck-typed Lightning callback dispatch: each hook fires on the
    callbacks that define it."""

    def __init__(self, callbacks, proxy, module):
        self.cbs = list(callbacks or ())
        self.proxy = proxy
        self.module = module

    def fire(self, hook: str, *args) -> None:
        for cb in self.cbs:
            fn = getattr(cb, hook, None)
            if fn is not None:
                fn(self.proxy, self.module, *args)


class LightningEstimator(Estimator):
    """Estimator over a LightningModule factory (reference:
    spark/lightning/estimator.py TorchEstimator(model=...)).  ``model_fn``
    builds the module in each worker.

    Beside the base Estimator's data and fit knobs:

    * ``callbacks``: Lightning-style callbacks; the loop fires
      on_train_start, on_train_epoch_start, on_train_batch_end,
      on_validation_epoch_end, on_train_epoch_end and on_train_end with a
      Trainer proxy (:class:`_TrainerProxy`).  Callbacks that read
      ``callback_metrics`` and set ``should_stop`` work; pytorch_lightning's
      own EarlyStopping expects a whole ``pl.Trainer``.
    * ``logger`` and ``log_every_n_steps``: anything with
      ``log_metrics(dict, step)``; ``self.log(...)`` inside the steps is
      captured and flushed on the cadence (at epoch ends only when <= 0),
      on rank 0 only.
    * ``validation_step``: with a validation set, run every epoch; its
      row-weighted mean goes into the history as ``val_loss``, beside the
      epoch means of what it logged.
    * ``gradient_clip_val``: clip by norm before every step.

    ``sample_weight_col`` is refused (``training_step`` owns the loss), as
    is a metric named ``loss`` (its ``val_loss`` would collide with
    ``validation_step``'s)."""

    def __init__(self, store: Store, model_fn: Callable, num_proc: int = 1,
                 callbacks=(), logger=None, log_every_n_steps: int = 50,
                 gradient_clip_val: Optional[float] = None, **kwargs):
        super().__init__(store, num_proc=num_proc, **kwargs)
        if self.sample_weight_col:
            raise ValueError(
                "LightningEstimator does not support sample_weight_col: "
                "training_step owns the loss — weight it inside the "
                "module")
        if any(name == "loss"
               for name, _ in _resolve_metrics(self.metrics)):
            raise ValueError(
                "a metric named 'loss' collides with validation_step's "
                "val_loss history series; rename the metric")
        self.model_fn = model_fn
        self.callbacks = list(callbacks or ())
        self.logger = logger
        self.log_every_n_steps = int(log_every_n_steps)
        self.gradient_clip_val = gradient_clip_val

    def _make_train_task(self) -> Callable:
        return _LightningTrainTask(self.store, self.run_id, self.model_fn,
                                   self.feature_cols, self.label_cols,
                                   self.batch_size, self.epochs,
                                   metrics=self.metrics,
                                   opts=self._data_opts(),
                                   callbacks=self.callbacks,
                                   logger=self.logger,
                                   log_every_n_steps=self.log_every_n_steps,
                                   gradient_clip_val=self.gradient_clip_val)

    def _load_model(self, payload: bytes) -> Callable:
        return _torch_predict_fn(self.model_fn, payload)


class _LightningTrainTask:
    """The picklable per-worker trainer: the Trainer's loop over the
    LightningModule protocol (reference: lightning/remote.py
    RemoteTrainer's train function)."""

    def __init__(self, store, run_id, model_fn, feature_cols, label_cols,
                 batch_size, epochs, metrics=(), opts=None,
                 callbacks=(), logger=None, log_every_n_steps=50,
                 gradient_clip_val=None):
        self.opts = dict(opts or {})
        self.store = store
        self.run_id = run_id
        self.model_fn = model_fn
        self.feature_cols = feature_cols
        self.label_cols = label_cols
        self.batch_size = batch_size
        self.epochs = epochs
        self.metrics = list(metrics)
        self.callbacks = list(callbacks or ())
        self.logger = logger
        self.log_every_n_steps = int(log_every_n_steps)
        self.gradient_clip_val = gradient_clip_val

    def __call__(self, train_path: str, val_path: Optional[str] = None):
        import torch
        f64 = torch.float64
        rank, size = _task_rank_size()
        sync, dev, owned = _grad_sync_fn()
        loader = _make_train_loader(self.store, train_path,
                                    self.batch_size, rank, size, self.opts)
        module = _build_module(self.model_fn, dev)
        opt, sched_cfg = _first_optimizer(module.configure_optimizers())
        sched, interval, freq = sched_cfg or (None, "epoch", 1)

        proxy = _TrainerProxy(rank)
        cbs = _CallbackList(self.callbacks, proxy, module)
        logger = self.logger if rank == 0 else None
        pending_logs: dict = {}
        # inside validation, self.log accumulates (Lightning's on_epoch
        # default): name -> (weighted sum, rows), float64 on the device
        val_ctx = {"active": False, "bs": 0, "accum": {}}

        def log_shim(name, value, *args, **kwargs):
            if val_ctx["active"]:
                v = (value.detach().to(dev, f64) if torch.is_tensor(value)
                     else torch.tensor(float(value), dtype=f64, device=dev))
                s, n = val_ctx["accum"].get(name, (0.0, 0))
                val_ctx["accum"][name] = (s + v * val_ctx["bs"],
                                          n + val_ctx["bs"])
                return
            v = float(value.detach() if hasattr(value, "detach") else value)
            proxy.callback_metrics[name] = v
            pending_logs[name] = v

        module.log = log_shim  # an instance attribute shadows the method

        def flush_logs(force=False):
            if logger is None or not pending_logs:
                return
            every = self.log_every_n_steps
            if force or (every > 0 and proxy.global_step % every == 0):
                logger.log_metrics(dict(pending_logs),
                                   step=proxy.global_step)
                pending_logs.clear()

        def synced_should_stop() -> bool:
            # one rank's stop is every rank's: a rank that left the epoch
            # loop alone would leave the others waiting in the next sync
            if size > 1:
                flag = torch.tensor([1.0 if proxy.should_stop else 0.0],
                                    dtype=f64, device=dev)
                proxy.should_stop = bool(sync([flag])[0].max() > 0.0)
            return proxy.should_stop

        def restore(payload: bytes) -> None:
            module.load_state_dict(torch.load(
                io.BytesIO(payload), map_location=dev, weights_only=True))

        def serialize() -> bytes:
            # CPU tensors, as the JAX package's envelope holds them
            buf = io.BytesIO()
            torch.save({k: v.detach().cpu()
                        for k, v in module.state_dict().items()}, buf)
            return buf.getvalue()

        def host_batches(batches):
            for batch in batches:
                x, y = _assemble_batch(batch, self.feature_cols,
                                       self.label_cols)
                yield (np.ascontiguousarray(x, np.float32),
                       np.ascontiguousarray(y, np.float32))

        started = {"done": False}

        def train_epoch(epoch: int) -> float:
            if not started["done"]:  # after a possible resume's restore
                started["done"] = True
                if epoch > 0 and proxy.global_step == 0:
                    # a resume: the step count the epochs before it took
                    # (exact for uniform epochs), so the logger's series
                    # and step-interval schedulers keep their place
                    per = len(loader)
                    cap = self.opts.get("train_steps_per_epoch")
                    if cap:
                        per = min(per, int(cap))
                    proxy.global_step = epoch * per
                cbs.fire("on_train_start")
            proxy.current_epoch = epoch
            cbs.fire("on_train_epoch_start")
            module.train()
            total = torch.zeros((), dtype=f64, device=dev)
            nb = 0
            for i, bt in enumerate(prefetch(host_batches(
                    _iter_train(loader, epoch, self.opts)), device=dev)):
                opt.zero_grad()
                out = module.training_step(bt, i)
                if out is None:
                    continue  # Lightning's skip-this-batch signal
                loss = out["loss"] if isinstance(out, dict) else out
                loss.backward()
                if size > 1:
                    _torch_sync_grads(module, sync)
                if self.gradient_clip_val:
                    torch.nn.utils.clip_grad_norm_(
                        module.parameters(), self.gradient_clip_val)
                opt.step()
                total += loss.detach().to(f64)
                nb += 1
                proxy.global_step += 1
                cbs.fire("on_train_batch_end", out, bt, i)
                flush_logs()
                if sched is not None and interval == "step" and \
                        proxy.global_step % freq == 0:
                    sched.step()
            if sched is not None and interval == "epoch" and \
                    (epoch + 1) % freq == 0:
                sched.step()
            if hasattr(module, "on_train_epoch_end"):
                module.on_train_epoch_end()
            # the callbacks' on_train_epoch_end fires after this epoch's
            # validation, as Lightning orders them (epoch_end below)
            return float(total) / max(nb, 1)

        def validate() -> dict:
            """``validation_step`` over this worker's val shard: the loss's
            row-weighted sum and rows, and what ``self.log`` accumulated,
            each combined exactly across the workers by one sync; the
            results as host floats."""
            module.eval()
            sums = torch.zeros((2,), dtype=f64, device=dev)
            val_ctx.update(active=True, accum={})
            try:
                with torch.no_grad():
                    for i, bt in enumerate(prefetch(host_batches(
                            _iter_val_batches(val_path, self.batch_size,
                                              rank, size, fs=self.store.fs,
                                              opts=self.opts)),
                            device=dev)):
                        n = int(bt[0].shape[0])
                        val_ctx["bs"] = n
                        out = module.validation_step(bt, i)
                        if out is None:
                            continue
                        loss = out["loss"] if isinstance(out, dict) else out
                        # plain floats and numpy scalars are legal outputs
                        sums[0] += (loss.detach().to(dev, f64)
                                    if torch.is_tensor(loss)
                                    else float(loss)) * n
                        sums[1] += n
            finally:
                val_ctx["active"] = False
            names = sorted(val_ctx["accum"])
            logged = [torch.stack([val_ctx["accum"][k][0],
                                   torch.tensor(float(val_ctx["accum"][k][1]),
                                                dtype=f64, device=dev)])
                      for k in names]
            if size > 1:
                sums, *logged = sync([sums] + logged)
            out = {k: tuple(m.tolist()) for k, m in zip(names, logged)}
            out["val_loss"] = tuple(sums.tolist())
            return out

        def epoch_end(epoch: int) -> dict:
            """The epoch's tail in Lightning's order: ``validation_step``,
            then the callbacks' epoch end, so that a stopping callback sees
            this epoch's ``val_loss``."""
            out_hist = {}
            if val_path is not None and \
                    hasattr(module, "validation_step"):
                combined = validate()
                s, n = combined.pop("val_loss")
                for k, (ks, kn) in combined.items():
                    if kn > 0:
                        mv = ks / kn
                        proxy.callback_metrics[k] = mv
                        pending_logs[k] = mv
                        out_hist[k] = mv
                if n > 0:
                    # n == 0: every batch returned None (a real
                    # LightningModule that kept the base class's hook); a
                    # val_loss of 0.0 would feed stopping callbacks a
                    # perfect constant
                    val_loss = s / n
                    proxy.callback_metrics["val_loss"] = val_loss
                    pending_logs["val_loss"] = val_loss
                    cbs.fire("on_validation_epoch_end")
                    out_hist["val_loss"] = val_loss
            cbs.fire("on_train_epoch_end")
            flush_logs(force=True)
            return out_hist

        history = _epoch_driver(
            self.store, self.run_id, self.epochs, self.metrics,
            self.batch_size, self.feature_cols, self.label_cols,
            rank, size, sync, val_path, device=dev, opts=self.opts,
            restore=restore, serialize=serialize, train_epoch=train_epoch,
            predict=lambda x: _torch_eval_predict(module, x, dev),
            cold_start=(lambda: _torch_sync_params(module, sync))
            if size > 1 else None,
            extra_eval=epoch_end, should_stop=synced_should_stop)
        cbs.fire("on_train_end")
        flush_logs(force=True)
        if logger is not None and hasattr(logger, "finalize"):
            logger.finalize("success")
        out = history["train_loss"][-1] if history.get("train_loss") \
            else 0.0
        _end_task(owned)
        return out


__all__ = ["LightningEstimator"]
