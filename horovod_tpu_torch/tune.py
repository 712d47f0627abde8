"""Hyperparameter search over distributed training jobs: the port of
``horovod_tpu/tune.py``, with the same domains, trial records and search.

Reference: docs/hyperparameter_search.rst — the reference's story is Ray
Tune orchestrating Horovod trials: ``tune.grid_search`` /
Bayesian-optimization search spaces, a ``DistributedTrainableCreator``
adapting a training function into a resource-scoped trial, and
``tune.report`` from inside the trial.

The Bayesian engine is the port's native Gaussian process + expected
improvement (``csrc/core/optim.cc`` through ``common/basics.py``
``BayesianOptimizer``, the optimizer behind autotune and the same code
as the JAX package's), so no external tuning framework is required.
``distributed_trainable`` places a trial's workers through ``spark.run``'s
executors (``spark/runner.py``), as the JAX package does.

    from horovod_tpu_torch import tune

    def trainable(config):
        ...train...
        tune.report(loss=val_loss)

    result = tune.run(
        trainable,
        config={"lr": tune.loguniform(1e-4, 1e-1),
                "layers": tune.choice([2, 4, 8])},
        metric="loss", mode="min", num_trials=20)
    print(result.best_config, result.best_metric)
"""

from __future__ import annotations

import itertools
import math
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence


# ----------------------------------------------------------- search space
class _Domain:
    """A sampleable axis of the search space."""

    def to_unit(self, v) -> float:
        raise NotImplementedError

    def from_unit(self, u: float):
        raise NotImplementedError

    grid: Optional[Sequence] = None  # set for grid_search axes


@dataclass
class uniform(_Domain):
    low: float
    high: float

    def __post_init__(self):
        if not self.low < self.high:
            raise ValueError(f"uniform requires low < high, got "
                             f"({self.low}, {self.high})")

    def from_unit(self, u):
        return self.low + (self.high - self.low) * min(max(u, 0.0), 1.0)

    def to_unit(self, v):
        return (v - self.low) / max(self.high - self.low, 1e-30)


@dataclass
class loguniform(_Domain):
    low: float
    high: float

    def __post_init__(self):
        # validate at CONSTRUCTION: from_unit runs outside the per-trial
        # error isolation, so a bad bound there would abort the search
        # with a bare "math domain error"
        if not 0.0 < self.low < self.high:
            raise ValueError(f"loguniform requires 0 < low < high, got "
                             f"({self.low}, {self.high})")

    def from_unit(self, u):
        lo, hi = math.log(self.low), math.log(self.high)
        return math.exp(lo + (hi - lo) * min(max(u, 0.0), 1.0))

    def to_unit(self, v):
        lo, hi = math.log(self.low), math.log(self.high)
        return (math.log(v) - lo) / max(hi - lo, 1e-30)


@dataclass
class choice(_Domain):
    options: Sequence

    def from_unit(self, u):
        i = min(int(min(max(u, 0.0), 1.0) * len(self.options)),
                len(self.options) - 1)
        return self.options[i]

    def to_unit(self, v):
        return (list(self.options).index(v) + 0.5) / len(self.options)


@dataclass
class grid_search(_Domain):
    """Exhaustive axis (reference: tune.grid_search) — crossed with every
    other grid axis; continuous axes may not be mixed into a grid run."""

    values: Sequence = field(default_factory=list)

    def __post_init__(self):
        self.grid = list(self.values)


# --------------------------------------------------------------- report()
_report_ctx = threading.local()


def report(**metrics) -> None:
    """Record metrics from inside a trial (reference: tune.report).
    Callable once or per epoch; the LAST reported value of the target
    metric scores the trial.  Outside a trial this is a no-op, so the
    same training function runs standalone."""
    store = getattr(_report_ctx, "metrics", None)
    if store is not None:
        store.update({k: float(v) for k, v in metrics.items()})


@dataclass
class Trial:
    config: Dict[str, Any]
    metrics: Dict[str, float]
    error: Optional[str] = None


@dataclass
class Result:
    best_config: Optional[Dict[str, Any]]
    best_metric: Optional[float]
    trials: List[Trial]
    metric: str
    mode: str


def _run_trial(fn: Callable, config: Dict[str, Any], metric: str) -> Trial:
    _report_ctx.metrics = {}
    try:
        out = fn(dict(config))
        metrics = dict(_report_ctx.metrics)
        if isinstance(out, dict):
            metrics.update({k: float(v) for k, v in out.items()})
        elif out is not None:
            metrics.setdefault(metric, float(out))
        return Trial(config=dict(config), metrics=metrics)
    except Exception as e:  # a failed trial must not kill the search
        return Trial(config=dict(config), metrics={}, error=str(e))
    finally:
        _report_ctx.metrics = None


def run(trainable: Callable, config: Dict[str, Any], metric: str,
        mode: str = "min", num_trials: int = 16, seed: int = 42,
        gp_noise: float = 1e-3, xi: float = 0.01,
        verbose: bool = False) -> Result:
    """Search ``config``'s space for the best trial (reference:
    tune.run).  Plain values pass through to every trial; ``grid_search``
    axes run exhaustively (their cartesian product caps the trial
    count); continuous/choice axes are driven by the native GP+EI
    optimizer, warm-started with a centered first sample.
    """
    if mode not in ("min", "max"):
        raise ValueError(f"mode must be min|max, got {mode!r}")
    fixed = {k: v for k, v in config.items()
             if not isinstance(v, _Domain)}
    grid_axes = {k: v.grid for k, v in config.items()
                 if isinstance(v, grid_search)}
    model_axes = {k: v for k, v in config.items()
                  if isinstance(v, _Domain) and not isinstance(v,
                                                               grid_search)}

    trials: List[Trial] = []

    def score(t: Trial) -> Optional[float]:
        if t.error is not None or metric not in t.metrics:
            return None
        return t.metrics[metric]

    if grid_axes and model_axes:
        raise ValueError(
            "grid_search axes cannot mix with continuous/choice axes in "
            "one run; split into a grid run over a bayes run's best")

    if not grid_axes and not model_axes:
        # nothing to search: one trial (feeding a zero-length sample to
        # the native GP would be undefined behavior)
        trials.append(_run_trial(trainable, dict(fixed), metric))
        s = score(trials[0])
        return Result(trials[0].config if s is not None else None,
                      s, trials, metric, mode)

    if grid_axes:
        keys = list(grid_axes)
        for combo in itertools.product(*(grid_axes[k] for k in keys)):
            cfg = dict(fixed, **dict(zip(keys, combo)))
            trials.append(_run_trial(trainable, cfg, metric))
            if verbose:
                print(f"[tune] {cfg} -> {score(trials[-1])}")
    else:
        from .common.basics import BayesianOptimizer
        keys = list(model_axes)
        bo = BayesianOptimizer(dims=max(len(keys), 1), xi=xi,
                               seed=seed, gp_noise=gp_noise)
        sign = 1.0 if mode == "max" else -1.0
        for i in range(num_trials):
            u = [0.5] * len(keys) if i == 0 else bo.next_sample()
            cfg = dict(fixed, **{k: model_axes[k].from_unit(u[j])
                                 for j, k in enumerate(keys)})
            t = _run_trial(trainable, cfg, metric)
            trials.append(t)
            s = score(t)
            if s is not None and math.isfinite(s):
                bo.add_sample(u, sign * s)
            if verbose:
                print(f"[tune] {cfg} -> {s}")

    scored = [(score(t), t) for t in trials]
    scored = [(s, t) for s, t in scored
              if s is not None and math.isfinite(s)]
    if not scored:
        return Result(None, None, trials, metric, mode)
    best = (min if mode == "min" else max)(scored, key=lambda st: st[0])
    return Result(best[1].config, best[0], trials, metric, mode)


class _WorkerTrial:
    """Picklable worker-side wrapper: captures ``tune.report`` calls made
    INSIDE the worker process (whose thread-local is otherwise invisible
    to the driver) and ships them back with the return value."""

    def __init__(self, fn: Callable):
        self.fn = fn

    def __call__(self, config):
        from horovod_tpu_torch.tune import _report_ctx
        _report_ctx.metrics = {}
        try:
            ret = self.fn(config)
            return ret, dict(_report_ctx.metrics)
        finally:
            _report_ctx.metrics = None


def distributed_trainable(fn: Callable, num_proc: int = 1,
                          executor_factory: Optional[Callable] = None,
                          coordinator_port: int = 29531) -> Callable:
    """Adapt ``fn(config) -> metric`` into a trial that runs on
    ``num_proc`` distributed workers per trial (reference:
    DistributedTrainableCreator's num_hosts/num_slots scoping).  Workers
    are placed through the same layer as ``spark.run``:
    ``executor_factory(num_proc)``, or local processes
    (``LocalTaskExecutor``) when it is None; rank 0 scores the trial —
    via its return value AND any ``tune.report`` calls it made
    (forwarded from the worker process)."""
    def trial(config):
        from .spark.runner import LocalTaskExecutor, run as dist_run
        executor = (executor_factory(num_proc) if executor_factory
                    else LocalTaskExecutor(num_proc))
        out = dist_run(_WorkerTrial(fn), args=(config,),
                       num_proc=num_proc, executor=executor,
                       coordinator_port=coordinator_port)
        ret, reported = out[0]
        if reported:
            report(**reported)
        if ret is None and not reported:
            raise RuntimeError(
                "distributed trial produced no metric: the training "
                "function neither returned a value nor called "
                "tune.report()")
        return ret
    return trial
