"""``horovod_tpu_torch.spark.run``: a training function on the tasks of a
cluster scheduler; the port of ``horovod_tpu/spark/runner.py``.

Reference: horovod/spark/runner.py:47-304 — ``run(fn, num_proc)`` starts a
barrier Spark job whose tasks host the training function; the driver
assigns ranks by task and collects one result per task.

The scheduler's only job is placement.  A ``TaskExecutor`` runs one
callable per task slot and hands it the task's index and every task's
hostname; ``_Task`` derives the task's ``HOROVOD_*`` block from that list
(``runner/hosts.py`` ``env_for_tasks``, as the launcher, Spark and Ray
all do), sets it and calls the function.  A task has no launcher and no
rendezvous KV: ``hvd.init()`` comes up from that env alone (rank 0's host
serves the ``torch.distributed`` store at ``coordinator_port``), and the
planes that publish to the KV (metrics, perf, heartbeats, timeline
chunks, chaos specs) find no address and stay off.

``LocalTaskExecutor`` places tasks on local processes started with
``spawn``: a process forked after CUDA came up in its parent cannot use
the card.  ``SparkTaskExecutor`` places them on a barrier stage of a live
SparkContext and needs pyspark; it never falls back to local processes.

The port's rules beside the JAX module's:

- **Cards.**  A task takes ``cuda:<HOROVOD_LOCAL_RANK>`` at ``hvd.init()``
  and raises there when the process sees no card and was not told to run
  on the CPU.  Two loopback aliases of one machine in one hostname list
  would give two tasks local rank 0, hence one card; on a machine that
  shows cards such a list raises ``ValueError`` before the function runs,
  as the elastic driver's rounds do (``elastic/driver.py``).
- **Results** come back pickled; tensors in them (in lists, tuples and
  dicts) come back on the CPU, so that reading them never touches a card
  in the caller.
- **Fail fast.**  The first task that raises ends its peers, which may
  wait on it in a collective; the JAX executor waits for every task to
  report first.
"""

from __future__ import annotations

import multiprocessing
import os
import pickle
import socket
import sys
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence

from ..runner.hosts import env_for_tasks


class TaskExecutor:
    """Placement backend: run one Python callable per task slot.

    ``task_fn(index, hostnames)`` receives the task's index and the full
    per-task hostname list (index-aligned), so ranks, local and cross
    coordinates included, come from the actual placement."""

    def num_tasks(self) -> int:
        raise NotImplementedError

    def run_tasks(self, task_fn: Callable[[int, List[str]], Any]
                  ) -> List[Any]:
        raise NotImplementedError

    def with_num_tasks(self, n: int) -> "TaskExecutor":
        """This executor rebuilt at another task count, its configuration
        kept: how an elastic reset shrinks the placement.  Subclasses with
        more constructor state must override."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support elastic resizing; "
            "override with_num_tasks(n)")


def _to_host(obj):
    """``obj`` with every tensor in it (through lists, tuples and dicts)
    detached and on the CPU; no-op when torch was never imported."""
    torch = sys.modules.get("torch")
    if torch is None:
        return obj
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return type(obj)((k, _to_host(v)) for k, v in obj.items())
    if isinstance(obj, (list, tuple)) and not hasattr(obj, "_fields"):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _local_task_entry(index: int, payload: bytes, hostnames, q):
    try:
        # before unpickling, which imports the function's module: a task
        # handed no card resolves to the CPU (utils/platform.py)
        from ..utils.platform import apply_env_platform
        apply_env_platform()
        fn = pickle.loads(payload)
        out = pickle.dumps(("ok", _to_host(fn(index, hostnames))))
    except BaseException as e:  # the caller gets the traceback
        out = pickle.dumps(("error", f"{e}\n{traceback.format_exc()}"))
    q.put((index, out))


class LocalTaskExecutor(TaskExecutor):
    """Placement on local processes (the reference's Spark local mode),
    started with ``start_method`` (``spawn`` by default)."""

    def __init__(self, num_tasks: int, start_method: str = "spawn"):
        self._n = num_tasks
        self._start_method = start_method
        self._ctx = multiprocessing.get_context(start_method)

    def num_tasks(self) -> int:
        return self._n

    def with_num_tasks(self, n: int) -> "LocalTaskExecutor":
        return LocalTaskExecutor(n, start_method=self._start_method)

    def run_tasks(self, task_fn: Callable[[int, List[str]], Any]
                  ) -> List[Any]:
        q = self._ctx.Queue()
        payload = pickle.dumps(task_fn)
        hostnames = [socket.gethostname()] * self._n
        procs = [self._ctx.Process(target=_local_task_entry,
                                   args=(i, payload, hostnames, q))
                 for i in range(self._n)]
        for p in procs:
            p.start()
        results: List[Any] = [None] * self._n
        reported = [False] * self._n
        error = None
        try:
            while not all(reported):
                try:
                    i, raw = q.get(timeout=1.0)
                except Exception:  # queue.Empty: are the tasks alive?
                    dead = [j for j, p in enumerate(procs)
                            if not p.is_alive() and not reported[j]]
                    if dead:
                        raise RuntimeError(
                            f"task(s) {dead} died without reporting a "
                            f"result (exitcodes "
                            f"{[procs[j].exitcode for j in dead]}): a "
                            "native crash, a kill or the OOM killer")
                    continue
                status, val = pickle.loads(raw)
                reported[i] = True
                if status == "error":
                    # fail fast: its peers may wait on it in a collective
                    error = (i, val)
                    break
                results[i] = val
        finally:
            for p in procs:
                if not all(reported):
                    p.terminate()
                p.join()
        if error is not None:
            raise RuntimeError(f"task {error[0]} failed: {error[1]}")
        return results


class _spark_partition_entry:
    """Runs inside a barrier task: exchange hostnames, then run.  A class,
    not a closure, so plain pickle carries it."""

    def __init__(self, task_fn):
        self.task_fn = task_fn

    def __call__(self, it):
        from pyspark import BarrierTaskContext
        ctx = BarrierTaskContext.get()
        hostnames = ctx.allGather(socket.gethostname())
        return [self.task_fn(ctx.partitionId(), list(hostnames))]


class SparkTaskExecutor(TaskExecutor):
    """Barrier-stage placement on a live SparkContext (reference:
    spark/runner.py:47-117); hostnames are exchanged with
    ``BarrierTaskContext.allGather``.  Requires pyspark when built."""

    def __init__(self, num_tasks: Optional[int] = None, spark_context=None):
        try:
            import pyspark  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "horovod_tpu_torch.spark.run on a real cluster requires "
                "pyspark; pass executor=LocalTaskExecutor(n) for local "
                "mode") from e
        from pyspark import SparkContext
        self._sc = spark_context or SparkContext.getOrCreate()
        self._n = num_tasks or int(
            self._sc.getConf().get("spark.executor.instances", "1"))

    def num_tasks(self) -> int:
        return self._n

    def with_num_tasks(self, n: int) -> "SparkTaskExecutor":
        return SparkTaskExecutor(n, spark_context=self._sc)

    def run_tasks(self, task_fn: Callable[[int, List[str]], Any]
                  ) -> List[Any]:
        rdd = self._sc.parallelize(range(self._n), self._n)
        return (rdd.barrier()
                .mapPartitions(_spark_partition_entry(task_fn))
                .collect())


def run(fn: Callable, args: Sequence[Any] = (), kwargs: Dict = None,
        num_proc: Optional[int] = None,
        executor: Optional[TaskExecutor] = None,
        env: Optional[Dict[str, str]] = None,
        coordinator_port: int = 29511,
        use_spark: Optional[bool] = None) -> List[Any]:
    """Run ``fn(*args, **kwargs)`` on ``num_proc`` distributed workers;
    returns the per-rank results as a list (reference: spark/runner.py:195
    returns one result per Spark task).

    With no ``executor``, Spark places the tasks when pyspark imports (or
    with ``use_spark=True``, which raises without it), else local
    processes.  ``env`` joins every task's env; ``fn`` must be picklable
    (a module-level function)."""
    kwargs = kwargs or {}
    if executor is None:
        want_spark = use_spark
        if want_spark is None:
            try:
                import pyspark  # noqa: F401
                want_spark = True
            except ImportError:
                want_spark = False
        executor = (SparkTaskExecutor(num_proc) if want_spark
                    else LocalTaskExecutor(num_proc or 1))
    task = _Task(fn, tuple(args), dict(kwargs), coordinator_port,
                 dict(env or {}))
    return executor.run_tasks(task)


def run_elastic(fn: Callable, args: Sequence[Any] = (),
                kwargs: Dict = None,
                num_proc: Optional[int] = None,
                min_np: Optional[int] = None,
                max_np: Optional[int] = None,
                start_timeout: Optional[float] = None,
                elastic_timeout: Optional[float] = None,
                reset_limit: Optional[int] = 3,
                env: Optional[Dict[str, str]] = None,
                executor_factory: Optional[Callable] = None,
                coordinator_port: int = 29511,
                verbose: int = 1) -> List[Any]:
    """Elastic training on a cluster scheduler (reference:
    spark/runner.py:306-334 run_elastic).

    A process group cannot shrink in place, so each failure is a reset:
    the job is placed again at one task fewer (never below ``min_np``) and
    the function resumes from its last durable commit
    (``hvd.elastic.TreeState``).  ``reset_limit`` bounds the resets as the
    reference's parameter does; ``start_timeout`` and ``elastic_timeout``
    are accepted for the reference's signature (the scheduler supervises
    the tasks' start, so there is no registration window to time out).

    ``executor_factory(n)`` builds the placement at size ``n`` for each
    attempt; with None each attempt picks Spark or local processes as
    :func:`run` does."""
    del start_timeout, elastic_timeout  # the reference's signature
    n = num_proc or 1
    lo = max(1, min_np or 1)
    if max_np is not None:
        n = min(n, max_np)
    if n < lo:
        raise ValueError(f"num_proc={n} below min_np={lo}")
    resets = 0
    while True:
        executor = executor_factory(n) if executor_factory else None
        try:
            return run(fn, args=args, kwargs=kwargs, num_proc=n,
                       executor=executor, env=env,
                       coordinator_port=coordinator_port)
        # broad on purpose: a task's death is a RuntimeError from
        # LocalTaskExecutor and a Py4J or Spark exception from a barrier
        # stage; each means "reset and shrink"
        except Exception as e:
            resets += 1
            if reset_limit is not None and resets > reset_limit:
                raise RuntimeError(
                    f"elastic job failed after {resets - 1} resets "
                    f"(reset_limit={reset_limit})") from e
            n = max(lo, n - 1)
            if verbose:
                print(f"[spark.run_elastic] task failure: {e}; reset "
                      f"#{resets} relaunching with np={n}",
                      file=sys.stderr, flush=True)


def check_card_aliases(hostnames: List[str]) -> None:
    """Raise when ``hostnames`` names this machine under two loopback
    aliases and the machine shows cards: each alias's tasks take local
    ranks from 0, so two tasks would share ``cuda:0``."""
    from ..runner.launch import _is_local
    aliases = sorted({h for h in hostnames if _is_local(h)})
    if len(aliases) < 2:
        return
    from ..runner.gpu_discovery import visible_gpu_count
    if visible_gpu_count() > 0:
        raise ValueError(
            f"the tasks' hostnames name this machine as "
            f"{', '.join(aliases)}: each alias's tasks start at local rank "
            "0, so two tasks would take the same card (cuda:<local rank>), "
            "which NCCL cannot do; report this machine under one name, or "
            "hide its cards (CUDA_VISIBLE_DEVICES=) for a CPU job")


class _Task:
    """The picklable per-slot entry: derive this task's rank env from the
    exchanged hostname list, set it, run ``fn`` (reference: the exec_fn
    modules, spark/task/*_exec_fn.py).  The store lands on rank 0's host,
    which every task derives alike from the same list."""

    def __init__(self, fn, args, kwargs, coordinator_port, base_env):
        self.fn = fn
        self.args = args
        self.kwargs = kwargs
        self.coordinator_port = coordinator_port
        self.base_env = base_env

    def __call__(self, index: int, hostnames: List[str]):
        check_card_aliases(hostnames)
        env = dict(self.base_env)
        env.update(env_for_tasks(hostnames, self.coordinator_port)[index])
        os.environ.update(env)
        from ..utils.platform import apply_env_platform
        apply_env_platform()
        return _to_host(self.fn(*self.args, **self.kwargs))
