"""``RayExecutor``: training on a pool of actors; the port of
``horovod_tpu/ray/runner.py``.

Reference: horovod/ray/runner.py:41-344 — a Coordinator collects the
workers' hostnames, computes ranks, writes the rendezvous env into each
actor, then ``run``/``execute`` drive the training function on every
worker; strategy.py packs workers onto hosts.

A pool carries the four operations the executor needs (create,
hostnames, set_env, execute).  ``RayWorkerPool`` implements them with ray
actors in a placement group and needs ray; ``LocalWorkerPool`` implements
them with local processes, started with ``spawn`` (a process forked after
CUDA came up in its parent cannot use the card), as the reference's own
tests run ray as a local cluster.

As in ``spark/runner.py``: each worker takes ``cuda:<HOROVOD_LOCAL_RANK>``
at ``hvd.init()`` and raises there without a card unless told to run on
the CPU; a hostname list that names this machine under two loopback
aliases raises at ``start`` on a machine that shows cards; tensors in a
result come back on the CPU; a worker that dies raises in the caller.
"""

from __future__ import annotations

import multiprocessing
import os
import pickle
import socket
import traceback
from typing import Any, Callable, Dict, List, Optional

from ..runner.hosts import env_for_tasks
from ..spark.runner import _to_host, check_card_aliases


class BaseWorkerPool:
    """The pool surface the executor drives."""

    def create(self, num_workers: int) -> None:
        raise NotImplementedError

    def hostnames(self) -> List[str]:
        """One entry per worker, in worker order."""
        raise NotImplementedError

    def set_env(self, envs: List[Dict[str, str]]) -> None:
        raise NotImplementedError

    def execute(self, fn: Callable[[], Any]) -> List[Any]:
        raise NotImplementedError

    def shutdown(self) -> None:
        raise NotImplementedError


# ---------------------------------------------------------------- local pool
def _local_pool_worker(conn):
    while True:
        kind, payload = conn.recv()
        if kind == "stop":
            conn.close()
            return
        if kind == "hostname":
            conn.send(("ok", socket.gethostname()))
        elif kind == "env":
            os.environ.update(payload)
            conn.send(("ok", None))
        elif kind == "run":
            try:
                # the "env" message may hand this worker no card: resolve
                # to the CPU before unpickling imports the function's
                # module (utils/platform.py)
                from ..utils.platform import apply_env_platform
                apply_env_platform()
                fn = pickle.loads(payload)
                out = pickle.dumps(("ok", _to_host(fn())))
            except BaseException as e:
                out = pickle.dumps(("error",
                                    f"{e}\n{traceback.format_exc()}"))
            conn.send(("pickled", out))


class LocalWorkerPool(BaseWorkerPool):
    """A pool of local processes, for machines without ray."""

    def __init__(self, start_method: str = "spawn"):
        self._ctx = multiprocessing.get_context(start_method)
        self._procs: List[Any] = []
        self._conns: List[Any] = []

    def create(self, num_workers: int) -> None:
        for _ in range(num_workers):
            parent, child = self._ctx.Pipe()
            p = self._ctx.Process(target=_local_pool_worker, args=(child,))
            p.start()
            child.close()
            self._procs.append(p)
            self._conns.append(parent)

    def _call_all(self, kind: str, payloads) -> List[Any]:
        for conn, payload in zip(self._conns, payloads):
            conn.send((kind, payload))
        # read every pipe before raising: an unread answer would pair
        # with the next call's request
        out, error = [], None
        for i, conn in enumerate(self._conns):
            try:
                status, val = conn.recv()
            except EOFError:
                status, val = "error", (
                    f"worker process died (exitcode "
                    f"{self._procs[i].exitcode}): a native crash, a kill "
                    "or the OOM killer")
            if status == "pickled":
                status, val = pickle.loads(val)
            if status == "error" and error is None:
                error = (i, val)
            out.append(val)
        if error is not None:
            raise RuntimeError(f"worker {error[0]} failed: {error[1]}")
        return out

    def hostnames(self) -> List[str]:
        return self._call_all("hostname", [None] * len(self._conns))

    def set_env(self, envs: List[Dict[str, str]]) -> None:
        self._call_all("env", envs)

    def execute(self, fn: Callable[[], Any]) -> List[Any]:
        payload = pickle.dumps(fn)
        return self._call_all("run", [payload] * len(self._conns))

    def shutdown(self) -> None:
        for conn in self._conns:
            try:
                conn.send(("stop", None))
            except (BrokenPipeError, OSError):
                pass
        for p in self._procs:
            p.join(timeout=10)
            if p.is_alive():
                p.terminate()
                p.join()
        for conn in self._conns:
            conn.close()
        self._procs, self._conns = [], []


# ------------------------------------------------------------------ ray pool
class BaseHorovodWorker:
    """The actor class hosting one training slot (reference:
    horovod/ray/runner.py BaseHorovodWorker, exported so integrations can
    compose it into their own actors).  A plain class; ``RayWorkerPool``
    wraps it with ``ray.remote`` at placement time, as the reference
    does."""

    def hostname(self) -> str:
        return socket.gethostname()

    def set_env(self, env) -> None:
        os.environ.update(env)

    def run(self, payload):
        # actors start with the raylet's env, not the driver's: resolve
        # the platform set_env asked for before loads() imports the
        # function's module
        from horovod_tpu_torch.utils.platform import apply_env_platform
        apply_env_platform()
        return _to_host(pickle.loads(payload)())


class RayWorkerPool(BaseWorkerPool):
    """Ray actors in a placement group, packed or spread (reference:
    strategy.py:32-204).  Requires ray when built."""

    def __init__(self, cpus_per_worker: int = 1,
                 use_gpu: bool = False, gpus_per_worker: int = 0,
                 placement: str = "pack",
                 placement_group_timeout_s: float = 100.0):
        try:
            import ray  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "RayExecutor on a real cluster requires ray; pass "
                "pool=LocalWorkerPool() for ray-less local mode") from e
        self._ray = __import__("ray")
        self.cpus_per_worker = cpus_per_worker
        self.use_gpu = use_gpu
        self.gpus_per_worker = gpus_per_worker
        self.placement = placement
        self.pg_timeout = placement_group_timeout_s
        self._actors: List[Any] = []
        self._pg = None

    def create(self, num_workers: int) -> None:
        ray = self._ray
        worker = ray.remote(BaseHorovodWorker)
        bundle = {"CPU": self.cpus_per_worker}
        if self.use_gpu and self.gpus_per_worker:
            bundle["GPU"] = self.gpus_per_worker
        strategy = "STRICT_PACK" if self.placement == "pack" else "SPREAD"
        self._pg = ray.util.placement_group([bundle] * num_workers,
                                            strategy=strategy)
        ray.get(self._pg.ready(), timeout=self.pg_timeout)
        self._actors = [
            worker.options(placement_group=self._pg,
                           num_cpus=self.cpus_per_worker,
                           num_gpus=self.gpus_per_worker
                           if self.use_gpu else 0).remote()
            for _ in range(num_workers)]

    def hostnames(self) -> List[str]:
        return self._ray.get([a.hostname.remote() for a in self._actors])

    def set_env(self, envs: List[Dict[str, str]]) -> None:
        self._ray.get([a.set_env.remote(e)
                       for a, e in zip(self._actors, envs)])

    def execute(self, fn: Callable[[], Any]) -> List[Any]:
        payload = pickle.dumps(fn)
        return self._ray.get([a.run.remote(payload) for a in self._actors])

    def shutdown(self) -> None:
        for a in self._actors:
            self._ray.kill(a)
        if self._pg is not None:
            self._ray.util.remove_placement_group(self._pg)
        self._actors, self._pg = [], None


# ----------------------------------------------------------------- executor
class RayExecutor:
    """The coordinator (reference: runner.py:128-344 and its Coordinator,
    runner.py:41-127): places the workers, gives ranks host by host (the
    workers of a host take consecutive local ranks), writes each worker's
    env, and drives ``run``/``execute``."""

    def __init__(self, num_workers: int,
                 pool: Optional[BaseWorkerPool] = None,
                 coordinator_port: int = 29513,
                 env: Optional[Dict[str, str]] = None):
        self.num_workers = num_workers
        self.pool = pool if pool is not None else RayWorkerPool()
        self.coordinator_port = coordinator_port
        self.extra_env = dict(env or {})
        self._started = False

    def start(self) -> None:
        self.pool.create(self.num_workers)
        hostnames = self.pool.hostnames()
        check_card_aliases(hostnames)
        # one implementation of the HOROVOD_* env for the launcher, Spark
        # and Ray (runner/hosts.py); the store binds on rank 0's host
        merged = []
        for e in env_for_tasks(hostnames, self.coordinator_port):
            m = dict(self.extra_env)
            m.update(e)
            merged.append(m)
        self.pool.set_env(merged)
        self._started = True

    def run(self, fn: Callable, args=(), kwargs=None) -> List[Any]:
        """Run ``fn(*args, **kwargs)`` on every worker; returns the results
        in rank order (reference: runner.py:250-344 run/execute)."""
        if not self._started:
            raise RuntimeError("call start() first")
        return self.pool.execute(_Closure(fn, tuple(args),
                                          dict(kwargs or {})))

    # the reference exposes both names
    execute = run

    def shutdown(self) -> None:
        self.pool.shutdown()
        self._started = False


class _Closure:
    def __init__(self, fn, args, kwargs):
        self.fn = fn
        self.args = args
        self.kwargs = kwargs

    def __call__(self):
        return self.fn(*self.args, **self.kwargs)
