"""Programmatic launcher: ``horovod_tpu_torch.run(func, np=N)``, the port
of ``horovod_tpu/runner/api.py``.

Reference: ``horovod.run`` (horovod/__init__.py -> runner/launch.py:763) —
run a function on N distributed workers from inside a Python program and
get the per-rank results back, no CLI involved.

As in the JAX package, the workers are placed by ``spark/runner.py``'s
``LocalTaskExecutor``: local processes started with ``spawn``, each with
the ``HOROVOD_*`` block of ``runner/hosts.py`` ``env_for_tasks`` and the
``torch.distributed`` store at ``coordinator_port``.  There is no
launcher and no rendezvous KV: the function and its result travel
pickled between the caller and its workers, so ``func`` must be
importable by them (a module-level function).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence


def run(func: Callable, args: Sequence[Any] = (),
        kwargs: Optional[Dict] = None, np: Optional[int] = None,
        hosts: Optional[str] = None,
        env: Optional[Dict[str, str]] = None,
        coordinator_port: int = 29515,
        verbose: bool = False) -> List[Any]:
    """Run ``func(*args, **kwargs)`` on ``np`` workers; returns one result
    per rank, in rank order (reference semantics: horovod.run).

    ``np`` defaults to the total slots of ``hosts`` (else 1).  ``hosts``
    other than localhost raises NotImplementedError: use the launcher CLI
    for multi-host jobs.  ``env`` joins every worker's env.  A worker that
    raises ends the job, and ``run`` raises RuntimeError with its
    traceback."""
    if hosts is not None:
        from .hosts import parse_hosts
        infos = parse_hosts(hosts)
        if not all(h.hostname in ("localhost", "127.0.0.1")
                   for h in infos):
            raise NotImplementedError(
                "programmatic run() supports localhost placement; use "
                "python -m horovod_tpu_torch.runner.launch for multi-host "
                "jobs (reference: horovodrun CLI)")
        slots = sum(h.slots for h in infos)
        if np is None:
            np = slots
        elif np > slots:
            raise ValueError(
                f"np={np} exceeds the {slots} slots of hosts={hosts!r}")
    if np is None:
        np = 1
    if verbose:
        print(f"[horovod_tpu_torch.run] launching {np} local worker "
              f"process(es), coordinator port {coordinator_port}")
    from ..spark.runner import LocalTaskExecutor, run as _run
    return _run(func, args=args, kwargs=kwargs or {}, num_proc=np,
                executor=LocalTaskExecutor(np), env=env,
                coordinator_port=coordinator_port)


__all__ = ["run"]
