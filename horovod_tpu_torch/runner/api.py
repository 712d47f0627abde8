"""Programmatic launcher: ``horovod_tpu_torch.run(func, np=N)``, the port
of ``horovod_tpu/runner/api.py``.

Reference: ``horovod.run`` (horovod/__init__.py -> runner/launch.py:763) —
run a function on N distributed workers from inside a Python program and
get the per-rank results back, no CLI involved.

The JAX version places its workers through ``spark/runner.py``'s
``LocalTaskExecutor``; the port has no ``spark/`` yet (ROADMAP queue 1
item 5), so it carries its own local executor, on the launcher itself:
the function goes to the workers pickled through the rendezvous KV (scope
``run``, key ``fn``), each rank runs it under the launcher's env block
(``launch.launch_static``: slot, rendezvous, coordinator and controller
env, fail-fast reap), and puts its result back under ``result.<rank>``.
The function must be importable by the workers (a module-level function);
they get the caller's ``sys.path`` as ``PYTHONPATH``.
"""

from __future__ import annotations

import argparse
import os
import pickle
import socket
import sys
from typing import Any, Callable, Dict, List, Optional, Sequence

SCOPE = "run"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


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
    raises ends the job (the launcher's fail-fast), and ``run`` raises
    RuntimeError with its traceback."""
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
    from . import launch
    from .http_server import RendezvousServer
    ns = launch.make_parser().parse_args(
        ["-np", str(np), "--coordinator-port", str(coordinator_port),
         "--controller-port", str(_free_port())]
        + (["--verbose"] if verbose else []))
    rendezvous = RendezvousServer(shards=launch.resolve_kv_shards(ns))
    rendezvous.start()
    rendezvous.put(SCOPE, "fn", pickle.dumps(
        (func, tuple(args), dict(kwargs or {}))))
    path = [p for p in sys.path if p]
    if os.environ.get("PYTHONPATH"):
        path.append(os.environ["PYTHONPATH"])
    extra = dict(env or {})
    extra["PYTHONPATH"] = os.pathsep.join(path)
    rc = launch.launch_static(
        ns, [sys.executable, "-m", "horovod_tpu_torch.runner.task"],
        rendezvous=rendezvous, extra_env=extra)
    raws = [rendezvous.get(SCOPE, f"result.{rank}") for rank in range(np)]
    outs = [pickle.loads(raw) for raw in raws if raw is not None]
    if rc == 0 and len(outs) == np and all(s == "ok" for s, _ in outs):
        return [val for _, val in outs]
    # a rank that raised reported its traceback; a rank the launcher
    # ended for it did not
    errors = [(r, pickle.loads(raw)[1]) for r, raw in enumerate(raws)
              if raw is not None and pickle.loads(raw)[0] == "error"]
    missing = [r for r, raw in enumerate(raws) if raw is None]
    why = (f"rank {errors[0][0]} raised:\n{errors[0][1]}" if errors else
           f"rank(s) {missing} exited without reporting a result")
    raise RuntimeError(f"run(): the job ended with exit code {rc}; {why}")


__all__ = ["run"]
