"""Chaos plane: deterministic, seeded fault injection across the stack;
the port of ``horovod_tpu/chaos/``, whose specs, seeds and schedules it
keeps.  The port's hook points: ``maybe_stall("negotiate")`` in
``ops/negotiated.py``, ``maybe_stall("complete")`` in ``utils/stall.py``,
the KV blackout in ``runner/http_client.py``, ``step`` and
``maybe_stall("serve_tick")`` in ``serve/worker.py``, and ``crash_point``
between the data and the marker of ``elastic/fastcommit.py``.

The repo has the recovery machinery — elastic driver reset rounds,
fastcommit durability, the native controller, the straggler report — but
recovery code that is never exercised is a claim, not a capability.  This
package turns every resilience claim into a repeatable experiment:

  * **spec** (:mod:`.spec`): one YAML/JSON document describing the faults
    — kill rank N at step S, stall (straggler) a rank at a named point,
    black out the rendezvous KV for a window, crash mid-fastcommit — plus
    native transport faults (drop/delay/dup/close on controller frames,
    executed inside csrc/transport.cc).
  * **injector** (:mod:`.injector`): per-rank deterministic executor; the
    same seed replays the same schedule.
  * **distribution**: ``launch --chaos spec.yaml`` publishes the spec to
    the rendezvous KV; every worker's runtime installs its injector from
    that one plan (:func:`ensure_installed`).

The port's tests: ``tests/torch_port/test_torch_chaos.py`` (specs,
schedules, the injector), ``test_torch_forensics_gloo.py`` (a kill, a
stall, a straggler under the launcher) and ``test_torch_elastic_gloo.py``
(elastic kill recovery, the torn commit never restored).
"""

from __future__ import annotations

import threading
from typing import Optional

from ..common import hvdlogging as log
from .injector import ChaosInjector, rank_stream_seed  # noqa: F401
from .spec import (  # noqa: F401
    ChaosEvent, ChaosSpec, load_spec, loads_spec, merge_specs,
    parse_spec)

KV_SCOPE = "chaos"
KV_KEY = "spec"

_lock = threading.Lock()
_injector: Optional[ChaosInjector] = None


def install(spec: ChaosSpec, rank: int) -> ChaosInjector:
    """Install the process-global injector (idempotent per process; a
    second install replaces the first — elastic soft resets keep one)."""
    global _injector
    with _lock:
        _injector = ChaosInjector(spec, rank)
        return _injector


def uninstall() -> None:
    global _injector
    with _lock:
        _injector = None


def active() -> Optional[ChaosInjector]:
    return _injector


def step(n: int) -> None:
    """Training-loop hook: fires step-scheduled events (kill/stall) on
    this rank.  A no-op when no chaos plane is installed, so training
    code can call it unconditionally."""
    inj = _injector
    if inj is not None:
        inj.on_step(n)


def maybe_stall(point: str) -> None:
    inj = _injector
    if inj is not None:
        inj.maybe_stall(point)


def crash_point(point: str, step: Optional[int] = None) -> None:
    inj = _injector
    if inj is not None:
        inj.crash_point(point, step)


def ensure_installed(knobs=None, rank: Optional[int] = None
                     ) -> Optional[ChaosInjector]:
    """Install the injector from the environment (called by the runtime
    at init; safe to call from spec-less processes — returns None).

    Resolution order: the rendezvous-KV spec published by ``launch
    --chaos`` (HOROVOD_CHAOS=1), then a local HOROVOD_CHAOS_SPEC file.
    Chaos is tooling around the job, not the job: any failure to fetch or
    parse the spec logs a warning and leaves the plane uninstalled rather
    than taking the worker down."""
    if _injector is not None:
        return _injector
    if knobs is None:
        from ..common.knobs import Knobs
        knobs = Knobs()
    if rank is None:
        rank = max(int(knobs["HOROVOD_RANK"]), 0)
    text = None
    try:
        if knobs["HOROVOD_CHAOS"] and knobs["HOROVOD_RENDEZVOUS_ADDR"] \
                and knobs["HOROVOD_RENDEZVOUS_PORT"]:
            from ..runner.http_client import get_kv
            raw = get_kv(knobs["HOROVOD_RENDEZVOUS_ADDR"],
                         knobs["HOROVOD_RENDEZVOUS_PORT"],
                         KV_SCOPE, KV_KEY, timeout=10)
            if raw:
                text = raw.decode()
        if text is None and knobs["HOROVOD_CHAOS_SPEC"]:
            with open(knobs["HOROVOD_CHAOS_SPEC"]) as f:
                text = f.read()
        if text is None:
            return None
        return install(loads_spec(text), rank)
    except Exception as e:
        log.warning("chaos: spec install failed (plane disabled): %s", e)
        return None
