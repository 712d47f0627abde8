"""Health plane: per-rank heartbeats and driver-side progress supervision;
the port of ``horovod_tpu/utils/health.py``, names, payloads and the
attribution rule unchanged.

The metrics plane (utils/metrics.py) answers "how is the run doing" and
the tracing plane (utils/timeline.py) "where did the time go"; this
module answers the liveness half of "why did the run die" — the
postmortem plane's live leg (docs/postmortem.md).  Every rank PUTs a
small heartbeat to the rendezvous KV scope ``health`` (key ``rank.N``)
on the aligned fleet clock:

  * ``step`` / ``step_time``: the training loop's progress, recorded by
    :func:`record_step` (the health analog of ``hvd.chaos.step``);
  * native core liveness (``CoordinationCore.health()``): cycle count,
    µs since the last completed cycle, tensor-queue depth, transport
    health — built lock-free in csrc so it answers even mid-wedge;
  * ``pending_collectives``: the stall inspector's submitted-but-not-
    completed count.  This is the attribution key for fleet-wide
    stalls: when every rank freezes, the rank with NOTHING pending is
    the one that stopped feeding the collective everyone else is
    blocked inside.

The rendezvous server renders the scope at ``GET /health`` with
per-rank staleness (runner/http_server.py); the launcher's
:class:`HealthMonitor` turns the same data into heartbeat-lost / stall
verdicts that drive supervision (runner/launch.py --postmortem).

Deliberately stdlib-only with lazy package imports, mirroring
utils/metrics.py, so a heartbeat can never take the job down.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.request
from typing import Any, Callable, Dict, Optional, Tuple

HEALTH_SCOPE = "health"

_step_lock = threading.Lock()
_last_step: Optional[int] = None
_last_step_time: Optional[float] = None  # local wall seconds


def record_step(step: int) -> None:
    """Training-loop progress hook (``hvd.postmortem.record_step(i)``):
    stamps the heartbeat's ``step``/``step_time`` fields so the driver
    can tell a stalled loop from a dead process.  Cheap enough to call
    every step; optional — without it supervision falls back to
    heartbeat presence and native cycle progress alone."""
    global _last_step, _last_step_time
    with _step_lock:
        _last_step = int(step)
        _last_step_time = time.time()


def last_step() -> Tuple[Optional[int], Optional[float]]:
    with _step_lock:
        return _last_step, _last_step_time


def reset_step() -> None:
    """Test hook: forget recorded progress (module-global state)."""
    global _last_step, _last_step_time
    with _step_lock:
        _last_step = None
        _last_step_time = None


def heartbeat_payload(rank: int, clock: Optional[Any] = None,
                      core: Optional[Any] = None,
                      pending_collectives: Optional[int] = None
                      ) -> Dict[str, Any]:
    """One heartbeat, JSON-able.  ``time``/``step_time`` are wall seconds
    PLUS the measured server offset (utils/clocksync.py) — the aligned
    fleet clock — so the driver compares them against its own wall clock
    directly and postmortem events from different ranks order truthfully.
    """
    import os
    offset = float(getattr(clock, "offset", 0.0) or 0.0) if clock else 0.0
    step, step_time = last_step()
    hb: Dict[str, Any] = {
        "rank": int(rank),
        "pid": os.getpid(),
        "time": time.time() + offset,
        "step": step,
        "step_time": (step_time + offset) if step_time is not None
        else None,
    }
    if pending_collectives is not None:
        hb["pending_collectives"] = int(pending_collectives)
    if core is not None:
        try:
            hb["core"] = core.health()
        except Exception:
            pass  # a closing core must not break the heartbeat
    # Memory plane (perf/memstats.py): the last sampled watermark rides
    # the heartbeat so a SIGKILLed rank's FINAL heartbeat carries the
    # pressure evidence the postmortem `oom` classifier reads
    # (docs/memory.md#oom, docs/postmortem.md#taxonomy).
    try:
        from ..perf.memstats import last_sample
        row = last_sample()
        if row is not None:
            hb["mem"] = {"watermark": row.get("watermark"),
                         "bytes_in_use": row.get("bytes_in_use"),
                         "cap_bytes": row.get("cap_bytes"),
                         "source": row.get("source")}
    except Exception:
        pass  # the memory leg must never break the heartbeat
    return hb


class HeartbeatPublisher:
    """Background thread PUT-ing heartbeats to the rendezvous KV (scope
    ``health``, key ``rank.N``).  Mirrors MetricsPublisher: plain urllib
    with a short bounded retry, daemonized, final publish on close() so
    the postmortem sees the last known state.  Deliberately does NOT go
    through runner/http_client.put_kv — an injected chaos KV blackout
    models an application-level outage and must not sever the liveness
    channel that attributes it."""

    SCOPE = HEALTH_SCOPE

    def __init__(self, addr: str, port: int, rank: int,
                 payload_fn: Callable[[], Dict[str, Any]],
                 interval: float = 1.0):
        self.addr = addr
        self.port = int(port)
        self.rank = int(rank)
        self.interval = max(0.05, float(interval))
        self._payload_fn = payload_fn
        # one publish at a time, each taking its payload inside: a
        # payload taken earlier never lands after a newer one (the
        # loop's publishes beside publish_now and close)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if self.addr and self.port:
            self._thread = threading.Thread(target=self._loop, daemon=True)
            self._thread.start()

    def publish_now(self, retries: int = 2) -> bool:
        with self._lock:
            return self._publish(retries=retries)

    def _publish(self, retries: int = 2) -> bool:
        if not (self.addr and self.port):
            return False
        try:
            body = json.dumps(self._payload_fn()).encode()
            # Sharded KV (docs/control-plane.md): route to the health
            # scope's owning shard.  Routing only — still not through
            # put_kv, so a chaos blackout cannot sever liveness.
            from ..runner.http_client import resolve_kv_addr
            addr, port, _ = resolve_kv_addr(self.addr, self.port,
                                            self.SCOPE)
            url = (f"http://{addr}:{port}/{self.SCOPE}/"
                   f"rank.{self.rank}")
            delay = 0.1
            for attempt in range(retries + 1):
                try:
                    req = urllib.request.Request(url, data=body,
                                                 method="PUT")
                    with urllib.request.urlopen(req, timeout=5):
                        pass
                    return True
                except Exception:
                    if attempt >= retries:
                        raise
                    time.sleep(delay)
                    delay = min(delay * 2, 0.5)
            return True
        except Exception:
            return False  # liveness reporting must never kill the job

    def _loop(self) -> None:
        self.publish_now()
        while not self._stop.wait(self.interval):
            self.publish_now()

    def close(self) -> None:
        self._stop.set()
        self.publish_now()


# ------------------------------------------------------- driver-side view
def fleet_health(heartbeats: Dict[str, bytes],
                 receipt_times: Dict[str, float],
                 now: Optional[float] = None,
                 stale_after: float = 10.0) -> Dict[str, Any]:
    """Render the ``health`` KV scope as the fleet view ``GET /health``
    serves: rank -> {heartbeat, age_s, stale}.  Staleness uses the
    SERVER's receipt time, not the heartbeat's self-reported clock, so
    a rank with a broken clock still ages honestly."""
    now = time.time() if now is None else now
    ranks: Dict[str, Any] = {}
    for key in sorted(heartbeats):
        if not key.startswith("rank."):
            continue
        try:
            hb = json.loads(heartbeats[key])
        except (ValueError, TypeError):
            continue  # a torn PUT must not 500 the whole view
        rank = str(hb.get("rank", key.split(".", 1)[1]))
        received = receipt_times.get(key)
        age = (now - received) if received is not None else None
        ranks[rank] = {
            "heartbeat": hb,
            "age_s": round(age, 3) if age is not None else None,
            "stale": bool(age is not None and age > stale_after),
        }
    return {"now": now, "stale_after_s": stale_after, "ranks": ranks}


class HealthMonitor:
    """Launcher-side supervision verdicts from the fleet's heartbeats
    (launch --postmortem; docs/postmortem.md).

    Two consumers act on the verdicts: the static launcher SIGABRTs the
    rank and lets the job die with forensics (runner/launch.py), while
    the elastic driver SIGABRTs and then RESETS the fleet — for a
    serving fleet a wedged engine means an elastic restart, not job
    death, and the request journal redrives what was in flight
    (elastic/driver.py; docs/serving.md#fault-tolerance).  The monitor
    is round-scoped there: the driver clears the ``health`` KV scope at
    every reset and builds a fresh monitor, so a dead incarnation's
    stale heartbeats never read as losses.  Serving workers tick
    :func:`record_step` every loop iteration (idle included), so an
    idle fleet looks alive and only a genuinely frozen loop stalls.

    Two failure modes, judged per check against ``timeout`` seconds:

      * **heartbeat-lost** — a rank that heartbeated before has gone
        silent (daemon publisher dead => process dead or unreachable);
      * **stall** — heartbeats keep arriving but recorded progress
        froze fleet-wide.  Attribution: among frozen ranks, suspect the
        ones with ``pending_collectives == 0`` — everyone else is
        blocked INSIDE a collective waiting for them.  When every
        frozen rank is blocked (no such rank), fall back to the oldest
        ``step_time`` only if the WHOLE live fleet froze, since a
        partially-frozen fleet with all suspects blocked points at a
        peer that already exited (the exit record attributes that).
    """

    def __init__(self, snapshots_fn: Callable[[], Dict[str, Any]],
                 timeout: float = 10.0):
        self._snapshots_fn = snapshots_fn  # -> fleet_health() shape
        self.timeout = float(timeout)
        self._seen: set = set()

    def verdicts(self, live_ranks) -> Dict[int, str]:
        """rank -> "heartbeat-lost" | "stall" for live ranks needing
        intervention this check (empty when the fleet looks healthy)."""
        try:
            view = self._snapshots_fn()
        except Exception:
            return {}  # supervision must never take the launcher down
        now = float(view.get("now") or time.time())
        ranks = view.get("ranks", {})
        out: Dict[int, str] = {}
        frozen: Dict[int, Dict[str, Any]] = {}
        for r in live_ranks:
            info = ranks.get(str(r))
            if info is None:
                continue  # never heartbeated: bring-up, not a loss
            self._seen.add(r)
            age = info.get("age_s")
            if age is not None and age > self.timeout:
                out[r] = "heartbeat-lost"
                continue
            hb = info.get("heartbeat", {})
            st = hb.get("step_time")
            if st is not None and now - float(st) > self.timeout:
                frozen[r] = hb
        if frozen:
            idle = [r for r, hb in frozen.items()
                    if hb.get("pending_collectives") == 0]
            if idle:
                for r in idle:
                    out[r] = "stall"
            elif len(frozen) == len(list(live_ranks)):
                oldest = min(frozen,
                             key=lambda r: float(frozen[r]["step_time"]))
                out[oldest] = "stall"
        return out
