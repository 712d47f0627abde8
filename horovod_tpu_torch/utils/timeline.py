"""Distributed Chrome-trace timeline of collective activity: the port of
``horovod_tpu/utils/timeline.py``.

The reference writes a Chrome-trace JSON of every tensor's
NEGOTIATE -> QUEUE -> EXEC lifecycle from a dedicated writer thread fed by a
queue (reference: horovod/common/timeline.{h,cc}; tensors are modeled as
chrome "pids", timeline.cc:244-254; activated by HOROVOD_TIMELINE, runtime
start/stop operations.cc:740-769).  As in the JAX package, the per-rank
view extends into a distributed tracing plane:

  * **aligned clock**: event timestamps are wall-clock us rebased by the
    rank's measured offset against the rendezvous server
    (``utils/clocksync.py``), so every rank stamps events on one epoch;
  * **native spans**: :class:`NativeTraceDrainer` pumps the C++ core's
    span ring (``csrc/core/trace.h``, ``hvd_core_trace``) into the same
    writer thread;
  * **fleet merge**: :class:`TimelinePublisher` PUTs compacted chunks to
    the rendezvous KV scope ``timeline``; :func:`merge_timeline_chunks`
    renders them as one rank-laned Perfetto/Chrome JSON, served at
    ``GET /timeline`` and written by the launcher's ``--timeline-merge``;
  * **crash safety**: the local file is flushed periodically and
    ``close()`` is idempotent, so a killed rank leaves a loadable trace
    (:func:`load_trace_events` repairs the missing closing bracket).

Device spans (:meth:`Timeline.record_op` with ``events``): a collective
that runs asynchronously on a CUDA side stream is traced without a host
synchronization.  The caller records a start event on the stream that
runs the collective and hands over the done event that stream records
after it; the writer thread polls ``done.query()`` and, once it is true,
resolves the span's width as ``start.elapsed_time(done)``.  The span is
anchored at the host time of the enqueue.  Synchronizing for the trace's
sake would serialize the side stream and change the step the trace is
meant to show.  On the CPU (gloo) a collective has finished when its call
returns, and the host-measured duration stands, as in the JAX package.

The local per-rank file is a plain JSON event array with timestamps
relative to this rank's start; published chunks carry absolute aligned us,
which is what makes the merged view line up.
"""

from __future__ import annotations

import json
import queue
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

TIMELINE_KV_SCOPE = "timeline"

# Publisher-side cap on buffered-but-unpublished events: a dead publisher
# must cost trace completeness, never memory.
MAX_PENDING_CHUNK_EVENTS = 50000

_NATIVE_LANES = {"c": "controller", "t": "transport", "x": "chaos"}


def collapse_name(name: str) -> str:
    """Collapse auto-generated per-call names to their prefix: each unique
    name allocates a chrome pid + metadata entry forever, so per-call
    unique names would leak memory and bloat the trace."""
    for marker in (".noname.", ".tfneg."):
        if marker in name:
            return name.split(marker)[0]
    return name


class Timeline:
    def __init__(self, path: str, mark_cycles: bool = False,
                 clock: Optional[Any] = None, rank: Optional[int] = None,
                 flush_interval: float = 1.0):
        self.path = path
        self.mark_cycles = mark_cycles
        self.clock = clock  # ClockSync (or anything with .offset/.meta())
        self.rank = rank
        self.flush_interval = max(0.05, float(flush_interval))
        self._q: "queue.Queue[Optional[dict]]" = queue.Queue()
        self._pids: Dict[str, int] = {}
        self._next_pid = 1
        # Monotonic wall anchor: wall time sampled once, advanced by the
        # perf counter — immune to wall-clock steps mid-run; the clock
        # offset (re-measured by the publisher) is applied per event.
        self._wall0 = time.time()
        self._perf0 = time.perf_counter_ns()
        self._lock = threading.Lock()
        self._chunk: Optional[List[dict]] = None  # enable_publish() arms
        self._chunk_dropped = 0
        # device spans whose done event has not completed yet, resolved in
        # order by the writer thread: (lane, event, start, done)
        self._device: List[Tuple[str, dict, Any, Any]] = []
        self._file = open(path, "w")
        self._file.write("[\n")
        self._first = True
        self._closed = False
        self._epoch_us = self.now_us()  # this rank's local-file zero
        self._writer = threading.Thread(target=self._write_loop, daemon=True)
        self._writer.start()

    # ------------------------------------------------------------- internals
    def now_us(self) -> float:
        """Absolute aligned µs: wall clock + measured server offset."""
        wall = self._wall0 + (time.perf_counter_ns() - self._perf0) / 1e9
        offset = getattr(self.clock, "offset", 0.0) if self.clock else 0.0
        return (wall + offset) * 1e6

    def _pid(self, lane: str) -> int:
        with self._lock:
            pid = self._pids.get(lane)
            if pid is None:
                pid = self._next_pid
                self._next_pid += 1
                self._pids[lane] = pid
                self._q.put({"name": "process_name", "ph": "M", "pid": pid,
                             "args": {"name": lane}})
            return pid

    def _emit(self, lane: str, ev: dict) -> None:
        """Route one event to the local writer (pid-mapped, epoch-relative)
        and, when publishing is armed, to the pending chunk (lane-tagged,
        absolute aligned ts: the mergeable form)."""
        local = dict(ev)
        local["pid"] = self._pid(lane)
        local.setdefault("tid", 0)
        self._q.put(local)
        self._to_chunk(lane, ev)

    def _to_chunk(self, lane: str, ev: dict) -> None:
        if self._chunk is not None:
            with self._lock:
                if self._chunk is not None:
                    self._chunk.append(dict(ev, lane=lane))
                    if len(self._chunk) > MAX_PENDING_CHUNK_EVENTS:
                        self._chunk.pop(0)
                        self._chunk_dropped += 1

    def _resolve_device(self, wait: bool = False) -> List[dict]:
        """The device spans whose done event has completed (all of them,
        waiting, when ``wait``), in record order, with their measured
        widths; each also goes to the pending chunk."""
        out = []
        while self._device:
            lane, ev, start, done = self._device[0]
            if not wait and not done.query():
                break
            if wait:
                done.synchronize()
            self._device.pop(0)
            ev["dur"] = float(start.elapsed_time(done)) * 1e3
            self._to_chunk(lane, ev)
            local = dict(ev)
            local["pid"] = self._pid(lane)
            local["tid"] = 0
            out.append(local)
        return out

    def _write_loop(self) -> None:
        last_flush = time.monotonic()
        dirty = False
        while True:
            # pending device spans are polled every 5 ms
            timeout = 0.005 if self._device else self.flush_interval
            try:
                ev = self._q.get(timeout=timeout)
            except queue.Empty:
                ev = False  # idle tick: resolve and flush only
            try:
                if ev is None:
                    break
                if isinstance(ev, tuple):  # a device span, in record order
                    self._device.append(ev)
                    ev = False
                out_events = self._resolve_device()
                if ev is not False:
                    out_events.append(ev)
                for out in out_events:
                    self._write_event(out)
                    dirty = True
                now = time.monotonic()
                if dirty and now - last_flush >= self.flush_interval:
                    # Crash safety: a killed rank keeps everything up to
                    # the last flush; Perfetto/Chrome tolerate the
                    # missing "]" (load_trace_events repairs it).
                    self._file.flush()
                    last_flush = now
                    dirty = False
            except (ValueError, OSError):
                break  # file closed under us (atexit ordering); stop
        try:
            for out in self._resolve_device(wait=True):
                self._write_event(out)
            self._file.write("\n]\n")
            self._file.close()
        except (ValueError, OSError, RuntimeError):
            pass

    def _write_event(self, ev: dict) -> None:
        out = dict(ev)
        if "ts" in out:
            # local file is relative to this rank's start
            out["ts"] = out["ts"] - self._epoch_us
        if not self._first:
            self._file.write(",\n")
        self._first = False
        self._file.write(json.dumps(out))

    # ------------------------------------------------------------ public API
    def begin(self, tensor_name: str, activity: str,
              ts_us: Optional[float] = None) -> None:
        """Begin an activity phase for a tensor (B event)."""
        self._emit(collapse_name(tensor_name),
                   {"name": activity, "ph": "B",
                    "ts": ts_us if ts_us is not None else self.now_us()})

    def end(self, tensor_name: str, activity: str,
            ts_us: Optional[float] = None) -> None:
        self._emit(collapse_name(tensor_name),
                   {"name": activity, "ph": "E",
                    "ts": ts_us if ts_us is not None else self.now_us()})

    def record_op(self, tensor_name: str, op_type: str, size: int,
                  duration_us: Optional[float] = None,
                  ts_us: Optional[float] = None,
                  events: Optional[Tuple[Any, Any]] = None) -> None:
        """Complete (X) event for one collective execution.

        With ``duration_us`` and no explicit ``ts_us`` the span is
        anchored at its START (now - duration): callers measure latency
        from before dispatch and report at completion, and the span must
        render where the op ran, not after it.

        With ``events`` (a CUDA start event and the done event recorded
        after the collective on the same stream, both with timing on) the
        width is measured on the device: the writer thread resolves it
        once the done event has completed, and the span is anchored at
        ``ts_us`` (the host time of the enqueue; default: now)."""
        if events is not None:
            ev = {"name": op_type, "ph": "X",
                  "ts": ts_us if ts_us is not None else self.now_us(),
                  "dur": 0.0, "args": {"size": int(size)}}
            self._q.put((collapse_name(tensor_name), ev) + tuple(events))
            return
        dur = duration_us if duration_us is not None else 1.0
        if ts_us is None:
            ts_us = self.now_us()
            if duration_us is not None:
                ts_us -= duration_us
        self._emit(collapse_name(tensor_name),
                   {"name": op_type, "ph": "X", "ts": ts_us, "dur": dur,
                    "args": {"size": int(size)}})

    def record_span(self, lane: str, name: str, duration_us: float,
                    args: Optional[dict] = None,
                    ts_us: Optional[float] = None) -> None:
        """Complete (X) event with arbitrary args on a named lane —
        :meth:`record_op` generalized for non-collective planes (the
        serving engine's per-request NEGOTIATE/PREFILL/DECODE phases
        ride this, args carrying the request id; docs/serving.md).
        Without an explicit ``ts_us`` the span is anchored at its START
        (now - duration), matching record_op's measured-at-completion
        convention."""
        if ts_us is None:
            ts_us = self.now_us() - duration_us
        ev = {"name": name, "ph": "X", "ts": ts_us,
              "dur": float(duration_us)}
        if args:
            ev["args"] = dict(args)
        self._emit(collapse_name(lane), ev)

    def instant(self, lane: str, name: str,
                args: Optional[dict] = None,
                ts_us: Optional[float] = None) -> None:
        """Named instant event on a lane (chaos faults, plane markers)."""
        ev = {"name": name, "ph": "i", "s": "p",
              "ts": ts_us if ts_us is not None else self.now_us()}
        if args:
            ev["args"] = dict(args)
        self._emit(lane, ev)

    def native_event(self, ts_us: float, phase: str, cat: str, name: str,
                     arg: int) -> None:
        """One csrc TraceRing event, already rebased to absolute aligned
        µs by the drainer.  Lanes follow the category: controller cycle
        phases, transport frames, chaos faults."""
        lane = _NATIVE_LANES.get(cat, "native")
        if phase == "i":
            self.instant(lane, name, args={"arg": int(arg)}, ts_us=ts_us)
        else:
            ev = {"name": name, "ph": phase, "ts": ts_us}
            if arg:
                ev["args"] = {"arg": int(arg)}
            self._emit(lane, ev)

    def mark_cycle(self) -> None:
        """Negotiation-cycle tick (reference: HOROVOD_TIMELINE_MARK_CYCLES,
        operations.cc:442-445)."""
        if self.mark_cycles:
            self.instant("controller", "CYCLE")

    # ------------------------------------------------------------ publishing
    def enable_publish(self) -> None:
        """Arm the chunk buffer consumed by :class:`TimelinePublisher`."""
        with self._lock:
            if self._chunk is None:
                self._chunk = []

    def drain_chunk(self) -> List[dict]:
        """Consume buffered lane-tagged events (absolute aligned ts)."""
        with self._lock:
            if not self._chunk:
                return []
            out, self._chunk = self._chunk, []
            return out

    def clock_meta(self) -> dict:
        if self.clock is not None and hasattr(self.clock, "meta"):
            return self.clock.meta()
        return {"offset": 0.0, "uncertainty": None, "synced": False}

    def flush(self) -> None:
        """Best-effort synchronous flush of events already queued, device
        spans whose done event completes within the wait included (the
        writer thread also flushes on its own cadence)."""
        deadline = time.monotonic() + 2.0
        while (not self._q.empty() or self._device) and \
                time.monotonic() < deadline:
            time.sleep(0.01)
        try:
            self._file.flush()
        except (ValueError, OSError):
            pass

    def close(self) -> None:
        """Idempotent; safe under any atexit ordering (a second close, a
        close after the writer died, a close racing interpreter teardown
        all no-op rather than raise)."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        try:
            self._q.put(None)
            self._writer.join(timeout=5)
        except (RuntimeError, ValueError, OSError):
            pass


# ------------------------------------------------------------ module helpers
def trace_instant(lane: str, name: str, args: Optional[dict] = None) -> None:
    """Emit an instant on the active runtime's timeline; no-op without an
    initialized runtime or an active timeline: the one-line hook a plane
    module calls without owning timeline plumbing."""
    try:
        from .. import runtime as _rt
        if not _rt.is_initialized():
            return
        tl = _rt.get().timeline
        if tl is not None:
            tl.instant(lane, name, args=args)
    except Exception:
        pass  # tracing must never take the job down


def load_trace_events(path: str) -> List[dict]:
    """Load a timeline file, tolerating the truncation a killed rank
    leaves (no closing bracket, possibly a torn last line) — the repair
    Chrome/Perfetto apply implicitly, made explicit for tools/tests."""
    with open(path) as f:
        text = f.read().strip()
    try:
        return json.loads(text)
    except ValueError:
        pass
    body = text[1:] if text.startswith("[") else text
    events: List[dict] = []
    for line in body.splitlines():
        line = line.strip().rstrip(",")
        if not line or line in ("]",):
            continue
        try:
            events.append(json.loads(line))
        except ValueError:
            continue  # torn tail line from the kill
    return events


# pid namespacing for replica fleets: replica 0 keeps pid == rank (the
# single-fleet byte-compat contract), replica K's rank N renders at
# K * _REPLICA_PID_STRIDE + N — disjoint for any realistic fleet size.
_REPLICA_PID_STRIDE = 10000


def merge_timeline_chunks(items: Dict[str, bytes]) -> dict:
    """Render KV scope ``timeline`` chunks as one Chrome/Perfetto JSON
    object: each (replica, rank) becomes a pid process lane — bare
    ``rank N`` for replica 0 (single-fleet byte-compat),
    ``replica{K}.rank{N}`` for replica K's chunks (docs/timeline.md) —
    each event lane a tid within it, all timestamps on the shared
    aligned epoch normalized to the earliest event.  Per-rank clock
    offset/uncertainty ride the metadata so readers know how much
    cross-rank skew to trust."""
    per_rank: Dict[Tuple[int, int], List[dict]] = {}
    clocks: Dict[Tuple[int, int], dict] = {}
    for key in sorted(items):
        try:
            chunk = json.loads(items[key])
        except (ValueError, TypeError):
            continue  # a torn PUT must not break the whole merge
        r = int(chunk.get("rank", -1))
        rep = int(chunk.get("replica", 0) or 0)
        per_rank.setdefault((rep, r), []).extend(chunk.get("events", []))
        if isinstance(chunk.get("clock"), dict):
            clocks[(rep, r)] = chunk["clock"]
    all_ts = [ev["ts"] for evs in per_rank.values() for ev in evs
              if isinstance(ev.get("ts"), (int, float))]
    t0 = min(all_ts) if all_ts else 0.0
    meta_events: List[dict] = []
    events: List[dict] = []
    for rep, r in sorted(per_rank):
        pid = r if rep == 0 else rep * _REPLICA_PID_STRIDE + r
        lane = f"rank {r}" if rep == 0 else f"replica{rep}.rank{r}"
        meta_events.append({"name": "process_name", "ph": "M", "pid": pid,
                            "args": {"name": lane}})
        if (rep, r) in clocks:
            meta_events.append({"name": "clock_sync", "ph": "M",
                                "pid": pid, "args": clocks[(rep, r)]})
        tids: Dict[str, int] = {}
        for ev in per_rank[(rep, r)]:
            ev_lane = str(ev.get("lane", "misc"))
            tid = tids.get(ev_lane)
            if tid is None:
                tid = len(tids)
                tids[ev_lane] = tid
                meta_events.append({"name": "thread_name", "ph": "M",
                                    "pid": pid, "tid": tid,
                                    "args": {"name": ev_lane}})
            out = {k: v for k, v in ev.items() if k != "lane"}
            out["pid"] = pid
            out["tid"] = tid
            if isinstance(out.get("ts"), (int, float)):
                out["ts"] = out["ts"] - t0
            events.append(out)
    events.sort(key=lambda e: e.get("ts", 0.0))
    return {"traceEvents": meta_events + events,
            "metadata": {"epoch_us": t0,
                         "clock_sync": {
                             (str(r) if rep == 0 else f"r{rep}.{r}"): c
                             for (rep, r), c in sorted(clocks.items())}}}


# --------------------------------------------------------------- publishing
class TimelinePublisher:
    """Background thread PUT-ing compacted trace chunks to the rendezvous
    KV (scope ``timeline``, key ``rank.N.SEQ``) so the driver can serve
    ``GET /timeline`` and write ``--timeline-merge``.  Mirrors
    MetricsPublisher (utils/metrics.py); additionally re-measures the
    clock offset each publish so alignment tracks drift.  A final publish
    happens on close() so the merge sees the tail of the run."""

    SCOPE = TIMELINE_KV_SCOPE

    def __init__(self, addr: str, port: int, rank: int, timeline: Timeline,
                 interval: float = 5.0, clock: Optional[Any] = None,
                 replica: int = 0):
        self.addr = addr
        self.port = int(port)
        self.rank = int(rank)
        # Replica-fleet lane namespacing (docs/timeline.md): nonzero
        # replica ids stamp the chunks so merge_timeline_chunks renders
        # replica{K}.rank{N} process lanes instead of colliding pids.
        self.replica = int(replica)
        self.interval = max(0.1, float(interval))
        self.timeline = timeline
        self.clock = clock
        self._seq = 0
        # one publish at a time, each taking its payload inside: two
        # never take one chunk sequence number (the loop's publish beside
        # close)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        timeline.enable_publish()
        if self.addr and self.port:
            self._thread = threading.Thread(target=self._loop, daemon=True)
            self._thread.start()

    def publish_now(self) -> bool:
        with self._lock:
            return self._publish()

    def _publish(self) -> bool:
        if not (self.addr and self.port):
            return False
        try:
            if self.clock is not None:
                self.clock.measure()  # periodic drift re-measurement
            events = self.timeline.drain_chunk()
            if not events:
                return True
            chunk = {"rank": self.rank, "seq": self._seq,
                     "clock": self.timeline.clock_meta(),
                     "events": events}
            key = f"rank.{self.rank}.{self._seq:06d}"
            if self.replica:
                chunk["replica"] = self.replica
                key = f"r{self.replica:02d}.{key}"
            from ..runner.http_client import put_kv
            put_kv(self.addr, self.port, self.SCOPE, key,
                   json.dumps(chunk).encode())
            self._seq += 1
            return True
        except Exception:
            return False  # tracing must never take the job down

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            self.publish_now()

    def close(self) -> None:
        self._stop.set()
        self.publish_now()


class NativeTraceDrainer:
    """Background pump from the C++ core's span ring into the timeline
    writer thread (csrc/trace.h -> hvd_core_trace -> Timeline).

    Ring timestamps are steady-clock µs since ring construction; each
    drain's header carries ``now_us`` in the same clock, so the drainer
    rebases: ring_epoch = aligned_now - now_us, event = ring_epoch + ts.
    """

    def __init__(self, core: Any, timeline: Timeline,
                 interval: float = 0.5):
        self.core = core
        self.timeline = timeline
        self.interval = max(0.05, float(interval))
        self._stop = threading.Event()
        core.trace_enable()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def drain_once(self) -> int:
        try:
            d = self.core.trace_drain()
        except Exception:
            return 0  # core closing; the drainer must not crash teardown
        ring_epoch = self.timeline.now_us() - d["now_us"]
        for ts, phase, cat, name, arg in d["events"]:
            self.timeline.native_event(ring_epoch + ts, phase, cat, name,
                                       arg)
        if d["dropped"]:
            self.timeline.instant("controller", "trace.ring.dropped",
                                  args={"total": d["dropped"]})
        return len(d["events"])

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            self.drain_once()

    def close(self) -> None:
        """Stop the pump after one final drain (call while the native
        core is still alive)."""
        if self._stop.is_set():
            return
        self._stop.set()
        self.drain_once()
