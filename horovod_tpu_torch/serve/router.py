"""Request router: the serving plane's front door on the rendezvous
HTTP server (docs/serving.md), the port of ``horovod_tpu/serve/router.py``
with the same routes, scopes, keys, records, status codes and headers.

As the JAX router does, it counts into the ``hvd_serve_*`` and
``hvd_router_*`` metrics (sheds, journal depth, drains, trace records and
pruning, lifecycle components, routed, affinity hits and misses, replicas
up, re-dispatches) and emits the merged timeline's ROUTE and STREAM spans
(``runner/http_server.trace_span``); telemetry never takes the front door
down.  The JAX view's firing alerts in ``/serve/stats`` wait for the watch
plane (ROADMAP queue 1 item 4.3).

``POST /generate`` accepts ``{"tokens": [...], "max_new_tokens": N}``,
enqueues the request onto the rendezvous KV (scope ``serve_req`` —
the SAME transport every other plane rides), and streams the engine's
tokens back as newline-delimited JSON while rank 0 of the engine fleet
publishes them (scope ``serve_out``).  ``GET /serve/stats`` merges the
router's queue counters with the engine's self-published stats (scope
``serve`` key ``stats``).

Fault tolerance (docs/serving.md#fault-tolerance):

  * every ACCEPTED request is also journaled to scope ``serve_journal``
    (serve/journal.py) so a fleet reset can redrive unfinished work —
    the journal write shares the admission's kv_lock critical section,
    so a journaled request and an enqueued request are the same set;
  * admission is watermark-based with hysteresis: beyond the high
    watermark requests are shed with 429 + a ``Retry-After`` header
    derived from the measured per-request service time (TPOT x tokens,
    EWMA) times the queue depth; admission resumes at the low watermark;
  * ``POST /admin/drain`` stops admission (503), signals the engine
    fleet through the KV (scope ``serve`` key ``drain``), and waits for
    rank 0's ``drained`` ack — the fleet finishes every accepted
    request, checkpoints its final stats, and exits 0 (the
    preemption-safe rolling-restart path).

The handler side runs inside runner/http_server.py's threaded server
(one thread per in-flight stream — the async queue is the KV scope, the
threads are just the drains), so the router needs no process of its
own: ``hvdrun --serve`` gives the fleet a router for free.  Stream
reads and journal writes touch the IN-PROCESS kv dict (the router lives
in the rendezvous server's process — with ``--kv-shards`` the owning
shard's store, still in-process; docs/control-plane.md), so no KV
transport error can kill a stream router-side; the worker-side KV legs
carry the bounded exp-backoff retry (serve/worker.py ``_kv_op``).

Token delivery is event-driven: rank 0's direct stream
(serve/stream.py) and the shard servers' ``serve_out`` PUT path both
notify the server's ``kv_wakeup`` condition, so ``_stream_results``
wakes on arrival instead of busy-polling; the poll interval that
remains (the fallback cadence, HOROVOD_SERVE_POLL_INTERVAL) backs off
under an EWMA-informed cap (:class:`AdaptivePoll`).  Consumed streams
are garbage-collected: once a client has drained ``.done``, the
per-request ``serve_out`` parts are deleted and the done record slims
to a tombstone, so a long-lived fleet's KV stops growing per token
(journal entries are retained — the tombstone is what redrive skips).
"""

from __future__ import annotations

import contextlib
import json
import math
import threading
import time
from typing import Any, Dict, List, Optional

from . import trace as trace_mod
from .journal import JOURNAL_SCOPE
from .replica import REPLICA_SCOPE, ReplicaRouter, scoped

REQ_SCOPE = "serve_req"
OUT_SCOPE = "serve_out"
PLAN_SCOPE = "serve_plan"
STATS_SCOPE = "serve"
STATS_KEY = "stats"
DRAIN_KEY = "drain"
DRAINED_KEY = "drained"

DEFAULT_MAX_PENDING = 64
DEFAULT_STREAM_TIMEOUT_S = 120.0
RETRY_AFTER_CAP_S = 60
_POLL_S = 0.02  # default base cadence; knob HOROVOD_SERVE_POLL_INTERVAL
_DARK_CHECK_S = 0.25  # per-stream dark-replica probe cadence


def req_key(seq: int) -> str:
    return f"req.{seq:06d}"


def _store(server, scope: str):
    """The in-process store owning ``scope``: the shard's httpd under
    --kv-shards, the server itself otherwise (runner/http_server
    store_for; every store lives in the router's process either way)."""
    from ..runner.http_server import store_for
    return store_for(server, scope)


@contextlib.contextmanager
def _locked_stores(server, *scopes):
    """Acquire the owning stores' locks for several scopes at once (in
    shard order, deduplicated — deadlock-free by canonical ordering)
    and yield scope -> store.  The enqueue+journal critical section
    spans two scopes that may live on different shards; the invariant
    'journaled set == promised set' must hold across both."""
    stores = {scope: _store(server, scope) for scope in scopes}
    ordered = sorted({id(s): s for s in stores.values()}.values(),
                     key=lambda s: getattr(s, "shard_index", 0))
    with contextlib.ExitStack() as stack:
        for s in ordered:
            stack.enter_context(s.kv_lock)
        yield stores


class AdaptivePoll:
    """EWMA-informed poll backoff for the stream drain: every empty
    wait grows the next interval 1.5x from the knob base, capped by the
    observed inter-part arrival gap's EWMA (never sleep far past when
    the next token is due) and a hard ceiling; any arrival resets to
    the base.  Pure arithmetic over an injectable clock — unit-tested
    without sleeping (tests/test_kv_shard.py)."""

    HARD_CAP_S = 0.25
    GROWTH = 1.5
    ALPHA = 0.3  # EWMA weight of the newest observed gap

    def __init__(self, base_s: float):
        self.base = max(1e-4, float(base_s))
        self._cur = self.base
        self._ewma_gap: Optional[float] = None
        self._last_data: Optional[float] = None

    def observe_data(self, now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else now
        if self._last_data is not None:
            gap = max(0.0, now - self._last_data)
            self._ewma_gap = gap if self._ewma_gap is None else (
                (1 - self.ALPHA) * self._ewma_gap + self.ALPHA * gap)
        self._last_data = now
        self._cur = self.base

    def cap(self) -> float:
        if self._ewma_gap is None:
            return self.HARD_CAP_S
        return min(self.HARD_CAP_S, max(self.base, self._ewma_gap))

    def idle(self) -> float:
        """Interval to wait now; grows the next one."""
        wait = min(self._cur, self.cap())
        self._cur = min(self.cap(), self._cur * self.GROWTH)
        return wait


class RouterState:
    """Router-side admission state: submitted/completed/rejected
    counters, the dense sequence numbering the engine fleet consumes in
    order, watermark shedding with hysteresis, the drain latch, and the
    service-time EWMA behind ``Retry-After``."""

    def __init__(self, max_pending: int = DEFAULT_MAX_PENDING,
                 stream_timeout_s: float = DEFAULT_STREAM_TIMEOUT_S,
                 shed_high: Optional[int] = None,
                 shed_low: Optional[int] = None,
                 journal: bool = True,
                 poll_interval: float = _POLL_S):
        self.max_pending = int(max_pending)
        self.stream_timeout_s = float(stream_timeout_s)
        self.poll_interval = float(poll_interval)
        self.shed_high = int(shed_high) if shed_high else self.max_pending
        if shed_low:
            self.shed_low = int(shed_low)
        else:
            self.shed_low = max(
                0, self.shed_high - max(1, self.shed_high // 4))
        self.journal = bool(journal)
        self._lock = threading.Lock()
        self.next_seq = 0
        self.completed = 0
        self.rejected = 0
        self.shed = 0
        self.draining = False
        self.reject_reason: Optional[str] = None  # set by a None claim
        self._shedding = False
        self._service_ewma: Optional[float] = None  # s of decode/request

    def try_claim(self) -> Optional[int]:
        """Next sequence number, or None under shedding/drain (the
        reason lands in ``reject_reason`` for the status code)."""
        from ..utils import metrics as M
        with self._lock:
            if self.draining:
                self.rejected += 1
                self.reject_reason = "draining"
                return None
            pending = self.next_seq - self.completed
            if self._shedding and pending <= self.shed_low:
                self._shedding = False  # hysteresis: resume admission
            if self._shedding or pending >= self.shed_high:
                self._shedding = True
                self.rejected += 1
                self.shed += 1
                self.reject_reason = "shed"
                M.SERVE_SHEDS.inc()
                return None
            seq = self.next_seq
            self.next_seq += 1
            self.reject_reason = None
            if self.journal:
                M.SERVE_JOURNAL_DEPTH.set(self.next_seq - self.completed)
            return seq

    def finish_stream(self) -> None:
        from ..utils import metrics as M
        with self._lock:
            self.completed += 1
            if self.journal:
                M.SERVE_JOURNAL_DEPTH.set(
                    max(0, self.next_seq - self.completed))

    def observe_done(self, tpot_s: Any, n_tokens: int) -> None:
        """Feed one finished request's measured decode time into the
        service-time EWMA (tpot x generated tokens) — the Retry-After
        basis.  Bad/missing measurements are ignored."""
        try:
            svc = float(tpot_s) * max(1, int(n_tokens))
        except (TypeError, ValueError):
            return
        if svc <= 0:
            return
        with self._lock:
            if self._service_ewma is None:
                self._service_ewma = svc
            else:
                self._service_ewma = 0.7 * self._service_ewma + 0.3 * svc

    def retry_after_s(self) -> int:
        """Client back-off hint for a shed: measured per-request service
        time x queue depth, in whole seconds clamped to [1, 60].  With
        no measurement yet, 1 — the cheapest honest answer."""
        with self._lock:
            pending = self.next_seq - self.completed
            svc = self._service_ewma
        if svc is None:
            return 1
        return int(min(RETRY_AFTER_CAP_S, max(1, math.ceil(pending * svc))))

    def counters(self) -> Dict[str, Any]:
        with self._lock:
            return {"submitted": self.next_seq,
                    "completed": self.completed,
                    "rejected": self.rejected,
                    "shed": self.shed,
                    "pending": self.next_seq - self.completed,
                    "max_pending": self.max_pending,
                    "shed_high": self.shed_high,
                    "shed_low": self.shed_low,
                    "draining": self.draining,
                    "journal": self.journal}


def get_router_state(server, replica_id: int = 0) -> RouterState:
    """Lazily attach one RouterState per replica fleet to the
    rendezvous HTTP server, configured from the knob registry
    (watermarks, journal switch).  Replica 0's state is also aliased at
    ``server.serve_router`` — the pre-replica attachment point every
    existing test/tool reads (docs/serving.md#replicated-tier)."""
    rid = int(replica_id)
    states = getattr(server, "serve_routers", None)
    if states is None:
        states = server.serve_routers = {}
    if rid == 0 and getattr(server, "serve_router", None) is not None:
        states.setdefault(0, server.serve_router)
    state = states.get(rid)
    if state is None:
        from ..common.knobs import Knobs
        knobs = Knobs()
        state = states[rid] = RouterState(
            shed_high=int(knobs["HOROVOD_SERVE_SHED_HIGH"]) or None,
            shed_low=int(knobs["HOROVOD_SERVE_SHED_LOW"]) or None,
            journal=bool(knobs["HOROVOD_SERVE_JOURNAL"]),
            poll_interval=float(knobs["HOROVOD_SERVE_POLL_INTERVAL"]))
        if rid == 0:
            server.serve_router = state
    return state


def get_replica_router(server) -> ReplicaRouter:
    """Lazily attach the replica registry/affinity router
    (serve/replica.py) to the rendezvous HTTP server.  Empty until a
    replica fleet registers — a single unregistered fleet keeps the
    pre-replica fast path byte-for-byte."""
    rr = getattr(server, "serve_replicas", None)
    if rr is None:
        from ..common.knobs import Knobs
        knobs = Knobs()
        rr = server.serve_replicas = ReplicaRouter(
            affinity=bool(knobs["HOROVOD_SERVE_AFFINITY"]),
            dead_after_s=float(knobs["HOROVOD_SERVE_REPLICA_DEAD_S"]))
    return rr


def refresh_replicas(server, rr: ReplicaRouter) -> int:
    """Fold the replica registry scope and every registered replica's
    latest stats publish (fingerprints, queue depth, shed) into the
    ReplicaRouter; returns how many replicas are registered.  All reads
    are in-process store lookups; heartbeat freshness is judged from
    the server's own KV receipt stamps — a replica with a broken clock
    still ages honestly."""
    store = _store(server, REPLICA_SCOPE)
    with store.kv_lock:
        regs = dict(store.kv.get(REPLICA_SCOPE, {}))
    for key in sorted(regs):
        try:
            info = json.loads(regs[key])
            rid = int(info["replica_id"])
        except (ValueError, TypeError, KeyError):
            continue  # a torn registration must not 500 the front door
        st_scope = scoped(STATS_SCOPE, rid)
        st = _store(server, st_scope)
        with st.kv_lock:
            sraw = st.kv.get(st_scope, {}).get(STATS_KEY)
            stamp = st.kv_times.get(st_scope, {}).get(STATS_KEY)
        rr.register(rid, info, now=float(stamp or 0.0))
        if sraw is not None and stamp is not None:
            try:
                rr.update(rid, json.loads(sraw), now=float(stamp))
            except (ValueError, TypeError):
                pass  # a torn stats PUT keeps the previous advertisement
        # Least-loaded needs a signal fresher than the <= 1 Hz stats
        # heartbeat: overlay this process's OWN in-flight count for the
        # replica (requests routed here and not yet completed), so a
        # burst arriving between two heartbeats spreads instead of
        # piling onto the lowest replica id.
        state = (getattr(server, "serve_routers", None) or {}).get(rid)
        if state is not None:
            rr.note_load(rid, state.next_seq - state.completed)
    return len(rr.replicas)


def parse_generate_body(raw: bytes) -> Dict[str, Any]:
    """Validate one /generate body; raises ValueError with a
    client-renderable message."""
    try:
        body = json.loads(raw or b"{}")
    except ValueError:
        raise ValueError("body is not valid JSON")
    tokens = body.get("tokens")
    if not isinstance(tokens, list) or not tokens or \
            not all(isinstance(t, int) and t >= 0 for t in tokens):
        raise ValueError("'tokens' must be a non-empty list of token ids "
                         "(no server-side tokenizer; docs/serving.md)")
    max_new = body.get("max_new_tokens", 16)
    if not isinstance(max_new, int) or max_new < 1:
        raise ValueError("'max_new_tokens' must be a positive int")
    out = {"tokens": tokens, "max_new_tokens": max_new}
    if body.get("eos_id") is not None:
        if not isinstance(body["eos_id"], int):
            raise ValueError("'eos_id' must be an int")
        out["eos_id"] = body["eos_id"]
    return out


def _enqueue_request(server, state: RouterState, rid: int,
                     req: Dict[str, Any], key: str) -> None:
    """Journal + enqueue one request under replica ``rid``'s scopes in
    ONE critical section (both owning stores' locks held): the
    journaled set and the promised set cannot diverge."""
    rq_scope = scoped(REQ_SCOPE, rid)
    jn_scope = scoped(JOURNAL_SCOPE, rid)
    encoded = json.dumps(req).encode()
    with _locked_stores(server, rq_scope, jn_scope) as stores:
        now = time.time()
        rq = stores[rq_scope]
        rq.kv.setdefault(rq_scope, {})[key] = encoded
        rq.kv_times.setdefault(rq_scope, {})[key] = now
        if state.journal:
            jn = stores[jn_scope]
            jn.kv.setdefault(jn_scope, {})[key] = encoded
            jn.kv_times.setdefault(jn_scope, {})[key] = now


# -------------------------------------------------------- trace records
def _trace_key(replica_id: int, rid: str) -> str:
    """serve_trace store key: replica-prefixed so two replicas' dense
    rid spaces (both mint req.000000) cannot collide; within a replica
    sorted order stays admission order (trace.prune_keys)."""
    return f"r{int(replica_id):02d}.{rid}"


def _trace_put(server, tkey: str, rec: Dict[str, Any]) -> None:
    """Write one request's serve_trace record (in-process store) and
    enforce the bounded retention (serve/trace.py TRACE_RETAIN)."""
    from ..utils import metrics as M
    store = _store(server, trace_mod.TRACE_SCOPE)
    with store.kv_lock:
        scope = store.kv.setdefault(trace_mod.TRACE_SCOPE, {})
        times = store.kv_times.setdefault(trace_mod.TRACE_SCOPE, {})
        fresh = tkey not in scope
        scope[tkey] = json.dumps(rec).encode()
        times[tkey] = time.time()
        pruned = trace_mod.prune_keys(list(scope))
        for k in pruned:
            scope.pop(k, None)
            times.pop(k, None)
    try:
        if fresh:
            M.SERVE_TRACE_RECORDS.inc()
        if pruned:
            M.SERVE_TRACE_PRUNED.inc(len(pruned))
    except Exception:
        pass  # telemetry must never take the front door down


def _finalize_trace(server, trace_rec: Dict[str, Any], tkey: str,
                    done_rec: Optional[Dict[str, Any]],
                    status: str) -> None:
    """Close one request's trace record at stream end: decompose the
    measured wall time into lifecycle components that sum EXACTLY to it
    (serve/trace.py ``attribute`` — over-attribution rescaled with the
    ratio kept observable), persist, export the component histograms,
    and emit the router-side STREAM span.  A timed-out request keeps
    its record (status ``timeout``, no components) — forensics must
    cover requests that died mid-flight."""
    from ..utils import metrics as M
    now = time.time()
    wall = max(0.0, now - float(trace_rec.get("submitted_t") or now))
    trace_rec["status"] = status
    trace_rec["wall_s"] = wall
    if done_rec is not None:
        measured = dict(done_rec.get("timing") or {})
        measured["placement"] = trace_rec.get("placement_s")
        comps, ratio = trace_mod.attribute(wall, measured)
        trace_rec["components"] = comps
        trace_rec["overattribution"] = ratio
        trace_rec["finish_reason"] = done_rec.get("finish_reason")
        trace_rec["n_tokens"] = len(done_rec.get("tokens") or ())
        trace_rec["ttft_s"] = done_rec.get("ttft_s")
        trace_rec["tpot_s"] = done_rec.get("tpot_s")
        try:
            for c, v in comps.items():
                M.SERVE_COMPONENT_SECONDS.observe(v, component=c)
            M.SERVE_TRACE_OVERATTRIBUTION.set(ratio)
        except Exception:
            pass  # telemetry must never take the front door down
        from ..runner.http_server import trace_span
        ctx = trace_rec.get("trace") or {}
        trace_span(server, "stream", "STREAM",
                   start_t=now - comps["stream"], dur_s=comps["stream"],
                   args=trace_mod.span_args(ctx, "STREAM"))
    _trace_put(server, tkey, trace_rec)


def render_trace(server) -> Dict[str, Any]:
    """GET /serve/trace (docs/serving.md#request-lifecycle): tail
    analytics over the bounded per-request trace records — per-component
    p50/p99 fleet rollup plus the slowest-requests table."""
    store = _store(server, trace_mod.TRACE_SCOPE)
    with store.kv_lock:
        raw = dict(store.kv.get(trace_mod.TRACE_SCOPE, {}))
    records = []
    for k in sorted(raw):
        try:
            records.append(json.loads(raw[k]))
        except (ValueError, TypeError):
            continue  # a torn record must not 500 the analytics view
    out = trace_mod.rollup(records)
    # The raw records ride the payload (bounded by TRACE_RETAIN) so
    # `hvdrun doctor --request RID` reconstructs a lifecycle from the
    # same fetch the rollup came from.
    out["records"] = records
    return out


def handle_generate(handler) -> None:
    """POST /generate on the rendezvous server: place the request on a
    replica fleet (prefix affinity when replicas are registered —
    serve/replica.py; the single unregistered fleet otherwise), journal
    + enqueue to that replica's KV scopes, then stream ndjson lines
    ({"tokens": [...]} parts, then {"done": ...}) as the engine
    publishes them.  Connection close delimits the body (HTTP/1.0
    semantics of the rendezvous server)."""
    from ..utils import metrics as M
    server = handler.server
    length = int(handler.headers.get("Content-Length", 0))
    raw = handler.rfile.read(length)
    try:
        req = parse_generate_body(raw)
    except ValueError as e:
        _json_response(handler, 400, {"error": str(e)})
        return
    rr = get_replica_router(server)
    place_t0 = time.perf_counter()
    replicated = refresh_replicas(server, rr) > 0
    rid_replica, hit_blocks = 0, 0
    verdict = None
    if replicated:
        placed = rr.route(req["tokens"], time.time())
        verdict = rr.last_verdict
        if placed is None:
            _json_response(handler, 503, {
                "error": "no live serving replica (all heartbeats "
                         "stale); retry",
                "replicas": rr.counters(time.time())})
            return
        rid_replica, hit_blocks = placed
        try:
            M.ROUTER_ROUTED.inc(replica=str(rid_replica))
            (M.ROUTER_AFFINITY_HITS if hit_blocks
             else M.ROUTER_AFFINITY_MISSES).inc()
            M.ROUTER_REPLICAS_UP.set(len(rr.live(time.time())))
        except Exception:
            pass  # telemetry must never take the front door down
    placement_s = time.perf_counter() - place_t0
    state = get_router_state(server, rid_replica)
    seq = state.try_claim()
    if seq is None:
        if state.reject_reason == "draining":
            _json_response(handler, 503, {
                "error": "serving fleet is draining; retry against the "
                         "next fleet",
                **state.counters()})
        else:
            # Shed forensics: no sequence number is claimed, so mint a
            # shed-marker rid — the 429 response and its trace record
            # name the request they acted on.
            shed_rid = f"shed.{rid_replica}.{state.shed}"
            _json_response(handler, 429, {
                "error": "serving queue full (load shed)",
                "rid": shed_rid,
                **state.counters()},
                extra_headers={
                    "Retry-After": str(state.retry_after_s()),
                    "X-Serve-Request-Id": shed_rid})
            _trace_put(server, _trace_key(rid_replica, shed_rid), {
                "rid": shed_rid, "status": "shed",
                "submitted_t": time.time(),
                "placement_s": placement_s,
                "attempts": [{"replica": rid_replica,
                              "verdict": verdict}]})
        return
    key = req_key(seq)
    req["id"] = key
    req["submitted_t"] = time.time()
    # Causal trace context (serve/trace.py): minted ONCE here, then
    # propagated through the journal entry, the plan stream, the engine,
    # the prefill->decode handoff, and back on the done record.
    ctx = trace_mod.mint(key)
    req["trace"] = ctx
    tkey = _trace_key(rid_replica, key)
    trec: Dict[str, Any] = {
        "rid": key, "status": "running",
        "submitted_t": req["submitted_t"],
        "trace": ctx,
        "prompt_tokens": len(req["tokens"]),
        "max_new_tokens": req["max_new_tokens"],
        "placement_s": placement_s,
        "attempts": [{"replica": rid_replica, "rid": key,
                      "affinity_blocks": hit_blocks,
                      "verdict": verdict}],
    }
    try:
        _enqueue_request(server, state, rid_replica, req, key)
        _trace_put(server, tkey, trec)
        from ..runner.http_server import trace_span
        trace_span(server, "router", "ROUTE",
                   start_t=req["submitted_t"] - placement_s,
                   dur_s=placement_s,
                   args=trace_mod.span_args(ctx, "ROUTE",
                                            replica=rid_replica))
        handler.send_response(200)
        handler.send_header("Content-Type", "application/x-ndjson")
        handler.send_header("X-Serve-Request-Id", key)
        if replicated:
            handler.send_header("X-Serve-Replica", str(rid_replica))
            handler.send_header("X-Serve-Affinity-Blocks",
                                str(hit_blocks))
        handler.end_headers()
        _stream_results(handler, server, key, state,
                        replica_id=rid_replica,
                        rr=rr if replicated else None, req=req,
                        trace_rec=trec, trace_key=tkey)
    finally:
        state.finish_stream()


def _redispatch(server, rr: ReplicaRouter, req: Dict[str, Any],
                dead_rid: int, streamed: List[int], part: int):
    """Move one accepted stream off a dark replica: re-journal +
    re-enqueue the request on the best surviving replica with
    ``resume_emitted``/``resume_part`` set to what the client already
    received — the survivor's rank 0 applies the standard redrive
    suppression (serve/worker.py ``_apply_resume``), so the client's
    ndjson stream resumes byte-identically from the last token it saw.
    Returns ``(new_rid, new_key, new_state)`` or None (no survivor, or
    the survivor is shedding — the caller keeps waiting until the
    original replica returns or the stream times out)."""
    from ..utils import metrics as M
    now = time.time()
    placed = rr.route(req["tokens"], now, exclude=[dead_rid])
    if placed is None:
        return None
    new_rid, _ = placed
    new_state = get_router_state(server, new_rid)
    seq = new_state.try_claim()
    if seq is None:
        return None
    new_key = req_key(seq)
    rec = dict(req)
    rec["id"] = new_key
    rec["submitted_t"] = now
    rec["resume_emitted"] = [int(t) for t in streamed]
    rec["resume_part"] = int(part)
    rec["redispatched_from"] = dead_rid
    _enqueue_request(server, new_state, new_rid, rec, new_key)
    rr.note_redispatch()
    try:
        M.ROUTER_REDISPATCHES.inc()
        M.ROUTER_ROUTED.inc(replica=str(new_rid))
    except Exception:
        pass  # telemetry must never take the front door down
    return new_rid, new_key, new_state


def _stream_results(handler, server, key: str, state: RouterState,
                    replica_id: int = 0,
                    rr: Optional[ReplicaRouter] = None,
                    req: Optional[Dict[str, Any]] = None,
                    trace_rec: Optional[Dict[str, Any]] = None,
                    trace_key: Optional[str] = None) -> None:
    """Drain ``serve_out`` parts for one request to the client as they
    arrive; ends with the ``.done`` record (or a timeout record).  Reads
    are in-process dict lookups — a fleet reset stalls the stream (no
    new parts) without breaking it, and the redriven fleet's resumed
    parts continue it seamlessly.  Arrival is event-driven: the direct
    stream's ingest and the shard PUT path both notify ``kv_wakeup``;
    the timed wait is only the fallback cadence, backed off by
    :class:`AdaptivePoll`.  After the client consumes ``.done`` the
    request's parts are deleted and the done record slims to a
    tombstone (the marker redrive skips) so serve_out stays bounded.

    With a replica tier (``rr`` set), a stream whose replica goes DARK
    mid-request is re-dispatched to a surviving replica
    (:func:`_redispatch`): the wait loop switches to the survivor's
    ``serve_out`` scope at the same part index and the client never
    sees the failover."""
    from ..runner.http_server import add_stream_waiter, drop_stream_waiter
    out_scope = scoped(OUT_SCOPE, replica_id)
    store = _store(server, out_scope)
    # Keyed waiter (docs/serving.md#replicated-tier): this stream wakes
    # only on ITS records, not on every record any stream ingests — the
    # broadcast condition is the fallback for bare test servers.  The
    # lost-wakeup window (record lands between the registry probe and
    # the wait) is bounded by AdaptivePoll's hard cap, same as before.
    keyed = add_stream_waiter(server, out_scope, key)
    wakeup = keyed if keyed is not None \
        else getattr(server, "kv_wakeup", None)
    poll = AdaptivePoll(state.poll_interval)
    deadline = time.time() + state.stream_timeout_s
    next_dark_check = 0.0
    part = 0
    streamed: List[int] = []  # tokens on the client's wire (redispatch)
    extra_states: List[RouterState] = []
    try:
        while True:
            with store.kv_lock:
                scope = store.kv.get(out_scope, {})
                chunk = scope.get(f"{key}.part.{part:06d}")
                done = scope.get(f"{key}.done")
            if chunk is not None:
                handler.wfile.write(chunk + b"\n")
                handler.wfile.flush()
                part += 1
                poll.observe_data()
                if rr is not None:
                    try:
                        streamed.extend(
                            int(t) for t in
                            json.loads(chunk).get("tokens", []))
                    except (ValueError, TypeError):
                        pass  # a torn part still reached the client
                continue
            if done is not None:
                handler.wfile.write(done + b"\n")
                handler.wfile.flush()
                rec: Optional[Dict[str, Any]] = None
                try:
                    rec = json.loads(done)
                    state.observe_done(rec.get("tpot_s"),
                                       len(rec.get("tokens") or ()))
                except (ValueError, TypeError):
                    rec = None  # a torn done record still ends the stream
                if trace_rec is not None and trace_key is not None:
                    _finalize_trace(server, trace_rec, trace_key,
                                    rec if isinstance(rec, dict) else None,
                                    status="done")
                _collect_consumed(store, key, part, out_scope)
                return
            if time.time() >= deadline:
                handler.wfile.write(json.dumps(
                    {"error": "timed out after "
                              f"{state.stream_timeout_s:.0f}s "
                              f"waiting for {key}"}).encode() + b"\n")
                if trace_rec is not None and trace_key is not None:
                    # Died mid-flight: the record survives for doctor
                    # --request, status says where the lifecycle ended.
                    _finalize_trace(server, trace_rec, trace_key, None,
                                    status="timeout")
                return
            if rr is not None and req is not None and \
                    time.time() >= next_dark_check:
                # Bound the dark-replica probe's cadence per stream:
                # kv_wakeup is a per-record broadcast, so checking on
                # every idle wake would fold the whole registry
                # O(streams x tokens/s) times — the heartbeat the probe
                # reads only moves at ~1 Hz anyway, and dead_after_s
                # dwarfs a quarter-second detection lag.
                next_dark_check = time.time() + _DARK_CHECK_S
                refresh_replicas(server, rr)
                if rr.is_dark(replica_id, time.time()):
                    moved = _redispatch(server, rr, req, replica_id,
                                        streamed, part)
                    if moved is not None:
                        if keyed is not None:
                            drop_stream_waiter(server, out_scope, key)
                        prev_replica = replica_id
                        replica_id, key, new_state = moved
                        if trace_rec is not None and trace_key is not None:
                            # Forensics: both replica attempts, with the
                            # delivered-prefix suppression boundary.
                            trace_rec["attempts"].append({
                                "replica": replica_id, "rid": key,
                                "redispatched_from": prev_replica,
                                "resume_part": part,
                                "suppressed_tokens": len(streamed),
                                "verdict": rr.last_verdict})
                            _trace_put(server, trace_key, trace_rec)
                        extra_states.append(new_state)
                        out_scope = scoped(OUT_SCOPE, replica_id)
                        store = _store(server, out_scope)
                        keyed = add_stream_waiter(server, out_scope, key)
                        wakeup = keyed if keyed is not None \
                            else getattr(server, "kv_wakeup", None)
                        poll.observe_data()  # survivor restarts cadence
                        continue
            wait = poll.idle()
            if wakeup is not None:
                with wakeup:
                    wakeup.wait(wait)
            else:
                time.sleep(wait)
    finally:
        if keyed is not None:
            drop_stream_waiter(server, out_scope, key)
        for st in extra_states:
            st.finish_stream()


def _collect_consumed(store, key: str, nparts: int,
                      out_scope: str = OUT_SCOPE) -> None:
    """Garbage-collect one fully-consumed stream: delete its serve_out
    parts and slim ``.done`` to a token-free tombstone.  The tombstone
    must survive — it is what redrive_plan (serve/journal.py) skips; a
    deleted done with a retained journal entry would re-admit a request
    whose client is gone."""
    done_key = f"{key}.done"
    with store.kv_lock:
        scope = store.kv.get(out_scope, {})
        times = store.kv_times.get(out_scope, {})
        for p in range(nparts):
            pk = f"{key}.part.{p:06d}"
            scope.pop(pk, None)
            times.pop(pk, None)
        done = scope.get(done_key)
        if done is None:
            return
        try:
            rec = json.loads(done)
        except (ValueError, TypeError):
            rec = {}
        scope[done_key] = json.dumps({
            "done": True, "consumed": True,
            "finish_reason": rec.get("finish_reason"),
            "n_tokens": len(rec.get("tokens") or ()),
        }).encode()


def handle_drain(handler) -> None:
    """POST /admin/drain (docs/serving.md#fault-tolerance): stop
    admission, signal the engine fleet (KV scope ``serve`` key
    ``drain``), wait up to HOROVOD_SERVE_DRAIN_TIMEOUT for rank 0's
    ``drained`` ack — the fleet finishes every accepted request first —
    and report the outcome.  200 = drained clean (the workers exit 0);
    504 = the fleet did not acknowledge within the budget."""
    from ..common.knobs import Knobs
    from ..utils import metrics as M
    server = handler.server
    rr = get_replica_router(server)
    rids = (sorted(rr.replicas)
            if refresh_replicas(server, rr) else [0])
    first = False
    for rid in rids:
        state = get_router_state(server, rid)
        first = first or not state.draining
        state.draining = True
    if first:
        M.SERVE_DRAINS.inc()
    stores = {}
    for rid in rids:
        st_scope = scoped(STATS_SCOPE, rid)
        store = stores[rid] = (st_scope, _store(server, st_scope))
        with store[1].kv_lock:
            now = time.time()
            store[1].kv.setdefault(st_scope, {})[DRAIN_KEY] = \
                json.dumps({"t": now}).encode()
            store[1].kv_times.setdefault(st_scope, {})[DRAIN_KEY] = now
    deadline = time.time() + float(Knobs()["HOROVOD_SERVE_DRAIN_TIMEOUT"])
    acks: Dict[int, Any] = {}
    while time.time() < deadline and len(acks) < len(rids):
        for rid in rids:
            if rid in acks:
                continue
            st_scope, store = stores[rid]
            with store.kv_lock:
                ack = store.kv.get(st_scope, {}).get(DRAINED_KEY)
            if ack is not None:
                acks[rid] = ack
        if len(acks) < len(rids):
            time.sleep(_POLL_S)
    drained = len(acks) == len(rids)
    out: Dict[str, Any] = {
        "drained": drained,
        "router": get_router_state(server, rids[0]).counters()}
    if len(rids) > 1:
        out["replicas_drained"] = sorted(acks)
        out["replicas"] = rids
    if acks:
        try:
            out["engine_final"] = json.loads(acks[min(acks)])
        except (ValueError, TypeError):
            pass  # a torn ack still proves the drain completed
    _json_response(handler, 200 if drained else 504, out)


def render_stats(server) -> Dict[str, Any]:
    """GET /serve/stats: router counters + the engine fleet's
    self-published stats (KV scope ``serve`` key ``stats``), plus the
    control-plane shard health when the KV is sharded (the operational
    view `hvdrun doctor --serve` renders; docs/control-plane.md).  The
    JAX view's firing alerts wait for the watch plane (item 4.3)."""
    state = get_router_state(server)
    out: Dict[str, Any] = {"router": state.counters()}
    st = _store(server, STATS_SCOPE)
    with st.kv_lock:
        raw = st.kv.get(STATS_SCOPE, {}).get(STATS_KEY)
    jn = _store(server, JOURNAL_SCOPE)
    with jn.kv_lock:
        journal = len(jn.kv.get(JOURNAL_SCOPE, {}))
    out["journal"] = {"enabled": state.journal, "entries": journal}
    if raw is not None:
        try:
            out["engine"] = json.loads(raw)
        except (ValueError, TypeError):
            pass  # a torn PUT must not 500 the stats view
    rr = get_replica_router(server)
    if refresh_replicas(server, rr):
        # Replicated tier (docs/serving.md#replicated-tier): placement
        # counters + per-replica registry/load/digest rows, each
        # replica's admission state, and its full self-published engine
        # stats (kv_pool + spill occupancy included) — the payload
        # `hvdrun doctor --serve` renders as the per-replica table.
        now = time.time()
        view = rr.counters(now)
        view["admission"] = {
            str(rid): get_router_state(server, rid).counters()
            for rid in sorted(rr.replicas)}
        view["engines"] = {
            str(rid): rr.replicas[rid].get("stats", {})
            for rid in sorted(rr.replicas)}
        out["replicas"] = view
    from ..runner.http_server import kv_shard_health
    shards = kv_shard_health(server)
    if shards is not None:
        out["kv_shards"] = shards
    return out


def _json_response(handler, code: int, obj: Dict[str, Any],
                   extra_headers: Optional[Dict[str, str]] = None) -> None:
    body = json.dumps(obj).encode()
    handler.send_response(code)
    handler.send_header("Content-Type", "application/json")
    handler.send_header("Content-Length", str(len(body)))
    for k, v in (extra_headers or {}).items():
        handler.send_header(k, v)
    handler.end_headers()
    handler.wfile.write(body)
