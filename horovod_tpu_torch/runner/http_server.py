"""Rendezvous: a threaded HTTP key-value store, the port of
``horovod_tpu/runner/http_server.py``.

PUT/GET/DELETE on ``/scope/key`` paths backed by an in-memory dict
(reference: horovod/runner/http/http_server.py:35-201), on the JAX server's
wire protocol byte for byte: a PUT answers 200 with no body, a GET 200 with
``Content-Length`` and the value or 404 with no body, a DELETE 200 or 404;
the server header is the same.  Consumers: the launcher publishing each
slot's env (scope ``rank``), ``run()``'s function and results (scope
``run``), and anything that needs a tiny shared blackboard during a job.

Sharding (docs/control-plane.md): with ``shards=N`` the server starts N-1
additional KV shard servers in this process, each with its own store, lock
and accept loop; scopes are owned per the deterministic
``runner/kvshard.shard_for_scope`` map, clients route per scope, and
server-side reads go to the owning shard's store in-process.  A dark shard
therefore stalls only the scopes it owns.

The serving fleet's front door is here, as on the JAX server
(``serve/router.py``, ``serve/stream.py``; docs/serving.md):

  * ``POST /generate`` enqueues a request onto scope ``serve_req``
    (journaled to ``serve_journal``) and streams the fleet's tokens back
    as ndjson;
  * ``POST /serve/stream`` is rank 0's persistent direct token stream,
    mirrored into the ``serve_out`` store in-process;
  * ``GET /serve/stats`` and ``GET /serve/trace`` render the router's and
    the engine's views and the per-request trace rollup;
  * ``POST /admin/drain`` stops admission and drains the fleet to exit 0.

``serve_out`` and ``serve_kv`` writes wake the stream drains through keyed
per-request conditions (:func:`add_stream_waiter`, :func:`wake_stream`)
and the broadcast ``kv_wakeup``.

The measurement plane's routes (``utils/``), as on the JAX server:

  * ``GET /metrics`` renders the fleet's Prometheus text: the driver's
    registry (``rank="driver"``) and every worker snapshot the ``metrics``
    scope holds, rank-labeled;
  * ``GET /clock`` returns this server's wall time, the reference clock of
    the ranks' offset estimates (``utils/clocksync.py``);
  * ``GET /timeline`` merges the ``timeline`` scope's chunks into one
    rank-laned Chrome/Perfetto trace (``utils/timeline.py``);
  * ``GET /perf`` merges the ``perf`` scope's per-rank reports into the
    fleet's step attribution (``perf/ledger.py``).

The forensics planes' routes, as on the JAX server:

  * ``GET /health`` renders the ``health`` scope's heartbeats with
    per-rank staleness from the server's receipt times
    (``utils/health.fleet_health``; ``?stale_after=S``);
  * ``GET /series`` and ``GET /alerts`` read the watch plane's series
    store and alert engine (``watch/``), which :meth:`RendezvousServer.start`
    installs on the store that owns the ``metrics`` scope: every
    ``metrics`` PUT feeds the store and runs an evaluation pass, every
    ``health`` PUT feeds the heartbeat series, and a firing alert lands as
    an instant on its rank's lane of the merged timeline.

Every route the JAX server renders is rendered here
(:data:`PLANE_ROUTES` is empty).
"""

from __future__ import annotations

import itertools
import json
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple

from .kvshard import MAP_KEY, MAP_SCOPE, shard_for_scope

METRICS_SCOPE = "metrics"
PERF_SCOPE = "perf"
TIMELINE_SCOPE = "timeline"
CLOCK_SCOPE = "clock"
HEALTH_SCOPE = "health"
SERIES_ROUTE = "series"
ALERTS_ROUTE = "alerts"

# (method, scope, key) of a route the JAX server renders that waits for a
# plane the port does not have yet -> the ROADMAP queue 1 item bringing it
PLANE_ROUTES: Dict[Tuple[str, str, str], str] = {}
# serve_out writes wake the router's stream drains (serve/router.py waits
# on kv_wakeup instead of busy-polling); serve_kv writes wake the decode
# sub-fleet's handoff probes.  Matching is on the base name, so replica
# scoped variants (serve_out.r01, ...; serve/replica.py) wake too.
_WAKEUP_SCOPES = ("serve_out", "serve_kv")


def add_stream_waiter(server, scope: str, req_key: str):
    """Register a per-request wakeup condition for one stream drain
    (serve/router.py) and return it, or None on a server without the
    waiter registry, where the caller falls back to the broadcast
    ``kv_wakeup``.  Keyed waiters wake a stream on its own records only,
    not every waiting stream on every record."""
    waiters = getattr(server, "kv_waiters", None)
    lock = getattr(server, "kv_waiters_lock", None)
    if waiters is None or lock is None:
        return None
    with lock:
        ent = waiters.get((scope, req_key))
        if ent is None:
            ent = waiters[(scope, req_key)] = [threading.Condition(), 0]
        ent[1] += 1  # refcount: a re-dispatched stream may share a key
        return ent[0]


def drop_stream_waiter(server, scope: str, req_key: str) -> None:
    waiters = getattr(server, "kv_waiters", None)
    lock = getattr(server, "kv_waiters_lock", None)
    if waiters is None or lock is None:
        return
    with lock:
        ent = waiters.get((scope, req_key))
        if ent is not None:
            ent[1] -= 1
            if ent[1] <= 0:
                del waiters[(scope, req_key)]


def wake_stream(server, scope: str, key: str) -> None:
    """Wake the stream drain waiting on this record: the per-request
    condition when one is registered (``serve_out`` keys are
    ``req.NNNNNN.part.*`` / ``req.NNNNNN.done``), then the broadcast
    condition for unkeyed waiters."""
    if scope.split(".r", 1)[0] not in _WAKEUP_SCOPES:
        return
    waiters = getattr(server, "kv_waiters", None)
    lock = getattr(server, "kv_waiters_lock", None)
    if waiters is not None and lock is not None:
        req = key.split(".part.", 1)[0]
        if req.endswith(".done"):
            req = req[:-len(".done")]
        with lock:
            ent = waiters.get((scope, req))
        if ent is not None:
            cond = ent[0]
            with cond:
                cond.notify_all()
    cond = getattr(server, "kv_wakeup", None)
    if cond is not None:
        with cond:
            cond.notify_all()


def store_for(server, scope: str):
    """The httpd whose in-process store owns ``scope``.  A server started
    without shards is its own (only) store."""
    stores = getattr(server, "kv_stores", None)
    if not stores:
        return server
    return stores[shard_for_scope(scope, len(stores))]


_TRACE_SEQ = itertools.count()


def trace_span(server, lane: str, name: str, start_t: float,
               dur_s: float, args: Optional[Dict] = None) -> None:
    """Router-side request span as a synthetic timeline chunk on rank 0's
    process lane: worker chunks stamp absolute aligned us measured against
    this server, so the server's own wall clock is on the same epoch by
    construction.  Best-effort: tracing must never take the front door
    down."""
    try:
        chunk = {"rank": 0, "seq": -1, "events": [
            {"name": name, "ph": "X", "ts": float(start_t) * 1e6,
             "dur": max(0.0, float(dur_s)) * 1e6, "lane": lane,
             "args": args or {}}]}
        tl = store_for(server, TIMELINE_SCOPE)
        key = f"trace.0.{next(_TRACE_SEQ):06d}"
        with tl.kv_lock:  # type: ignore[attr-defined]
            tl.kv.setdefault(TIMELINE_SCOPE, {})[key] = \
                json.dumps(chunk).encode()  # type: ignore[attr-defined]
            tl.kv_times.setdefault(TIMELINE_SCOPE, {})[key] = \
                time.time()  # type: ignore[attr-defined]
    except Exception:
        pass


def watch_state_for(server):
    """The watch plane's server-side state (series store and alert
    engine), installed on the store that owns the ``metrics`` scope at
    server start, or None on a server that has none."""
    return getattr(store_for(server, METRICS_SCOPE), "watch_state", None)


class _KVHandler(BaseHTTPRequestHandler):
    server_version = "hvdtpu-rendezvous/1.0"

    def _split(self) -> Tuple[str, str]:
        path, _, self._query = self.path.partition("?")
        parts = path.strip("/").split("/", 1)
        scope = parts[0] if parts else ""
        key = parts[1] if len(parts) > 1 else ""
        return scope, key

    def _count_request(self) -> None:
        """Per-shard request accounting (hvd_kv_shard_requests_total),
        only on a sharded KV, as on the JAX server."""
        stores = getattr(self.server, "kv_stores", None)
        idx = getattr(self.server, "shard_index", 0)
        with self.server.kv_lock:  # type: ignore[attr-defined]
            self.server.kv_requests = \
                getattr(self.server, "kv_requests", 0) + 1
        if stores and len(stores) > 1:
            try:
                from ..utils import metrics as M
                M.KV_SHARD_REQUESTS.inc(shard=str(idx))
            except Exception:
                pass  # telemetry must never take a KV op down

    def _not_found(self) -> None:
        self.send_response(404)
        self.end_headers()

    def do_PUT(self) -> None:  # noqa: N802
        scope, key = self._split()
        length = int(self.headers.get("Content-Length", 0))
        value = self.rfile.read(length)
        self._count_request()
        with self.server.kv_lock:  # type: ignore[attr-defined]
            self.server.kv.setdefault(scope, {})[key] = value  # type: ignore
            self.server.kv_times.setdefault(scope, {})[key] = \
                time.time()  # type: ignore[attr-defined]
        self.send_response(200)
        self.end_headers()
        wake_stream(self.server, scope, key)
        # the watch plane: metrics snapshots feed the fleet series store
        # (rate-limited to its resolution) and run an evaluation pass;
        # heartbeats feed the liveness series.  Telemetry never fails the
        # KV op that carried it.
        if scope in (METRICS_SCOPE, HEALTH_SCOPE):
            try:
                ws = watch_state_for(self.server)
                if ws is not None:
                    if scope == METRICS_SCOPE:
                        ws.ingest_metrics(key, value)
                    else:
                        ws.note_heartbeat(key)
            except Exception:
                pass

    def do_POST(self) -> None:  # noqa: N802
        scope, key = self._split()
        if scope == "generate" and not key:
            from ..serve import router as serve_router
            serve_router.handle_generate(self)
        elif scope == "serve" and key == "stream":
            from ..serve import stream as serve_stream
            serve_stream.handle_stream(self)
        elif scope == "admin" and key == "drain":
            from ..serve import router as serve_router
            serve_router.handle_drain(self)
        else:
            # the JAX server's other POST routes are 404 there too
            self._not_found()

    def _serve_body(self, body: bytes, content_type: str) -> None:
        self.send_response(200)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _serve_json(self, obj) -> None:
        self._serve_body(json.dumps(obj).encode(), "application/json")

    def _serve_metrics(self) -> None:
        """Fleet Prometheus exposition: the local (driver) registry and
        every worker snapshot the ``metrics`` scope holds, rank-labeled."""
        from ..utils import metrics as M
        store = store_for(self.server, METRICS_SCOPE)
        with store.kv_lock:  # type: ignore[attr-defined]
            stored = dict(store.kv.get(METRICS_SCOPE, {}))  # type: ignore
        snaps = [({"rank": "driver"}, M.REGISTRY.snapshot())]
        for key in sorted(stored):
            try:
                snap = json.loads(stored[key])
            except (ValueError, TypeError):
                continue  # a torn PUT must not 500 the whole scrape
            rank = str(snap.get("rank", key.rsplit(".", 1)[-1]))
            snaps.append(({"rank": rank}, snap))
        self._serve_body(M.render_prometheus(snaps).encode(),
                         "text/plain; version=0.0.4; charset=utf-8")

    def _serve_timeline(self) -> None:
        """Merged fleet trace: every chunk the ``timeline`` scope holds,
        rank-laned on the shared aligned epoch."""
        from ..utils.timeline import merge_timeline_chunks
        store = store_for(self.server, TIMELINE_SCOPE)
        with store.kv_lock:  # type: ignore[attr-defined]
            stored = dict(store.kv.get(TIMELINE_SCOPE, {}))  # type: ignore
        self._serve_json(merge_timeline_chunks(stored))

    def _serve_perf(self) -> None:
        """The merged fleet perf view: the ``perf`` scope's per-rank
        reports plus the fleet verdict (``perf/ledger.py``
        ``merge_perf_reports``), what ``launch doctor --perf`` renders."""
        from ..perf.ledger import merge_perf_reports
        store = store_for(self.server, PERF_SCOPE)
        with store.kv_lock:  # type: ignore[attr-defined]
            stored = dict(store.kv.get(PERF_SCOPE, {}))  # type: ignore
        self._serve_json(merge_perf_reports(stored))

    def _serve_health(self) -> None:
        """The fleet's liveness view: the ``health`` scope's heartbeats
        with per-rank staleness judged from the server's receipt times
        (``GET /health?stale_after=S``, default 10 s), and the KV shards'
        health on a sharded KV."""
        from urllib.parse import parse_qs
        from ..utils.health import fleet_health
        stale_after = 10.0
        try:
            q = parse_qs(getattr(self, "_query", ""))
            if q.get("stale_after"):
                stale_after = float(q["stale_after"][0])
        except (ValueError, TypeError):
            pass  # a malformed query keeps the default patience
        store = store_for(self.server, HEALTH_SCOPE)
        with store.kv_lock:  # type: ignore[attr-defined]
            stored = dict(store.kv.get(HEALTH_SCOPE, {}))  # type: ignore
            times = dict(store.kv_times.get(  # type: ignore
                HEALTH_SCOPE, {}))
        view = fleet_health(stored, times, stale_after=stale_after)
        shards = kv_shard_health(self.server)
        if shards is not None:
            view["kv_shards"] = shards
        self._serve_json(view)

    def _serve_series(self) -> None:
        """The fleet series store's view: ``GET
        /series?family=F&rank=N&window=S`` filters, bare ``GET /series``
        returns everything retained."""
        from urllib.parse import parse_qs
        ws = watch_state_for(self.server)
        if ws is None:
            self._serve_json({"error": "watch plane not installed"})
            return
        family = rank = window = None
        try:
            q = parse_qs(getattr(self, "_query", ""))
            if q.get("family"):
                family = q["family"][0]
            if q.get("rank"):
                rank = int(q["rank"][0])
            if q.get("window"):
                window = float(q["window"][0])
        except (ValueError, TypeError):
            pass  # a malformed query gives the unfiltered view
        self._serve_json(ws.store.query(family=family, rank=rank,
                                        window_s=window))

    def _serve_alerts(self) -> None:
        """One evaluation pass of the alert engine: firing alerts first
        (by severity), the ruleset and the transition history, plus the
        series store's bounds; what ``launch doctor --watch`` renders."""
        ws = watch_state_for(self.server)
        if ws is None:
            self._serve_json({"error": "watch plane not installed"})
            return
        view = ws.engine.view()
        view["series"] = {"families": len(ws.store.families()),
                          "points": ws.store.point_count(),
                          "dropped_series": ws.store.dropped_series}
        self._serve_json(view)

    def do_GET(self) -> None:  # noqa: N802
        scope, key = self._split()
        if scope == "serve" and key in ("stats", "trace"):
            from ..serve import router as serve_router
            render = (serve_router.render_stats if key == "stats"
                      else serve_router.render_trace)
            self._serve_json(render(self.server))
            return
        if scope == METRICS_SCOPE and not key:
            self._serve_metrics()
            return
        if scope == CLOCK_SCOPE and not key:
            self._serve_body(repr(time.time()).encode(), "text/plain")
            return
        if scope == TIMELINE_SCOPE and not key:
            self._serve_timeline()
            return
        if scope == PERF_SCOPE and not key:
            self._serve_perf()
            return
        if scope == HEALTH_SCOPE and not key:
            self._serve_health()
            return
        if scope == SERIES_ROUTE and not key:
            self._serve_series()
            return
        if scope == ALERTS_ROUTE and not key:
            self._serve_alerts()
            return
        if ("GET", scope, key) in PLANE_ROUTES:
            self._not_found()
            return
        self._count_request()
        with self.server.kv_lock:  # type: ignore[attr-defined]
            value = self.server.kv.get(scope, {}).get(key)  # type: ignore
        if value is None:
            self._not_found()
            return
        self.send_response(200)
        self.send_header("Content-Length", str(len(value)))
        self.end_headers()
        self.wfile.write(value)

    def do_DELETE(self) -> None:  # noqa: N802
        scope, key = self._split()
        self._count_request()
        with self.server.kv_lock:  # type: ignore[attr-defined]
            existed = self.server.kv.get(scope, {}).pop(key, None)  # type: ignore
            self.server.kv_times.get(scope, {}).pop(key, None)  # type: ignore
        self.send_response(200 if existed is not None else 404)
        self.end_headers()

    def log_message(self, *args) -> None:  # silence per-request logging
        pass


def kv_shard_health(server) -> Optional[List[Dict]]:
    """Per-shard control-plane health rows, or None on an unsharded
    server: shard index, bound port, liveness (stop_shard marks a shard
    dark), request count, key count and the scopes currently resident
    (docs/control-plane.md)."""
    stores = getattr(server, "kv_stores", None)
    if not stores or len(stores) < 2:
        return None
    rows = []
    for i, store in enumerate(stores):
        with store.kv_lock:
            scopes = sorted(store.kv)
            keys = sum(len(d) for d in store.kv.values())
            requests = getattr(store, "kv_requests", 0)
        rows.append({
            "shard": i,
            "port": store.server_address[1],
            "alive": not getattr(store, "kv_stopped", False),
            "requests": requests,
            "keys": keys,
            "scopes": scopes,
        })
    return rows


class RendezvousServer:
    """Threaded KV server; start() returns the bound port (reference:
    http_server.py:174-201 RendezvousServer.start/init).

    ``shards=N`` starts N-1 additional KV shard servers in this process
    (own store/lock/accept loop each, ephemeral ports); server-side
    accessors route per scope through ``kvshard.shard_for_scope``, exactly
    like the workers' clients, so both sides agree by construction."""

    def __init__(self, host: str = "0.0.0.0", port: int = 0,
                 shards: int = 1):
        self._host = host
        self._port = port
        self._shards = max(1, int(shards))
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._shard_httpds: List[ThreadingHTTPServer] = []
        self._threads: List[threading.Thread] = []
        self._final_kv: List[dict] = []
        self._final_kv_times: List[dict] = []

    def start(self) -> int:
        wakeup = threading.Condition()
        # keyed stream waiters (add_stream_waiter), shared across the shard
        # httpds like the broadcast condition, so a stream's records wake
        # it whichever shard its scope hashes to
        waiters: Dict[Tuple[str, str], list] = {}
        waiters_lock = threading.Lock()
        stores: List[ThreadingHTTPServer] = []
        for i in range(self._shards):
            # Only the primary gets the requested port; shard servers
            # bind ephemeral ports published via the shard map.
            httpd = ThreadingHTTPServer(
                (self._host, self._port if i == 0 else 0), _KVHandler)
            httpd.kv = {}  # type: ignore[attr-defined]
            httpd.kv_times = {}  # type: ignore[attr-defined]
            httpd.kv_lock = threading.Lock()  # type: ignore[attr-defined]
            httpd.kv_requests = 0  # type: ignore[attr-defined]
            httpd.kv_stopped = False  # type: ignore[attr-defined]
            httpd.shard_index = i  # type: ignore[attr-defined]
            httpd.kv_wakeup = wakeup  # type: ignore[attr-defined]
            httpd.kv_waiters = waiters  # type: ignore[attr-defined]
            httpd.kv_waiters_lock = waiters_lock  # type: ignore[attr-defined]
            stores.append(httpd)
        for httpd in stores:
            httpd.kv_stores = stores  # type: ignore[attr-defined]
            t = threading.Thread(target=httpd.serve_forever, daemon=True)
            t.start()
            self._threads.append(t)
        self._httpd = stores[0]
        self._shard_httpds = stores
        self._install_watch_state(stores)
        return self._httpd.server_address[1]

    def _install_watch_state(self, stores) -> None:
        """The watch plane's series store and alert engine, on the store
        that owns the ``metrics`` scope.  A firing alert also lands as an
        instant on its rank's lane of the ``timeline`` scope, on this
        server's clock, the epoch the ranks' chunks are aligned to."""
        from ..watch import make_watch_state
        seq = itertools.count()

        def alert_instant(rule: str, rank: int, severity: str,
                          now: float) -> None:
            chunk = {"rank": int(rank), "seq": -1, "events": [
                {"name": f"alert.{rule}", "ph": "i", "s": "p",
                 "ts": now * 1e6, "lane": "alerts",
                 "args": {"rule": rule, "severity": severity}}]}
            tl = store_for(stores[0], TIMELINE_SCOPE)
            key = f"alert.{rank}.{next(seq):06d}"
            with tl.kv_lock:  # type: ignore[attr-defined]
                tl.kv.setdefault(TIMELINE_SCOPE, {})[key] = \
                    json.dumps(chunk).encode()  # type: ignore
                tl.kv_times.setdefault(TIMELINE_SCOPE, {})[key] = \
                    time.time()  # type: ignore[attr-defined]

        ws = make_watch_state(
            instant_fn=alert_instant,
            log_fn=lambda m: print(m, file=sys.stderr, flush=True))
        store_for(stores[0], METRICS_SCOPE).watch_state = ws

    @property
    def watch_state(self):
        """The installed watch plane (None before start())."""
        if self._httpd is None:
            return None
        return watch_state_for(self._httpd)

    def install_alert_rules(self, rules) -> None:
        """Merge user alert rules (``launch --alerts`` / HOROVOD_ALERTS)
        over the committed defaults by name and publish the merged set to
        KV scope ``alerts`` key ``rules``, as the chaos spec is
        distributed."""
        ws = self.watch_state
        if ws is None:
            return
        ws.engine.set_rules(rules)
        from ..watch import KV_KEY, KV_SCOPE, rules_to_json
        self.put(KV_SCOPE, KV_KEY,
                 rules_to_json(ws.engine.rules).encode())

    @property
    def port(self) -> int:
        assert self._httpd is not None
        return self._httpd.server_address[1]

    @property
    def shard_ports(self) -> List[int]:
        """Bound port per shard, primary first — what the launcher stamps
        into HOROVOD_KV_SHARD_ADDRS and publishes at scope ``kvshard`` key
        ``map``."""
        assert self._shard_httpds
        return [h.server_address[1] for h in self._shard_httpds]

    def publish_shard_map(self, addr: str) -> None:
        """Publish the shard address list to the primary's ``kvshard``
        scope so workers can cross-check the map they derived from env."""
        self.put(MAP_SCOPE, MAP_KEY, json.dumps({
            "n": self._shards,
            "addrs": [f"{addr}:{p}" for p in self.shard_ports],
        }).encode())

    def _store(self, scope: str):
        assert self._httpd is not None
        return store_for(self._httpd, scope)

    def put(self, scope: str, key: str, value: bytes) -> None:
        """Server-side direct write (the launcher publishing slot info)."""
        store = self._store(scope)
        with store.kv_lock:  # type: ignore[attr-defined]
            store.kv.setdefault(scope, {})[key] = value  # type: ignore
            store.kv_times.setdefault(scope, {})[key] = \
                time.time()  # type: ignore[attr-defined]

    def get(self, scope: str, key: str) -> Optional[bytes]:
        if self._httpd is None:
            # Server-side reads stay valid after stop(): the store is
            # retained so callers can harvest worker-published state
            # (run()'s per-rank results) after the job.
            return self._final_scope(scope).get(key)
        store = self._store(scope)
        with store.kv_lock:  # type: ignore[attr-defined]
            return store.kv.get(scope, {}).get(key)  # type: ignore

    def _final_scope(self, scope: str) -> dict:
        idx = shard_for_scope(scope, len(self._final_kv) or 1)
        if idx >= len(self._final_kv):
            return {}
        return self._final_kv[idx].get(scope, {})

    def scope_items(self, scope: str) -> Dict[str, bytes]:
        """All key->value pairs of a scope (valid after stop(), like
        get())."""
        if self._httpd is None:
            return dict(self._final_scope(scope))
        store = self._store(scope)
        with store.kv_lock:  # type: ignore[attr-defined]
            return dict(store.kv.get(scope, {}))  # type: ignore

    def scope_receipt_times(self, scope: str) -> Dict[str, float]:
        """Wall-clock receipt time of every key in a scope (valid after
        stop(), like scope_items)."""
        if self._httpd is None:
            idx = shard_for_scope(scope, len(self._final_kv_times) or 1)
            if idx >= len(self._final_kv_times):
                return {}
            return dict(self._final_kv_times[idx].get(scope, {}))
        store = self._store(scope)
        with store.kv_lock:  # type: ignore[attr-defined]
            return dict(store.kv_times.get(scope, {}))  # type: ignore

    def clear_scope(self, scope: str) -> None:
        """Drop every key in a scope."""
        store = self._store(scope)
        with store.kv_lock:  # type: ignore[attr-defined]
            store.kv.pop(scope, None)  # type: ignore[attr-defined]
            store.kv_times.pop(scope, None)  # type: ignore

    def stop_shard(self, index: int) -> None:
        """Take ONE shard dark (connections refused, the in-process store
        retained).  The primary (index 0) cannot be stopped alone; use
        stop()."""
        if index == 0:
            raise ValueError("shard 0 is the primary; stop() the server")
        httpd = self._shard_httpds[index]
        if getattr(httpd, "kv_stopped", False):
            return
        httpd.kv_stopped = True  # type: ignore[attr-defined]
        httpd.shutdown()
        httpd.server_close()

    def stop(self) -> None:
        if self._httpd is not None:
            self._final_kv = []
            self._final_kv_times = []
            for httpd in self._shard_httpds:
                with httpd.kv_lock:  # type: ignore[attr-defined]
                    self._final_kv.append(
                        {s: dict(d)
                         for s, d in httpd.kv.items()})  # type: ignore
                    self._final_kv_times.append(
                        {s: dict(d)
                         for s, d in httpd.kv_times.items()})  # type: ignore
                if not getattr(httpd, "kv_stopped", False):
                    httpd.kv_stopped = True  # type: ignore[attr-defined]
                    httpd.shutdown()
                    httpd.server_close()
            self._httpd = None
            self._shard_httpds = []
