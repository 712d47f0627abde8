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

The JAX server also renders the planes the port does not have yet.  Each
of those routes answers 404 here, with no body, until its plane lands
(:data:`PLANE_ROUTES` names the ROADMAP item of each); a key stored under
one of their scope names is still a plain KV entry.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple

from .kvshard import MAP_KEY, MAP_SCOPE, shard_for_scope

# (method, scope, key) of a route the JAX server renders -> the ROADMAP
# queue 1 item whose plane brings it
PLANE_ROUTES: Dict[Tuple[str, str, str], str] = {
    ("GET", "metrics", ""): "4.1",
    ("GET", "clock", ""): "4.1",
    ("GET", "timeline", ""): "4.1",
    ("GET", "health", ""): "4.3",
    ("GET", "series", ""): "4.3",
    ("GET", "alerts", ""): "4.3",
    ("GET", "perf", ""): "4.2",
    ("GET", "serve", "stats"): "3.4",
    ("GET", "serve", "trace"): "3.4",
    ("POST", "generate", ""): "3.4",
    ("POST", "serve", "stream"): "3.4",
    ("POST", "admin", "drain"): "3.4",
}


def store_for(server, scope: str):
    """The httpd whose in-process store owns ``scope``.  A server started
    without shards is its own (only) store."""
    stores = getattr(server, "kv_stores", None)
    if not stores:
        return server
    return stores[shard_for_scope(scope, len(stores))]


class _KVHandler(BaseHTTPRequestHandler):
    server_version = "hvdtpu-rendezvous/1.0"

    def _split(self) -> Tuple[str, str]:
        path, _, self._query = self.path.partition("?")
        parts = path.strip("/").split("/", 1)
        scope = parts[0] if parts else ""
        key = parts[1] if len(parts) > 1 else ""
        return scope, key

    def _count_request(self) -> None:
        with self.server.kv_lock:  # type: ignore[attr-defined]
            self.server.kv_requests = \
                getattr(self.server, "kv_requests", 0) + 1

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

    def do_POST(self) -> None:  # noqa: N802
        # every POST route of the JAX server belongs to a plane still to
        # come (PLANE_ROUTES), and a POST elsewhere is 404 there too
        self._not_found()

    def do_GET(self) -> None:  # noqa: N802
        scope, key = self._split()
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
            stores.append(httpd)
        for httpd in stores:
            httpd.kv_stores = stores  # type: ignore[attr-defined]
            t = threading.Thread(target=httpd.serve_forever, daemon=True)
            t.start()
            self._threads.append(t)
        self._httpd = stores[0]
        self._shard_httpds = stores
        return self._httpd.server_address[1]

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
