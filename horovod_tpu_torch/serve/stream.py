"""Direct token streaming: the serving plane's hottest path off the KV
(docs/control-plane.md#direct-streaming), the port of
``horovod_tpu/serve/stream.py`` with the same route, records and fallback.
Direct tokens count into ``hvd_serve_stream_direct_tokens_total`` at the
router's ingest, and each handoff's transit is a KV_HANDOFF span on the
merged timeline, as in the JAX module.

Before this module, every generated token rode the rendezvous KV twice:
rank 0 PUT a ``serve_out`` part, then the router busy-polled the scope
to stream it to the client — one HTTP round trip plus a poll loop per
part, all through the single rendezvous accept loop.  Now rank 0 holds
ONE persistent chunked ``POST /serve/stream`` connection to the router
and writes newline-delimited JSON records as the engine emits them:

    {"rid": "req.000007", "part": 0, "tokens": [1, 2, 3]}
    {"rid": "req.000007", "done": {"done": true, "tokens": [...], ...}}

The router-side handler (:func:`handle_stream`, running inside the
rendezvous server process) ingests each record by MIRRORING it into the
``serve_out`` store — the exact keys/values the KV PUT path would have
written — and waking the stream drains via the server's ``kv_wakeup``
condition.  Two properties follow by construction:

  * the journal keeps its KV source of truth: redrive's emitted-prefix
    recovery (serve/journal.py) reads the same ``serve_out`` keys
    whether parts arrived directly or via KV PUTs, so a fleet reset —
    or a streaming-connection loss mid-request — resumes client streams
    byte-identically (fall back to KV recovery of the published
    prefix);
  * the consumer is source-agnostic: the router's ``_stream_results``
    waits on one condition that both this handler and the shard
    servers' ``serve_out`` PUT path notify, so a worker that fell back
    to KV publishing (HOROVOD_SERVE_DIRECT=0, or the connection broke)
    feeds the same stream seamlessly.

Worker side, :class:`DirectTokenStream` wraps the persistent connection:
``send`` returns False on any transport error (the caller falls back to
``_kv_put`` for that record and a reconnect is attempted on the next
send), so a router restart degrades to the KV path instead of dropping
tokens.  Everything here is stdlib-only and jax-free.
"""

from __future__ import annotations

import http.client
import json
import time
from typing import Any, Dict, Iterator, Optional

STREAM_ROUTE = "/serve/stream"


# -------------------------------------------------------- router (ingest)
def _iter_chunked(rfile) -> Iterator[bytes]:
    """Decode a chunked transfer-encoded request body incrementally —
    BaseHTTPRequestHandler does not, and the whole point is reading
    records as the worker writes them, not at connection close."""
    while True:
        line = rfile.readline(1026).strip()
        if not line:
            return
        try:
            size = int(line.split(b";")[0], 16)
        except ValueError:
            return  # torn framing: end the stream, worker will fall back
        if size == 0:
            rfile.readline()  # trailing CRLF after the last-chunk marker
            return
        data = rfile.read(size)
        rfile.readline()  # chunk-terminating CRLF
        if not data:
            return
        yield data


def _iter_records(handler) -> Iterator[Dict[str, Any]]:
    """ndjson records from the request body: chunked (the persistent
    stream) or Content-Length'd (a one-shot batch) both work."""
    if handler.headers.get("Transfer-Encoding", "").lower() == "chunked":
        chunks = _iter_chunked(handler.rfile)
    else:
        length = int(handler.headers.get("Content-Length", 0))
        chunks = iter((handler.rfile.read(length),)) if length else iter(())
    buf = b""
    for chunk in chunks:
        buf += chunk
        while b"\n" in buf:
            line, _, buf = buf.partition(b"\n")
            if not line.strip():
                continue
            try:
                yield json.loads(line)
            except (ValueError, TypeError):
                continue  # a torn record must not kill the stream
    if buf.strip():
        try:
            yield json.loads(buf)
        except (ValueError, TypeError):
            pass


def ingest_record(server, rec: Dict[str, Any]) -> bool:
    """Mirror one direct-stream record into the ``serve_out`` store —
    byte-compatible with the KV PUT path, so redrive prefix recovery
    and late-attaching client streams see one truth — and wake the
    stream drains.  Returns False for records without a usable shape."""
    from ..runner.http_server import store_for, wake_stream
    from .router import OUT_SCOPE
    if rec.get("kind") == "kvblock":
        # Prefill->decode KV handoff riding the same persistent stream
        # (docs/serving.md#replicated-tier): mirrored into its serve_kv
        # scope exactly as the KV PUT fallback would have written it.
        kv_scope = rec.get("scope")
        key = rec.get("key")
        payload = rec.get("payload")
        if not isinstance(kv_scope, str) or \
                not kv_scope.startswith("serve_kv") or \
                not isinstance(key, str) or payload is None:
            return False
        store = store_for(server, kv_scope)
        now = time.time()
        with store.kv_lock:
            store.kv.setdefault(kv_scope, {})[key] = \
                json.dumps(payload).encode()
            store.kv_times.setdefault(kv_scope, {})[key] = now
        wake_stream(server, kv_scope, key)
        if isinstance(payload, dict) and payload.get("trace"):
            # the handoff's router transit on the merged timeline: one
            # instant-like span linking the prefill fleet's export to the
            # decode fleet's import
            from ..runner.http_server import trace_span
            from . import trace as trace_mod
            trace_span(server, "handoff", "KV_HANDOFF",
                       start_t=now, dur_s=0.0,
                       args=trace_mod.span_args(
                           payload["trace"], "KV_HANDOFF",
                           rid=str(payload.get("req_id") or "")))
        return True
    rid = rec.get("rid")
    if not rid or not isinstance(rid, str):
        return False
    # Replica scoping (serve/replica.py): replica K's worker labels its
    # records with the scoped output scope; unlabeled records are the
    # single-fleet/replica-0 path, byte-identical to before.
    out_scope = rec.get("scope", OUT_SCOPE)
    if not isinstance(out_scope, str) or \
            out_scope.split(".r", 1)[0] != OUT_SCOPE:
        return False
    if "tokens" in rec and rec.get("part") is not None:
        key = f"{rid}.part.{int(rec['part']):06d}"
        value = json.dumps({"tokens": rec["tokens"]}).encode()
        ntokens = len(rec["tokens"] or ())
    elif isinstance(rec.get("done"), dict):
        key = f"{rid}.done"
        value = json.dumps(rec["done"]).encode()
        ntokens = 0
    else:
        return False
    store = store_for(server, out_scope)
    now = time.time()
    with store.kv_lock:
        store.kv.setdefault(out_scope, {})[key] = value
        store.kv_times.setdefault(out_scope, {})[key] = now
    wake_stream(server, out_scope, key)
    if ntokens:
        try:
            from ..utils import metrics as M
            M.SERVE_STREAM_DIRECT_TOKENS.inc(ntokens)
        except Exception:
            pass  # telemetry must never break token delivery
    return True


def handle_stream(handler) -> None:
    """POST /serve/stream: drain rank 0's persistent record stream into
    the serve_out store until the worker closes it (or dies — a torn
    connection just ends the loop; the worker's next publish falls back
    to KV PUTs and the streams continue from the same store)."""
    server = handler.server
    ingested = 0
    try:
        for rec in _iter_records(handler):
            if ingest_record(server, rec):
                ingested += 1
    except (OSError, ValueError):
        pass  # connection loss mid-record: the KV fallback takes over
    try:
        body = json.dumps({"ok": True, "records": ingested}).encode()
        handler.send_response(200)
        handler.send_header("Content-Type", "application/json")
        handler.send_header("Content-Length", str(len(body)))
        handler.end_headers()
        handler.wfile.write(body)
    except OSError:
        pass  # peer already gone; nothing to acknowledge


# -------------------------------------------------------- worker (emit)
class DirectTokenStream:
    """Rank 0's persistent direct connection to the router.  ``send``
    never raises: False means the record was NOT delivered (connection
    down and one reconnect attempt failed) and the caller must publish
    it via the KV instead.  The connection re-establishes lazily on a
    later send, so a router restart costs a KV-published window, not
    the stream."""

    def __init__(self, addr: str, port: int, timeout: float = 10.0):
        self.addr = addr
        self.port = int(port)
        self.timeout = float(timeout)
        self._conn: Optional[http.client.HTTPConnection] = None
        self.sent = 0
        self.fallbacks = 0  # caller-visible: records that missed direct

    def _connect(self) -> bool:
        try:
            conn = http.client.HTTPConnection(self.addr, self.port,
                                              timeout=self.timeout)
            conn.putrequest("POST", STREAM_ROUTE)
            conn.putheader("Transfer-Encoding", "chunked")
            conn.putheader("Content-Type", "application/x-ndjson")
            conn.endheaders()
            self._conn = conn
            return True
        except OSError:
            self._conn = None
            return False

    def _write(self, data: bytes) -> bool:
        assert self._conn is not None
        try:
            self._conn.send(b"%x\r\n" % len(data) + data + b"\r\n")
            return True
        except OSError:
            try:
                self._conn.close()
            finally:
                self._conn = None
            return False

    def send(self, record: Dict[str, Any]) -> bool:
        data = json.dumps(record).encode() + b"\n"
        if self._conn is not None and self._write(data):
            self.sent += 1
            return True
        # one reconnect attempt per send: a dead router degrades this
        # record to the KV path without stalling the engine tick
        if self._connect() and self._write(data):
            self.sent += 1
            return True
        self.fallbacks += 1
        return False

    def close(self) -> None:
        conn, self._conn = self._conn, None
        if conn is None:
            return
        try:
            conn.send(b"0\r\n\r\n")
            conn.getresponse().read()
        except OSError:
            pass  # a torn close loses no data: everything sent is stored
        finally:
            conn.close()
