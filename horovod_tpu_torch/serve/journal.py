"""Request journal + redrive: the durability half of the serving plane,
the port's copy of ``horovod_tpu/serve/journal.py``
(docs/serving.md#fault-tolerance).

The router journals every ACCEPTED request — prompt, params, dense
sequence key — to the rendezvous KV scope ``serve_journal`` at the same
moment it enqueues the request for the engine fleet.  The journal lives
in the launcher's rendezvous server, which survives worker deaths, so
after a fleet reset (rank death, wedged-engine SIGABRT, preemption) the
new rank 0 can reconstruct exactly what was promised to clients:

  * a journal entry with a ``serve_out`` ``.done`` record finished
    before the reset — nothing to do;
  * an entry without one is UNFINISHED: the tokens already streamed to
    the client are recovered from the published ``serve_out`` parts
    (the router streamed exactly those), the request is re-admitted,
    and — greedy decode being deterministic — the regenerated stream's
    first ``len(emitted)`` tokens are suppressed instead of re-published
    so the client's ndjson stream resumes seamlessly from the last
    token it saw (serve/worker.py applies the suppression).

Everything here is a pure function over a ``get(scope, key) ->
Optional[bytes]`` probe so the redrive computation unit-tests without a
fleet (tests/test_serve_ft.py) and runs identically against the live KV
(serve/worker.py wires ``runner/http_client.get_kv`` in).
"""

from __future__ import annotations

import json
from typing import Any, Callable, Dict, List, Optional, Tuple

JOURNAL_SCOPE = "serve_journal"

KVGet = Callable[[str, str], Optional[bytes]]


def journal_key(seq: int) -> str:
    """Dense journal numbering — the SAME key the request carries in
    ``serve_req`` (router.req_key), so redrive can probe seq 0,1,2,...
    with no KV listing primitive."""
    return f"req.{seq:06d}"


def emitted_prefix(get: KVGet, rid: str) -> Tuple[List[int], int]:
    """Tokens already published (and therefore already streamed to the
    client) for one request, plus the next part index to publish at.
    A torn part PUT ends the prefix there — the router's stream stopped
    at the same place, so suppression and the client stay aligned."""
    from .router import OUT_SCOPE
    emitted: List[int] = []
    part = 0
    while True:
        raw = get(OUT_SCOPE, f"{rid}.part.{part:06d}")
        if raw is None:
            return emitted, part
        try:
            emitted.extend(int(t) for t in json.loads(raw).get("tokens", []))
        except (ValueError, TypeError):
            return emitted, part
        part += 1


def redrive_plan(get: KVGet) -> Tuple[List[Dict[str, Any]], int]:
    """Scan the journal and build the redrive list: every unfinished
    entry annotated with ``resume_emitted`` (the streamed prefix to
    suppress) and ``resume_part`` (where publishing resumes).  Returns
    ``(entries, next_seq)`` where ``next_seq`` is the first request
    sequence number the journal has NOT claimed — the resumed fleet's
    request-drain cursor (completed requests are skipped but counted)."""
    from .router import OUT_SCOPE
    entries: List[Dict[str, Any]] = []
    seq = 0
    while True:
        raw = get(JOURNAL_SCOPE, journal_key(seq))
        if raw is None:
            return entries, seq
        seq += 1
        try:
            entry = json.loads(raw)
        except (ValueError, TypeError):
            continue  # torn journal PUT: hold the numbering, skip it
        rid = entry.get("id")
        if not rid:
            continue
        if get(OUT_SCOPE, f"{rid}.done") is not None:
            continue  # finished before the reset
        emitted, part = emitted_prefix(get, rid)
        entry["resume_emitted"] = emitted
        entry["resume_part"] = part
        if entry.get("trace"):
            # Redrive hop: derive a child context so the resumed
            # fleet's spans link under the original admission
            # (serve/trace.py — pure, so recomputing the same journal
            # entry re-mints identical span ids).
            from . import trace as trace_mod
            entry["trace"] = trace_mod.child(entry["trace"], "redrive")
        entries.append(entry)
