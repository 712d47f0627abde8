"""Serving worker: ``python -m horovod_tpu_torch.runner.launch --serve DIR``
runs one of these per slot.  The port of ``horovod_tpu/serve/worker.py``:
the same plan stream, scopes, keys, records and knobs.

Bring-up mirrors a training worker (``hvd.init()`` from the launcher's
env, the engine on ``cuda:<local rank>``; on the CPU only when the
command says ``--device cpu``), then the engine serves instead of
trains.  Each rank holds a whole engine; the JAX fleet shards the pool's
blocks over the mesh (ROADMAP queue 1 item 3.3).  Fleet coordination
rides the existing rendezvous KV:

  * the router (runner/http_server.py + serve/router.py) enqueues
    requests with dense sequence numbers into scope ``serve_req``;
  * rank 0 drains them, publishes a per-tick PLAN (scope ``serve_plan``
    key ``e<epoch>.tick.N``) carrying the admitted requests verbatim,
    and every rank — rank 0 included — applies the same plan to its own
    engine copy.  Engine scheduling and sampling are deterministic
    (serve/engine.py), so the fleet stays in lockstep without any new
    transport: the plan stream is the only coordination channel, and it
    is the same KV the chaos/metrics/timeline planes already exercise;
  * rank 0 publishes results that the router streams to clients — by
    default over ONE persistent direct connection (``POST
    /serve/stream``, serve/stream.py; knob HOROVOD_SERVE_DIRECT), which
    the router mirrors into scope ``serve_out`` in-process so the
    journal's redrive source of truth is unchanged; on connection loss
    each record falls back to a ``serve_out`` KV PUT (per-tick token
    parts + a final ``.done`` record — the pre-scale-out path,
    docs/control-plane.md) — plus a periodic engine-stats snapshot
    (scope ``serve`` key ``stats``) for ``GET /serve/stats``.

Fault tolerance (docs/serving.md#fault-tolerance):

  * **epoch fencing** — plan keys are namespaced by the elastic reset
    round (HOROVOD_ELASTIC_ROUND -> ``epoch``), and every plan carries
    its epoch in-band, so a restarted fleet can neither read nor replay
    a stale ``serve_plan`` key from a previous incarnation;
  * **redrive** — at bring-up, rank 0 scans the request journal
    (serve/journal.py, scope ``serve_journal``) left by the previous
    incarnation, re-admits every unfinished request through the FIRST
    plan of the new epoch, and — greedy decode being deterministic —
    suppresses re-publishing the token prefix the client already
    received, so its ndjson stream resumes from the last token;
  * **stall, don't die** — every worker-side KV leg rides a bounded
    exp-backoff retry (``common/util.backoff_delays``), so a transient
    rendezvous outage (chaos blackout, server restart) stalls the loop
    instead of killing the fleet;
  * **graceful drain** — the router's POST /admin/drain plants a drain
    signal (scope ``serve`` key ``drain``); rank 0 stops admitting new
    work, finishes everything accepted, publishes the ``drained`` ack
    and stops the fleet with exit 0 (preemption-safe rolling restart);
SLO observability is inherited, not added: the engine records the
``hvd_serve_*`` metrics (published by the runtime's ``MetricsPublisher``
to ``/metrics``, which ``--serve`` turns on) and per-request spans into
the merged timeline, and rank 0 counts redriven requests.  Left out until
the port has their planes: the JAX loop's serve-aware chaos
(``chaos.step``/``maybe_stall``, ROADMAP queue 1 item 4.5) and its
``postmortem.record_step`` liveness tick (item 4.3).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Any, Callable, Dict, List, Optional

from .replica import REPLICA_SCOPE, replica_key, scoped
from .router import (DRAIN_KEY, DRAINED_KEY, OUT_SCOPE, PLAN_SCOPE,
                     REQ_SCOPE, STATS_KEY, STATS_SCOPE, req_key)

# Prefill->decode handoff scope (docs/serving.md#replicated-tier): the
# prefill sub-fleet's rank 0 publishes each finished prefill's prompt
# KV + first token here (densely numbered, like serve_req) and the
# decode sub-fleet drains it in order.
KV_SCOPE = "serve_kv"

_IDLE_SLEEP_S = 0.02
_STATS_INTERVAL_S = 1.0
# Drain-latch probe cadence: the latch is a driver/human-scale signal,
# but probing it was a KV roundtrip on EVERY engine tick — at serving
# tick rates that roundtrip (two thread handoffs through the rendezvous
# server) was a measurable slice of the tick budget.  A quarter-second
# poll bounds drain pickup latency far below the drain timeout while
# taking the probe off the hot loop.
_DRAIN_POLL_S = 0.25
# Serve-loop KV retry budget: wider than the http_client's own write
# budget because a mid-stream outage should stall serving, not kill it
# (the elastic driver would misread the death as a rank failure).
_KV_RETRIES = 8
_KV_BACKOFF_MS = 50.0


def plan_key(tick: int, epoch: int = 0) -> str:
    """Epoch-namespaced plan key: a reset bumps the epoch, so the new
    fleet's key space is disjoint from every stale plan (fencing)."""
    return f"e{epoch:04d}.tick.{tick:09d}"


class FleetFrontend:
    """Drives one engine in fleet lockstep (see module docstring).
    ``addr``/``port`` empty means standalone (no KV; local submissions
    only — the bench/load-generator path)."""

    def __init__(self, engine, addr: str, port: int, rank: int,
                 nprocs: int, plan_timeout_s: float = 120.0,
                 epoch: int = 0, journal: bool = True,
                 drain_timeout_s: float = 30.0, direct: bool = True,
                 replica_id: int = 0, role: str = "mixed"):
        self.engine = engine
        self.addr = addr
        self.port = int(port or 0)
        self.rank = int(rank)
        self.nprocs = int(nprocs)
        self.plan_timeout_s = float(plan_timeout_s)
        self.epoch = int(epoch)
        self.journal = bool(journal)
        self.drain_timeout_s = float(drain_timeout_s)
        self.direct = bool(direct)
        self.replica_id = int(replica_id)
        self.role = str(role)
        # Per-replica KV scoping (serve/replica.py): replica 0 keeps
        # the unscoped names, replica K suffixes .rKK — N fleets share
        # one rendezvous without collisions.
        self.req_scope = scoped(REQ_SCOPE, self.replica_id)
        self.out_scope = scoped(OUT_SCOPE, self.replica_id)
        self.plan_scope = scoped(PLAN_SCOPE, self.replica_id)
        self.stats_scope = scoped(STATS_SCOPE, self.replica_id)
        self.kv_scope = scoped(KV_SCOPE, self.replica_id)
        self._stats_key = STATS_KEY
        self._drained_key = DRAINED_KEY
        if self.role == "prefill":
            # The prefill sub-fleet runs its own plan stream and stats
            # key beside the decode sub-fleet's — the decode side owns
            # the client-facing ones (it emits the tokens).
            self.plan_scope += ".pf"
            self._stats_key += ".prefill"
            self._drained_key += ".prefill"
        self._dstream = None  # lazy: serve/stream.DirectTokenStream
        self.tick = 0
        self._next_seq = 0
        self._next_handoff = 0  # decode role: serve_kv drain cursor
        self._handoff_seq = 0   # prefill role: serve_kv publish cursor
        self._parts: Dict[str, int] = {}
        self._results: Dict[str, List[int]] = {}
        self._suppress: Dict[str, int] = {}  # rid -> tokens NOT to re-publish
        # Prefill role only: redriven requests' already-streamed prefixes,
        # forwarded through the handoff so the DECODE publisher (the one
        # that owns the client stream) suppresses them, not us.
        self._resume_info: Dict[str, Dict[str, Any]] = {}
        self._last_stats = 0.0

    # ------------------------------------------------------------ KV I/O
    def _kv(self):
        from ..runner import http_client
        return http_client

    def _kv_op(self, fn: Callable[[], Any], what: str) -> Any:
        """Bounded exp-backoff retry (common/util.backoff_delays) around
        one KV leg: a transient rendezvous outage mid-serve must stall
        the loop, not kill the worker.  Non-transient errors and an
        exhausted budget still raise — an unreachable fleet is a real
        failure, and the elastic driver owns it from there."""
        from ..common.util import backoff_delays
        from ..runner.http_client import _transient
        delays = backoff_delays(_KV_RETRIES, _KV_BACKOFF_MS)
        for attempt in range(len(delays) + 1):
            try:
                return fn()
            except Exception as e:
                if attempt >= len(delays) or not _transient(e):
                    raise
                time.sleep(delays[attempt])

    def _kv_get(self, scope: str, key: str, timeout: float = 0):
        kv = self._kv()
        return self._kv_op(
            lambda: kv.get_kv(self.addr, self.port, scope, key,
                              timeout=timeout),
            f"get {scope}/{key}")

    def _kv_put(self, scope: str, key: str, value: bytes) -> None:
        kv = self._kv()
        self._kv_op(
            lambda: kv.put_kv(self.addr, self.port, scope, key, value),
            f"put {scope}/{key}")

    def _drain_requests(self) -> List[Dict[str, Any]]:
        """Rank 0: consume newly-arrived requests in sequence order
        (dense router numbering -> nonblocking probes, no listing)."""
        reqs = []
        while True:
            raw = self._kv_get(self.req_scope, req_key(self._next_seq))
            if raw is None:
                return reqs
            try:
                reqs.append(json.loads(raw))
            except (ValueError, TypeError):
                reqs.append(None)  # torn PUT: hold the dense numbering
            self._next_seq += 1

    def _publish_plan(self, reqs: List[Dict[str, Any]],
                      stop: bool = False) -> None:
        payload = {"tick": self.tick, "epoch": self.epoch,
                   "stop": stop, "reqs": reqs}
        # Scheduling decisions live in the plan stream (docs/serving.md
        # #raw-speed): the engine's rolling digest covers every prefix
        # hit, chunk boundary, draft and CoW copy rank 0 has dispatched
        # so far, so followers prove their engines made the SAME
        # decisions, not just the same tokens.
        digest = getattr(self.engine, "sched_digest", None)
        if digest is not None:
            payload["sched"] = digest
        self._kv_put(self.plan_scope, plan_key(self.tick, self.epoch),
                     json.dumps(payload).encode())

    def _fetch_plan(self) -> Dict[str, Any]:
        # Rides _kv_get like every other serve KV leg (hvdlint
        # serve-kv-retry): a transient rendezvous blip during the
        # long-poll must stall this follower, not kill it — the
        # poll's own timeout still surfaces as the None below.
        raw = self._kv_get(self.plan_scope,
                           plan_key(self.tick, self.epoch),
                           timeout=self.plan_timeout_s)
        if raw is None:
            raise TimeoutError(
                f"rank {self.rank}: no plan "
                f"{plan_key(self.tick, self.epoch)} after "
                f"{self.plan_timeout_s:.0f}s — rank 0 gone?")
        plan = json.loads(raw)
        if int(plan.get("epoch", -1)) != self.epoch:
            # Belt-and-braces under the key namespace: a plan from
            # another incarnation must never drive this engine.
            raise ValueError(
                f"rank {self.rank}: stale plan epoch "
                f"{plan.get('epoch')!r} != {self.epoch} — refusing to "
                "replay a previous incarnation's plan stream")
        sched = plan.get("sched")
        mine = getattr(self.engine, "sched_digest", None)
        if sched is not None and mine is not None \
                and not plan.get("stop") and sched != mine:
            # Divergence is caught at the tick it happens — before this
            # rank dispatches another step off a forked schedule.
            raise ValueError(
                f"rank {self.rank}: lockstep divergence at "
                f"{plan_key(self.tick, self.epoch)} — local scheduling "
                f"digest {mine} != rank 0's {sched} (prefix/chunk/spec "
                "decisions disagree; serve/engine.py sched_digest)")
        return plan

    # ----------------------------------------------------------- redrive
    def resume_from_kv(self) -> List[Dict[str, Any]]:
        """Rank 0 at bring-up: resume the request stream a previous
        incarnation left behind.  With the journal on, returns the
        redrive list (unfinished requests annotated with their already-
        streamed prefix) and fast-forwards the request cursor past every
        journaled sequence number; with it off (degraded mode), only
        fast-forwards — orphaned streams time out at the router."""
        if not self.journal:
            seq = 0
            while self._kv_get(self.req_scope, req_key(seq)) is not None:
                seq += 1
            self._next_seq = seq
            return []
        from .journal import redrive_plan
        # journal.py stays replica-agnostic: the getter rewrites its
        # scope names into this replica's (serve/replica.py scoped()).
        entries, seq = redrive_plan(
            lambda scope, key: self._kv_get(
                scoped(scope, self.replica_id), key))
        self._next_seq = seq
        if entries and self.epoch > 0:
            # Epoch 0 is first bring-up: journal entries there are just
            # requests accepted before the fleet was ready, not replays.
            from ..utils import metrics as M
            M.SERVE_REDRIVES.inc(len(entries))
            # Redrive forensics: every log line that acts on a request
            # names its rid.
            rids = ", ".join(str(e.get("id")) for e in entries)
            print(f"[hvd.serve] rank 0 epoch {self.epoch}: redriving "
                  f"{len(entries)} journaled request(s) [{rids}] "
                  f"({sum(len(e['resume_emitted']) for e in entries)} "
                  "already-streamed tokens suppressed)", flush=True)
        return entries

    def _apply_resume(self, r: Dict[str, Any]) -> None:
        """Seed rank 0's publisher state for one redriven request: the
        emitted prefix is already on the client's wire, so publishing
        resumes at the next part with the regenerated suffix only."""
        emitted = r.get("resume_emitted")
        rid = r.get("id")
        if emitted is None or not rid:
            return
        self._results[rid] = [int(t) for t in emitted]
        self._parts[rid] = int(r.get("resume_part", 0))
        self._suppress[rid] = len(emitted)

    # ----------------------------------------------------------- outputs
    def _direct_send(self, record: Dict[str, Any]) -> bool:
        """Try the persistent direct stream (serve/stream.py;
        docs/control-plane.md#direct-streaming).  False = not delivered
        (direct off, or the connection is down and one reconnect
        failed) — the caller publishes via the KV instead, and the
        router's store sees the same keys either way."""
        if not self.direct or self.rank != 0:
            return False
        if self._dstream is None:
            from .stream import DirectTokenStream
            self._dstream = DirectTokenStream(self.addr, self.port)
        return self._dstream.send(record)

    def _publish_part(self, rid: str, part: int, toks: List[int]) -> None:
        rec = {"rid": rid, "part": part, "tokens": toks}
        if self.replica_id:
            rec["scope"] = self.out_scope
        if self._direct_send(rec):
            return
        self._kv_put(self.out_scope, f"{rid}.part.{part:06d}",
                     json.dumps({"tokens": toks}).encode())

    def _publish_done(self, rid: str, done: Dict[str, Any]) -> None:
        rec = {"rid": rid, "done": done}
        if self.replica_id:
            rec["scope"] = self.out_scope
        if self._direct_send(rec):
            return
        self._kv_put(self.out_scope, f"{rid}.done",
                     json.dumps(done).encode())

    def _publish_report(self, report: Dict[str, Any]) -> None:
        for rid, toks in report["emitted"].items():
            skip = self._suppress.get(rid, 0)
            if skip:
                # Redriven request: these tokens were streamed by the
                # previous incarnation (deterministic replay regenerates
                # them identically) — consume the suppression budget
                # instead of re-publishing.
                take = min(skip, len(toks))
                if take < skip:
                    self._suppress[rid] = skip - take
                else:
                    self._suppress.pop(rid, None)
                toks = toks[take:]
            if not toks:
                continue
            self._results.setdefault(rid, []).extend(toks)
            part = self._parts.get(rid, 0)
            self._publish_part(rid, part, toks)
            self._parts[rid] = part + 1
        for req in report["finished"]:
            if req.finish_reason == "prefill_done":
                # Prefill-role completion: the request's life continues
                # on the decode sub-fleet (via the serve_kv handoff) —
                # the decode side owns the client-facing .done.
                continue
            self._publish_done(req.req_id, {
                "done": True,
                "tokens": self._results.pop(req.req_id, []),
                "finish_reason": req.finish_reason,
                "ttft_s": req.ttft(),
                "tpot_s": req.tpot(),
                "timing": self._req_timing(req),
                "trace": getattr(req, "trace", None),
            })
            self._parts.pop(req.req_id, None)
            self._suppress.pop(req.req_id, None)

    @staticmethod
    def _req_timing(req) -> Dict[str, float]:
        """Engine-measured component durations for the router's SLO
        attribution (serve/trace.py ``attribute``): perf_counter stamps
        are process-local, so the done record ships DURATIONS.  Getattr-
        defensive — scripted test engines finish bare stubs without the
        Request timing fields."""
        sub = getattr(req, "submitted_t", None)
        adm = getattr(req, "admitted_t", None)
        ftt = getattr(req, "first_token_t", None)
        done = getattr(req, "done_t", None)
        up = getattr(req, "upstream", None) or {}
        t: Dict[str, float] = {}
        if up:
            # Disaggregated: the queue/prefill legs ran on the prefill
            # sub-fleet and rode the handoff record; the decode-side
            # import-to-admission wait belongs to the handoff leg.
            if up.get("queue_s") is not None:
                t["queue"] = max(0.0, float(up["queue_s"]))
            if up.get("prefill_s") is not None:
                t["prefill"] = max(0.0, float(up["prefill_s"]))
            hand = float(getattr(req, "handoff_s", 0.0) or 0.0)
            if sub is not None and adm is not None:
                hand += max(0.0, adm - sub)
            if hand > 0.0:
                t["handoff"] = hand
        else:
            if sub is not None and adm is not None:
                t["queue"] = max(0.0, adm - sub)
            if adm is not None and ftt is not None:
                t["prefill"] = max(0.0, ftt - adm)
        if ftt is not None and done is not None:
            t["decode"] = max(0.0, done - ftt)
        return t

    def _publish_stats(self, force: bool = False) -> None:
        now = time.monotonic()
        if not force and now - self._last_stats < _STATS_INTERVAL_S:
            return
        self._last_stats = now
        try:
            payload = dict(self.engine.stats(),
                           replica_id=self.replica_id)
            payload["queue_depth"] = int(payload.get("waiting", 0))
            fps = getattr(self.engine, "prefix_fps", None)
            if fps is not None:
                # Affinity piggyback (serve/replica.py): the router
                # learns this replica's radix-tree fingerprints from the
                # same heartbeat it already reads for liveness.
                fp_list, digest = fps()
                payload["prefix_fps"] = fp_list
                payload["replica_digest"] = digest
            self._kv_put(self.stats_scope, self._stats_key,
                         json.dumps(payload).encode())
        except Exception:
            if force:
                raise
            # periodic stats are best-effort; the next tick retries

    # ------------------------------------------------------------- drain
    def _drain_requested(self) -> bool:
        return self._kv_get(self.stats_scope, DRAIN_KEY) is not None

    def _publish_drained(self) -> None:
        """The ack POST /admin/drain waits on: final engine stats plus
        the completed count, written once everything accepted is done."""
        payload = dict(self.engine.stats(), epoch=self.epoch,
                       t=time.time())
        self._kv_put(self.stats_scope, self._drained_key,
                     json.dumps(payload).encode())

    # ----------------------------------------------------- replica/handoff
    def register_replica(self, info: Optional[Dict[str, Any]] = None) \
            -> None:
        """Rank 0 of a replicated fleet announces itself under the
        ``replicas`` scope so the router can discover and route to it
        (serve/replica.py).  Liveness afterwards is the stats heartbeat,
        not this one-shot registration."""
        payload = {"replica_id": self.replica_id, "epoch": self.epoch,
                   "nprocs": self.nprocs, "role": self.role}
        if info:
            payload.update(info)
        self._kv_put(REPLICA_SCOPE, replica_key(self.replica_id),
                     json.dumps(payload).encode())

    def _publish_handoffs(self, report: Dict[str, Any]) -> None:
        """Prefill-role rank 0: ship each finished prefill's prompt KV
        + first token to the decode sub-fleet via serve_kv (densely
        numbered, so the decode side drains with nonblocking probes)."""
        for h in report.get("handoff", []):
            info = self._resume_info.pop(h.get("req_id"), None)
            if info:
                h = dict(h, **info)
            key = f"handoff.{self._handoff_seq:06d}"
            rec = {"kind": "kvblock", "scope": self.kv_scope,
                   "key": key, "payload": h}
            if not self._direct_send(rec):
                self._kv_put(self.kv_scope, key,
                             json.dumps(h).encode())
            self._handoff_seq += 1

    def _drain_handoffs(self) -> List[Dict[str, Any]]:
        """Decode-role rank 0: consume prefill handoffs in sequence
        order; each becomes a plan entry every decode rank imports."""
        out = []
        while True:
            raw = self._kv_get(self.kv_scope,
                               f"handoff.{self._next_handoff:06d}")
            if raw is None:
                return out
            try:
                out.append({"handoff": json.loads(raw)})
            except (ValueError, TypeError):
                out.append(None)  # torn PUT: hold the dense numbering
            self._next_handoff += 1

    # -------------------------------------------------------------- loop
    def run(self, ttl_s: float = 0.0) -> int:
        """Serve until ``ttl_s`` elapses (0 = until interrupted), or a
        drain completes.  Rank 0 paces the fleet; followers block on the
        plan stream."""
        fleet = self.nprocs > 1 and bool(self.addr and self.port)
        solo_kv = self.nprocs == 1 and bool(self.addr and self.port)
        kv_backed = fleet or solo_kv
        carry: List[Dict[str, Any]] = []
        if self.rank == 0 and kv_backed and self.role != "decode":
            # Decode role never touches serve_req — redrive replays
            # through the prefill sub-fleet, which re-hands-off with the
            # resume prefix attached (byte-identical stream resumption).
            carry = self.resume_from_kv()
        t0 = time.monotonic()
        stop = False
        drain_t: Optional[float] = None
        drain_check_t = 0.0
        try:
            while True:
                # (the JAX loop ticks postmortem.record_step and
                # chaos.maybe_stall here: items 4.3 and 4.5)
                if self.rank == 0:
                    if drain_t is None and kv_backed and \
                            time.monotonic() >= drain_check_t:
                        drain_check_t = time.monotonic() + _DRAIN_POLL_S
                        if self._drain_requested():
                            drain_t = time.monotonic()
                            print("[hvd.serve] rank 0: drain requested "
                                  "— finishing in-flight work",
                                  flush=True)
                    if not kv_backed:
                        reqs = []
                    elif self.role == "decode":
                        # The decode sub-fleet's work arrives as prefill
                        # handoffs, not raw client requests.
                        reqs = self._drain_handoffs()
                    else:
                        reqs = self._drain_requests()
                    if carry:
                        reqs = carry + reqs
                        carry = []
                    done_serving = (
                        (bool(ttl_s)
                         and time.monotonic() - t0 >= ttl_s)
                        or drain_t is not None)
                    stop = bool(done_serving and not reqs
                                and not self.engine.has_work())
                    if drain_t is not None and not stop and \
                            time.monotonic() - drain_t >= \
                            self.drain_timeout_s:
                        # Degraded drain: the budget beats completeness
                        # so a preemption deadline is never missed.
                        print("[hvd.serve] rank 0: drain budget "
                              f"({self.drain_timeout_s:.0f}s) exhausted "
                              "with work in flight — stopping anyway",
                              flush=True)
                        stop = True
                    if fleet:
                        self._publish_plan(reqs, stop=stop)
                else:
                    plan = self._fetch_plan()
                    reqs, stop = plan["reqs"], plan["stop"]
                self.tick += 1
                if stop:
                    break
                for r in reqs:
                    if r is None:
                        continue
                    if "handoff" in r:
                        # Prefill->decode import: the prompt KV is in
                        # the payload; skips the admission queue.
                        h = r["handoff"]
                        if self.rank == 0 and kv_backed and \
                                h.get("resume_emitted") is not None:
                            self._apply_resume(
                                {"id": h.get("req_id"),
                                 "resume_emitted": h["resume_emitted"],
                                 "resume_part": h.get("resume_part", 0)})
                        self.engine.import_prefill(h)
                        continue
                    if self.rank == 0 and kv_backed:
                        self._apply_resume(r)
                        if self.role == "prefill" and \
                                r.get("resume_emitted") is not None:
                            self._resume_info[r["id"]] = {
                                "resume_emitted": r["resume_emitted"],
                                "resume_part": r.get("resume_part", 0)}
                    try:
                        req = self.engine.submit(r["tokens"],
                                                 r["max_new_tokens"],
                                                 req_id=r.get("id"),
                                                 eos_id=r.get("eos_id"))
                        # Guarded attach, not a submit kwarg: scripted
                        # test engines return None and predate trace.
                        if req is not None and r.get("trace") is not None:
                            req.trace = r["trace"]
                    except ValueError as e:
                        # invalid per the engine's limits: answer it so
                        # the router stream doesn't hang to timeout
                        if self.rank == 0 and r.get("id") and kv_backed:
                            self._publish_done(r["id"],
                                               {"done": True, "tokens": [],
                                                "error": str(e)})
                # (the JAX loop clocks chaos.step on the engine's tick
                # here: item 4.5)
                report = self.engine.step()
                if self.rank == 0 and kv_backed:
                    self._publish_report(report)
                    if self.role == "prefill":
                        self._publish_handoffs(report)
                    self._publish_stats()
                if not self.engine.has_work() and not reqs:
                    if self.rank == 0:
                        time.sleep(_IDLE_SLEEP_S)
        except KeyboardInterrupt:
            if self.rank == 0 and fleet:
                # release the followers blocked on the plan stream
                try:
                    self._publish_plan([], stop=True)
                except Exception:
                    pass
            raise
        if self._dstream is not None:
            # Orderly end of the direct stream: everything sent is
            # already stored router-side, so this only releases the
            # connection (a torn close loses nothing).
            self._dstream.close()
            self._dstream = None
        if self.rank == 0 and kv_backed:
            self._publish_stats(force=True)
            if drain_t is not None:
                self._publish_drained()
        return 0


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.serve.worker",
        description="Serving-fleet worker (started by "
                    "python -m horovod_tpu_torch.runner.launch --serve)")
    ap.add_argument("ckpt_dir", help="servable directory: serve.json + "
                                     "checkpoint (save_servable)")
    ap.add_argument("--ttl", type=float, default=0.0,
                    help="seconds to serve before a clean exit "
                         "(0 = until interrupted or drained)")
    ap.add_argument("--device", default=None,
                    help="serve on this device instead of cuda:<local "
                         "rank>; 'cpu' is the only way onto the CPU")
    args = ap.parse_args(argv)

    import horovod_tpu_torch as hvd
    rt = hvd.init(device=args.device)
    from .config import from_knobs
    from .engine import ServeEngine, load_servable
    scfg = from_knobs(rt.knobs)
    _, model_cfg, model = load_servable(args.ckpt_dir, device=rt.device)
    # The knob default (2048) may exceed a small model's max_seq; clamp
    # rather than fail: the model is the binding constraint.
    if scfg.max_seq_len > model_cfg.max_seq:
        import dataclasses
        scfg = dataclasses.replace(scfg, max_seq_len=model_cfg.max_seq)
    # Prefill/decode disaggregation (docs/serving.md#replicated-tier):
    # HOROVOD_SERVE_PREFILL_RANKS splits the fleet into two sub-fleets,
    # each with its own rank 0 and plan stream; the decode side owns the
    # client-facing output and stats scopes.
    pf = int(scfg.prefill_ranks)
    rank, size = hvd.rank(), hvd.size()
    if 0 < pf < size:
        if rank < pf:
            role, sub_rank, sub_n = "prefill", rank, pf
        else:
            role, sub_rank, sub_n = "decode", rank - pf, size - pf
    else:
        role, sub_rank, sub_n = "mixed", rank, size
    engine = ServeEngine(model, scfg, role=role, device=rt.device)
    epoch = int(rt.knobs["HOROVOD_ELASTIC_ROUND"])
    frontend = FleetFrontend(
        engine,
        rt.knobs["HOROVOD_RENDEZVOUS_ADDR"],
        rt.knobs["HOROVOD_RENDEZVOUS_PORT"],
        sub_rank, sub_n,
        epoch=epoch,
        journal=bool(rt.knobs["HOROVOD_SERVE_JOURNAL"]),
        drain_timeout_s=float(rt.knobs["HOROVOD_SERVE_DRAIN_TIMEOUT"]),
        direct=bool(rt.knobs["HOROVOD_SERVE_DIRECT"]),
        replica_id=scfg.replica_id, role=role)
    print(f"SERVE-READY rank {rank} epoch {epoch} "
          f"({type(model_cfg).__name__}, {model_cfg.dtype}, "
          f"{rt.device}, slots={scfg.max_slots}, "
          f"blocks={scfg.cache_blocks}x{scfg.block_size}, role={role}, "
          f"replica={scfg.replica_id}/{scfg.replicas})", flush=True)
    if sub_rank == 0 and frontend.addr and frontend.port:
        if scfg.replicas > 1 and role != "prefill":
            frontend.register_replica({"replicas": scfg.replicas,
                                       "block_size": scfg.block_size})
        frontend._publish_stats(force=True)  # readiness for the router
    try:
        rc = frontend.run(ttl_s=args.ttl)
        # the lockstep proof a reader of the fleet's output checks: every
        # rank of a sub-fleet ends on its rank 0's scheduling digest
        # (and the attention kernels' launch counts: serving runs the
        # plain attention over the gathered pool, as the JAX decode path
        # does, so they stay 0)
        from ..ops.flash_attention import LAUNCHES
        print(f"SERVE-DONE rank {rank} role {role} sub_rank {sub_rank} "
              f"ticks {engine.tick} sched_digest {engine.sched_digest} "
              f"launches {json.dumps(LAUNCHES)} "
              f"stats {json.dumps(engine.stats())}", flush=True)
        return rc
    except KeyboardInterrupt:
        return 130
    finally:
        engine.close()
        hvd.shutdown()


if __name__ == "__main__":
    sys.exit(main())
