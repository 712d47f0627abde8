"""The port of ``horovod_tpu/scenario/harness.py``: the same loop, rows
and report over the port's router, replica router, request trace and
watch plane.

Deterministic scenario replay: the generated trace driven through
the real serving control plane on a VIRTUAL clock (docs/scenarios.md).

The harness owns a tick loop (one tick = ``tick_ms`` of logical time =
one engine step) and replays the spec's event stream against:

  * the REAL router admission state (serve/router.py RouterState —
    watermark shedding with hysteresis, the journal depth contract);
  * an engine honoring the serve-engine contract: either the
    deterministic :class:`VirtualEngine` fleet model (no torch — the
    corpus/CI configuration) or the real continuous-batching
    :class:`~horovod_tpu_torch.serve.engine.ServeEngine` over llama-tiny
    (``engine: real``; :func:`make_engine_factory`), or any engine an
    ``engine_factory`` builds (``chip_smoke.py`` phase 20 replays on
    ``1b``);
  * the storm windows (scenario/storm.py): a kill window tears the
    engine down mid-flight and rebuilds it — the elastic reset round —
    after which every admitted-unfinished request is resubmitted and
    its already-delivered stream prefix suppressed (the journal-redrive
    semantics serve/worker.py proves on a real fleet); blackout windows
    buffer admissions or hold deliveries; stall windows freeze the
    fleet's completions while the clock runs;
  * the REAL watch plane (watch/series.py + watch/rules.py): fleet
    series are fed with virtual-clock timestamps and the alert engine
    evaluates on that same clock, so "did scenario X fire alert Y"
    is a deterministic boolean checked against ``expect_alerts``.

Everything is wall-clock-free (the ``scenario-determinism`` hvdlint
rule): latencies are tick arithmetic, so two runs of one spec produce
byte-identical SLO rows (:func:`rows_jsonl`) — the property the JAX
package's ``bench.py --scenario`` asserts before printing an artifact,
and ``chip_smoke.py`` phase 20 on the card.

CPU-virtual caveat: virtual-clock latencies measure QUEUEING and
SCHEDULING under the declared load — admission waves, storm recovery,
burst backlogs — not chip decode speed.  Rows are labeled accordingly.
"""

from __future__ import annotations

import bisect
import json
import math
from typing import Any, Callable, Dict, List, Optional

from . import storm as storm_mod
from .trace import events_digest, generate_events, rank_for

# Series families the harness feeds (virtual-clock timestamps, rank 0
# = the fleet aggregate; docs/scenarios.md#alerts).
QUEUE_DEPTH_FAMILY = "hvd_scenario_queue_depth"
ENGINE_UP_FAMILY = "hvd_scenario_engine_up"
SHED_FAMILY = "hvd_scenario_shed_total"
TTFT_P99_FAMILY = "hvd_scenario_ttft_p99_ms"
DELIVERED_FAMILY = "hvd_scenario_delivered_total"

# Lifecycle spans kept in the report (docs/serving.md#request-lifecycle);
# beyond the cap only the count grows — bounded reports, no silent drop.
SPAN_CAP = 256
REPLICAS_UP_FAMILY = "hvd_scenario_replicas_up"

# Watch-feed cadence in logical seconds: fine enough that a sub-second
# storm is visible to threshold rules, coarse enough to stay cheap.
WATCH_PERIOD_S = 0.25


def percentile(values: List[float], q: float) -> float:
    """Nearest-rank percentile — deterministic, no numpy."""
    if not values:
        return 0.0
    vs = sorted(values)
    idx = min(len(vs) - 1, max(0, int(math.ceil(q / 100.0 * len(vs))) - 1))
    return vs[idx]


# --------------------------------------------------------- virtual engine
class _VReq:
    __slots__ = ("req_id", "prompt", "max_new", "prefill_left", "done",
                 "base", "finish_reason")

    def __init__(self, req_id: str, prompt: List[int], max_new: int,
                 vocab: int):
        self.req_id = req_id
        self.prompt = prompt
        self.max_new = max_new
        self.prefill_left = len(prompt)
        self.done = 0
        self.base = sum(prompt) % vocab
        self.finish_reason = "length"


class VirtualEngine:
    """Deterministic continuous-batching fleet model honoring the
    serve-engine contract (submit/has_work/step/stats): FCFS slot
    admission, chunked prefill, one decode token per active request per
    tick under a shared token budget.  Emitted tokens are a pure
    function of (prompt, position) so a redriven request replays its
    exact stream — the greedy-decode determinism the real engine's
    journal redrive relies on, without torch."""

    def __init__(self, max_slots: int = 8, max_batch_tokens: int = 64,
                 prefill_chunk: int = 16, vocab: int = 256):
        self.max_slots = max_slots
        self.max_batch_tokens = max_batch_tokens
        self.prefill_chunk = prefill_chunk
        self.vocab = vocab
        self._queue: List[_VReq] = []
        self._active: List[_VReq] = []
        self._tick = 0
        self._tokens = 0

    def submit(self, tokens: List[int], max_new_tokens: int,
               req_id: Optional[str] = None,
               eos_id: Optional[int] = None) -> str:
        rid = req_id if req_id is not None else f"vreq-{self._tokens}"
        self._queue.append(_VReq(rid, list(tokens),
                                 int(max_new_tokens), self.vocab))
        return rid

    def queue_depth(self) -> int:
        return len(self._queue)

    def has_work(self) -> bool:
        return bool(self._queue or self._active)

    def step(self) -> Dict[str, Any]:
        self._tick += 1
        while self._queue and len(self._active) < self.max_slots:
            self._active.append(self._queue.pop(0))
        emitted: Dict[str, List[int]] = {}
        finished: List[_VReq] = []
        budget = self.max_batch_tokens
        for r in list(self._active):
            if budget <= 0:
                break
            if r.prefill_left > 0:
                take = min(self.prefill_chunk, r.prefill_left, budget)
                r.prefill_left -= take
                budget -= take
                continue
            tok = (r.base + r.done) % self.vocab
            r.done += 1
            budget -= 1
            emitted.setdefault(r.req_id, []).append(tok)
            if r.done >= r.max_new:
                finished.append(r)
                self._active.remove(r)
        used = self.max_batch_tokens - budget
        self._tokens += used
        return {"tick": self._tick, "processed": used,
                "emitted": emitted, "finished": finished}

    def stats(self) -> Dict[str, Any]:
        return {"tick": self._tick, "tokens": self._tokens,
                "queued": len(self._queue), "active": len(self._active)}

    def close(self) -> None:
        self._queue, self._active = [], []


def make_engine_factory(spec, device: Any = None) -> Callable[[], Any]:
    """Engine builder by spec: every storm restart calls it afresh (the
    elastic fleet's params are restored from the same checkpoint, so a
    rebuilt engine replays identical greedy streams).

    ``engine: real`` serves ``llama.CONFIGS["tiny"]`` on ``device`` (the
    runtime's, else the current CUDA device; ``"cpu"`` by request), its
    weights drawn once from a ``torch.Generator`` seeded 0 and kept on
    the device across rebuilds.  The JAX harness draws its weights from
    ``jax.random.PRNGKey(0)``, which torch cannot reproduce: a replay
    held to the JAX package's takes its weights through
    ``engine_factory`` (``llama.params_from_jax``)."""
    ec = dict(spec.engine_config)
    if spec.engine == "virtual":
        def build():
            return VirtualEngine(
                max_slots=ec.get("max_slots", 8),
                max_batch_tokens=ec.get("max_batch_tokens", 64),
                prefill_chunk=ec.get("prefill_chunk", 16),
                vocab=spec.vocab)
        return build

    model: List[Any] = []

    def build_real():
        import torch
        from .. import runtime
        from ..models import llama
        from ..serve.config import ServeConfig
        from ..serve.engine import ServeEngine
        cfg = llama.CONFIGS["tiny"]
        if spec.vocab > cfg.vocab:
            raise ValueError(
                f"scenario {spec.name}: vocab {spec.vocab} exceeds the "
                f"real engine's model vocab {cfg.vocab}")
        if not model:
            dev = runtime.resolve_device(device)
            model.append(llama.init(
                cfg, torch.Generator(device=dev).manual_seed(0),
                device=dev))
        scfg = ServeConfig(
            max_slots=ec.get("max_slots", 4),
            block_size=ec.get("block_size", 4),
            cache_blocks=ec.get("cache_blocks", 64),
            max_seq_len=ec.get("max_seq_len", 96),
            max_batch_tokens=ec.get("max_batch_tokens", 32),
            prefill_chunk=ec.get("prefill_chunk", 16))
        m = model[0]
        return ServeEngine(m, scfg, device=m.embed.table.device)
    return build_real


# ------------------------------------------------------------ watch sink
class _LocalWatch:
    """A private SeriesStore + AlertEngine pair with the spec's rules
    merged over the committed defaults — the same objects the rendezvous
    server's watch plane runs, minus the HTTP server around them."""

    def __init__(self, rules_doc: List[Dict[str, Any]],
                 resolution_s: float):
        from ..watch.rules import AlertEngine, parse_rules
        from ..watch.series import SeriesStore
        self.store = SeriesStore(retention_s=3600.0,
                                 resolution_s=resolution_s)
        self.engine = AlertEngine(self.store, parse_rules(rules_doc))


# --------------------------------------------------------------- harness
class ScenarioHarness:
    """Replay one ScenarioSpec; ``run()`` returns the report dict
    (canonical SLO rows via :func:`canonical_rows`)."""

    def __init__(self, spec, *, watch: Any = None,
                 engine_factory: Optional[Callable[[], Any]] = None,
                 virtual_ranks: Optional[int] = None):
        self.spec = spec
        self.nranks = virtual_ranks or spec.virtual_ranks
        self._factory = engine_factory or make_engine_factory(spec)
        # watch: anything with .store/.engine (the server's WatchState,
        # or the private pair).  The private pair aligns its series
        # resolution to the watch cadence so every fed point lands.
        self.watch = watch if watch is not None else _LocalWatch(
            spec.alert_rules, WATCH_PERIOD_S)

    # ------------------------------------------------------------- replay
    def run(self) -> Dict[str, Any]:
        spec = self.spec
        tick_s = spec.tick_s
        events = generate_events(spec.seed, spec.phases, spec.vocab)
        digest = events_digest(events)
        wins = storm_mod.windows(spec.storm, tick_s, spec.kv_shards)
        horizon_ticks = max(1, int(round(spec.horizon_s / tick_s)))
        # bounded drain: storms and bursts may push completions past the
        # horizon; a spec that cannot drain in 3x + slack is a failure
        # the report records, never a hang.
        max_ticks = horizon_ticks * 3 + 2048
        from ..serve.router import RouterState
        router = RouterState(shed_high=spec.shed_high or None,
                             shed_low=spec.shed_low or None,
                             journal=False)
        # Replicated serving tier (docs/serving.md#replicated-tier):
        # N engines behind ONE admission state, placed by the REAL
        # prefix-affinity router on the virtual clock.  replicas == 1
        # runs the exact single-fleet path.
        replicas = int(getattr(spec, "replicas", 1) or 1)
        engines: List[Any] = [self._factory() for _ in range(replicas)]
        rr = None
        adv: List[set] = [set() for _ in range(replicas)]
        redispatched = 0
        if replicas > 1:
            from ..serve.replica import ReplicaRouter, prompt_fingerprints
            # Liveness here is the harness's outage windows (passed as
            # `exclude`), not heartbeat staleness — dead_after_s is
            # effectively off so live() stays the full registry.
            rr = ReplicaRouter(
                block_size=spec.engine_config.get("block_size", 4),
                affinity=True, dead_after_s=1e12)
            for r in range(replicas):
                rr.register(r, {"replicas": replicas}, now=0.0)
        arrivals = [e for e in events if e["kind"] == "arrive"]
        trains = [e for e in events if e["kind"] == "train"]
        recs: Dict[str, Dict[str, Any]] = {}
        admitted: List[str] = []          # the journal: admission order
        unfinished: Dict[str, bool] = {}
        replay_skip: Dict[str, int] = {}  # redrive prefix suppression
        buffered: List[Dict[str, Any]] = []
        transit: List[Any] = []           # (rid, tok) held deliveries
        delivery_ticks: List[int] = []
        shed = 0
        trains_done = 0
        restarts = 0
        delivered_total = 0
        ttft_ms_done: List[float] = []   # client-perceived, as completed
        watch_every = max(1, int(round(WATCH_PERIOD_S / tick_s)))
        ai = ti = 0
        tick = 0
        per_rank: List[int] = [0] * self.nranks
        # Virtual-clock lifecycle spans with the REAL deterministic ids
        # (serve/trace.py is clock/RNG-free, so importing it keeps the
        # scenario-determinism contract): a replay with the same seed
        # emits byte-identical spans, and the ids MATCH what a live
        # fleet serving the same rids would put in the merged timeline.
        from ..serve import trace as trace_mod
        spans: List[Dict[str, Any]] = []
        span_total = 0

        def span(hop: str, rid: str, start_s: float,
                 dur_s: float) -> None:
            nonlocal span_total
            span_total += 1
            if len(spans) >= SPAN_CAP:
                return  # bounded report; span_total records the drop
            rec = {"name": hop, "lane": "scenario",
                   "ts_s": round(start_s, 9), "dur_s": round(dur_s, 9)}
            rec.update(trace_mod.span_args(trace_mod.mint(rid), hop))
            spans.append(rec)

        def deliver(rid: str, tok: int) -> None:
            nonlocal delivered_total
            rec = recs[rid]
            rec["delivered"] += 1
            delivered_total += 1
            if rec["first_tick"] < 0:
                rec["first_tick"] = tick
                ttft_ms_done.append(
                    (tick * tick_s - rec["arrive_t"]) * 1000.0)
                start = max(0, rec["submit_tick"]) * tick_s
                span("PREFILL", rid, start, tick * tick_s - start)
            rec["last_tick"] = tick
            if not delivery_ticks or delivery_ticks[-1] != tick:
                delivery_ticks.append(tick)
            if rec["delivered"] >= rec["max_new"]:
                rec["finished"] = True
                unfinished.pop(rid, None)
                router.finish_stream()
                start = max(0, rec["first_tick"]) * tick_s
                span("DECODE", rid, start, tick * tick_s - start)

        def _qdepth(e) -> int:
            if e is None:
                return 0
            fn = getattr(e, "queue_depth", None)
            if callable(fn):
                return int(fn())
            return int(e.stats().get("waiting", 0))

        def _down() -> List[int]:
            return [r for r in range(replicas) if engines[r] is None]

        def try_admit(ev: Dict[str, Any]) -> None:
            nonlocal shed
            rid = ev["req"]
            rec = recs[rid]
            if router.try_claim() is None:
                rec["shed"] = True
                shed += 1
                return
            rec["submit_tick"] = tick
            admitted.append(rid)
            unfinished[rid] = True
            span("ROUTE", rid, tick * tick_s, 0.0)
            if replicas == 1:
                if engines[0] is not None:
                    engines[0].submit(list(ev["prompt"]), ev["max_new"],
                                      req_id=rid)
                return
            placed = rr.route(list(ev["prompt"]), tick * tick_s,
                              exclude=_down())
            if placed is None:
                # whole tier down: parked on replica 0; the restart
                # redrive resubmits it
                rec["replica"] = 0
                return
            r, depth = placed
            rec["replica"] = r
            rec["affinity_blocks"] = depth
            engines[r].submit(list(ev["prompt"]), ev["max_new"],
                              req_id=rid)
            # Replica r's radix tree now holds this prompt: advertise
            # its block fingerprints, like the real stats piggyback
            # (serve/worker.py _publish_stats).
            adv[r].update(prompt_fingerprints(list(ev["prompt"]),
                                              rr.block_size))
            rr.update(r, {"prefix_fps": sorted(adv[r]),
                          "queue_depth": _qdepth(engines[r])},
                      now=tick * tick_s)

        def outage_now(r: int, tick_: int) -> bool:
            for w in wins:
                if w.kind == "outage" \
                        and w.start_tick <= tick_ < w.end_tick \
                        and w.event.replica in (-1, r):
                    return True
            return False

        while tick < max_ticks:
            now = tick * tick_s
            down_now = [outage_now(r, tick) for r in range(replicas)]
            in_outage = any(down_now)
            stalled = storm_mod.active(wins, tick, "stall")
            adm_black = storm_mod.active(wins, tick, "blackout",
                                         "admission")
            dlv_black = storm_mod.active(wins, tick, "blackout",
                                         "delivery")
            for r in range(replicas):
                if down_now[r] and engines[r] is not None:
                    # the kill: replica down, in-flight engine state lost
                    engines[r].close()
                    engines[r] = None
                    if replicas > 1:
                        # Router-side re-dispatch (serve/router.py
                        # _redispatch): the dead replica's unfinished
                        # streams move to a survivor, already-delivered
                        # prefixes suppressed.
                        for rid in admitted:
                            rec = recs[rid]
                            if rec.get("replica") != r \
                                    or rec["finished"] or rec["shed"]:
                                continue
                            placed = rr.route(list(rec["prompt"]), now,
                                              exclude=_down())
                            if placed is None:
                                continue  # no survivor: restart redrives
                            new_r = placed[0]
                            rr.note_redispatch()
                            redispatched += 1
                            span("REDISPATCH", rid, now, 0.0)
                            rec["replica"] = new_r
                            replay_skip[rid] = rec["delivered"]
                            engines[new_r].submit(list(rec["prompt"]),
                                                  rec["max_new"],
                                                  req_id=rid)
                if not down_now[r] and engines[r] is None:
                    # elastic restart + journal redrive: resubmit every
                    # admitted-unfinished request this replica still
                    # owns, in admission order; the already-delivered
                    # stream prefix is suppressed so the client stream
                    # stays byte-identical.
                    engines[r] = self._factory()
                    restarts += 1
                    for rid in admitted:
                        rec = recs[rid]
                        if rec["finished"] or rec["shed"]:
                            continue
                        if replicas > 1 and rec.get("replica") != r:
                            continue
                        replay_skip[rid] = rec["delivered"]
                        engines[r].submit(list(rec["prompt"]),
                                          rec["max_new"], req_id=rid)
            while ai < len(arrivals) and arrivals[ai]["t"] <= now:
                ev = arrivals[ai]
                rid = ev["req"]
                recs[rid] = {
                    "arrive_t": ev["t"], "phase": ev["phase"],
                    "group": ev["group"], "prompt": ev["prompt"],
                    "prompt_len": len(ev["prompt"]),
                    "max_new": ev["max_new"], "submit_tick": -1,
                    "first_tick": -1, "last_tick": -1, "delivered": 0,
                    "finished": False, "shed": False,
                    "rank": rank_for(ai, self.nranks)}
                per_rank[recs[rid]["rank"]] += 1
                if adm_black:
                    buffered.append(ev)
                else:
                    try_admit(ev)
                ai += 1
            if not adm_black and buffered:
                for ev in buffered:
                    try_admit(ev)
                buffered = []
            if not dlv_black and transit:
                for rid, tok in transit:
                    deliver(rid, tok)
                transit = []
            train_due = ti < len(trains) and trains[ti]["t"] <= now
            up_count = sum(1 for e in engines if e is not None)
            if up_count and not stalled:
                if train_due:
                    # mixed fleets time-slice: this tick is the train
                    # step's, serving waits
                    ti += 1
                    trains_done += 1
                else:
                    for eng in engines:
                        if eng is None or not eng.has_work():
                            continue
                        rep = eng.step()
                        for rid in sorted(rep["emitted"]):
                            for tok in rep["emitted"][rid]:
                                if replay_skip.get(rid, 0) > 0:
                                    replay_skip[rid] -= 1
                                    continue
                                if dlv_black:
                                    transit.append((rid, tok))
                                else:
                                    deliver(rid, tok)
            if tick % watch_every == 0:
                self._feed(now, len(unfinished) + len(buffered),
                           up_count > 0, shed, ttft_ms_done,
                           delivered_total, up_count)
            tick += 1
            if tick >= horizon_ticks and ai >= len(arrivals) \
                    and ti >= len(trains) and not buffered \
                    and not transit and not unfinished \
                    and not in_outage:
                break
        final_now = tick * tick_s
        up_count = sum(1 for e in engines if e is not None)
        self._feed(final_now, len(unfinished) + len(buffered),
                   up_count > 0, shed, ttft_ms_done,
                   delivered_total, up_count)
        for eng in engines:
            if eng is not None:
                eng.close()
        return self._report(events, digest, wins, recs, admitted,
                            delivery_ticks, shed, trains_done, restarts,
                            tick, len(unfinished) + len(buffered),
                            per_rank, final_now, rr=rr,
                            redispatched=redispatched,
                            spans=spans, span_total=span_total)

    # --------------------------------------------------------- watch feed
    def _feed(self, now: float, depth: int, up: bool, shed: int,
              ttft_ms_done: List[float], delivered: int,
              up_count: Optional[int] = None) -> None:
        store, engine = self.watch.store, self.watch.engine
        store.add(0, QUEUE_DEPTH_FAMILY, now, float(depth))
        store.add(0, ENGINE_UP_FAMILY, now, 1.0 if up else 0.0)
        store.add(0, SHED_FAMILY, now, float(shed))
        store.add(0, TTFT_P99_FAMILY, now, percentile(ttft_ms_done, 99))
        store.add(0, DELIVERED_FAMILY, now, float(delivered))
        store.add(0, REPLICAS_UP_FAMILY, now,
                  float(up_count if up_count is not None
                        else (1 if up else 0)))
        engine.evaluate(now)

    # ------------------------------------------------------------- report
    def _report(self, events, digest, wins, recs, admitted,
                delivery_ticks, shed, trains_done, restarts, ticks,
                backlog, per_rank, final_now, rr=None,
                redispatched=0, spans=None,
                span_total=0) -> Dict[str, Any]:
        spec = self.spec
        tick_s = spec.tick_s
        done = [r for r in recs.values() if r["finished"]]
        ttfts = [r["first_tick"] * tick_s - r["arrive_t"] for r in done]
        tpots = [(r["last_tick"] - r["first_tick"]) * tick_s
                 / (r["delivered"] - 1)
                 for r in done if r["delivered"] > 1]
        phases: Dict[str, Dict[str, Any]] = {}
        for p in spec.phases:
            sub = [r for r in done if r["phase"] == p["name"]]
            sub_t = [r["first_tick"] * tick_s - r["arrive_t"]
                     for r in sub]
            phases[p["name"]] = {
                "completed": len(sub),
                "ttft_p50_s": round(percentile(sub_t, 50), 6),
                "ttft_p99_s": round(percentile(sub_t, 99), 6),
            }
        storms = []
        for w in wins:
            rec_tick = None
            i = bisect.bisect_left(delivery_ticks, w.end_tick)
            if i < len(delivery_ticks):
                rec_tick = delivery_ticks[i]
            recovery = (rec_tick * tick_s - w.at_s) \
                if rec_tick is not None else final_now - w.at_s
            storms.append({
                "kind": w.event.kind, "window": w.kind,
                "at_s": round(w.at_s, 6),
                "down_s": round((w.end_tick - w.start_tick) * tick_s, 6),
                "recovered": rec_tick is not None,
                "recovery_s": round(recovery, 6)})
        fired = sorted({f["rule"] for f in
                        self.watch.engine.fired_total()
                        if f["count"] > 0})
        missing = [r for r in spec.expect_alerts if r not in fired]
        delivered = sum(r["delivered"] for r in recs.values())
        replica_tier = None
        if rr is not None:
            replica_tier = rr.counters()
            replica_tier["redispatched_streams"] = redispatched
        return {
            "name": spec.name, "seed": spec.seed,
            "virtual_ranks": self.nranks, "tick_ms": spec.tick_ms,
            "engine": spec.engine, "ticks": ticks,
            "horizon_s": round(spec.horizon_s, 6),
            "events": len(events), "digest": digest,
            "requests": {
                "arrived": len(recs), "completed": len(done),
                "shed": shed, "backlog": backlog,
                "delivered_tokens": delivered,
                "train_steps": trains_done,
            },
            "per_rank": {
                "ranks": self.nranks,
                "max_requests": max(per_rank) if per_rank else 0,
                "min_requests": min(per_rank) if per_rank else 0,
            },
            "slo": {
                "ttft_p50_s": round(percentile(ttfts, 50), 6),
                "ttft_p99_s": round(percentile(ttfts, 99), 6),
                "tpot_p50_s": round(percentile(tpots, 50), 6),
                "tpot_p99_s": round(percentile(tpots, 99), 6),
                "throughput_tok_s": round(
                    delivered / max(final_now, tick_s), 3),
            },
            "phases": phases,
            "storms": storms,
            "restarts": restarts,
            "alerts": {"fired": fired,
                       "expected": list(spec.expect_alerts),
                       "missing": missing,
                       "ok": not missing},
            **({"replica_tier": replica_tier} if replica_tier else {}),
            "trace_spans": {"emitted": span_total, "cap": SPAN_CAP,
                            "spans": list(spans or [])},
        }


# ---------------------------------------------------------- gate rows
def canonical_rows(report: Dict[str, Any]) -> List[Dict[str, Any]]:
    """The per-scenario SLO rows ``bench.py --scenario`` emits as
    ``sub_rows`` (perf/gate.py expands them into standalone baseline
    keys).  Values are virtual-clock — queueing/scheduling/recovery
    under the declared load, byte-identical across runs of one spec."""
    name = report["name"]
    slo = report["slo"]
    req = report["requests"]
    detail = (f"{req['completed']}/{req['arrived']} reqs, "
              f"{report['virtual_ranks']} vranks, seed "
              f"{report['seed']}; virtual clock")
    rows = [
        {"metric": f"scenario {name} ttft p99 ({detail})",
         "value": round(slo["ttft_p99_s"] * 1000.0, 3), "unit": "ms",
         "higher_is_better": False},
        {"metric": f"scenario {name} tpot p99 ({detail})",
         "value": round(slo["tpot_p99_s"] * 1000.0, 3), "unit": "ms",
         "higher_is_better": False},
        {"metric": f"scenario {name} throughput ({detail})",
         "value": slo["throughput_tok_s"], "unit": "tokens/sec",
         "higher_is_better": True},
    ]
    storms = [s for s in report["storms"] if s["window"] == "outage"]
    if storms:
        worst = max(s["recovery_s"] for s in storms)
        rows.append(
            {"metric": f"scenario {name} storm recovery max "
                       f"({len(storms)} outage(s); virtual clock)",
             "value": round(worst, 4), "unit": "seconds",
             "higher_is_better": False})
    tier = report.get("replica_tier")
    if tier:
        rows.append(
            {"metric": f"scenario {name} replica affinity hit rate "
                       f"({tier['replicas']} replicas, "
                       f"{tier['redispatched_streams']} re-dispatched)",
             "value": tier.get("affinity_hit_rate") or 0.0,
             "unit": "ratio", "higher_is_better": True})
    return rows


def rows_jsonl(rows: List[Dict[str, Any]]) -> str:
    """Canonical bytes of the SLO rows — the run-to-run identity unit."""
    return "".join(json.dumps(r, sort_keys=True, separators=(",", ":"))
                   + "\n" for r in rows)
