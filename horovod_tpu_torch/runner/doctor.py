"""``launch doctor``: the port of ``horovod_tpu/runner/doctor.py``, the
human end of the perf plane and of the serving fleet's views.

``--perf SOURCE`` renders the perf-attribution plane: SOURCE is a ``GET
/perf`` URL (or ``host:port``), a saved /perf JSON, or a directory holding
``perf.json`` (a saved single-rank ``hvd.perf_report()`` is wrapped into
a one-rank view), bottleneck verdict first, then the per-rank step-time
decomposition, model drift, the memory plane's measured-vs-predicted
table, the ZeRO what-if and layout tables, and the top native ops.

``--serve SOURCE`` renders the serving fleet's operational view (the
``GET /serve/stats`` payload), and ``--request RID SOURCE`` one request's
lifecycle from ``GET /serve/trace`` (or a saved payload): status and the
worst component, the attribution that sums to the wall time, placement
attempts, and the deterministic span ids.

The texts are the JAX doctor's, byte for byte, for the same views.  The
postmortem path (``doctor DIR``) and ``--watch`` render what the
postmortem and watch planes write; the port has neither yet (ROADMAP
queue 1 item 4.3), so they exit 2 naming it.

Usage:
  python -m horovod_tpu_torch.runner.launch doctor --perf http://127.0.0.1:8080/perf
  python -m horovod_tpu_torch.runner.launch doctor --perf saved_perf.json
  python -m horovod_tpu_torch.runner.launch doctor --serve http://127.0.0.1:9000/serve/stats
  python -m horovod_tpu_torch.runner.launch doctor --request req.000003 http://127.0.0.1:9000
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Optional


# ------------------------------------------------------------ perf plane
def _fmt_ms(v: Any) -> str:
    if not isinstance(v, (int, float)):
        return "?"
    if v >= 1.0:
        return f"{v:.3f}s"
    return f"{v * 1e3:.2f}ms"


def _fmt_bytes(v: Any) -> str:
    if not isinstance(v, (int, float)):
        return "?"
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(v) < 1024.0 or unit == "GiB":
            return f"{v:.1f}{unit}" if unit != "B" else f"{int(v)}B"
        v /= 1024.0
    return f"{v:.1f}GiB"


def load_perf_view(source: str) -> Dict[str, Any]:
    """Resolve a ``--perf`` argument to the merged /perf payload: an
    http URL or bare host:port fetches the live route; a directory reads
    its ``perf.json``; anything else is a saved JSON file.  A saved
    single-rank report (``hvd.perf_report()`` output) is wrapped into a
    one-rank fleet view so both forms render."""
    import json as _json
    import os
    import urllib.request
    if source.startswith(("http://", "https://")) or (
            ":" in source and not os.path.exists(source)
            and "/" not in source):
        url = source if source.startswith("http") else f"http://{source}"
        if not url.rstrip("/").endswith("/perf"):
            url = url.rstrip("/") + "/perf"
        with urllib.request.urlopen(url, timeout=10) as resp:
            view = _json.loads(resp.read())
    else:
        path = source
        if os.path.isdir(path):
            path = os.path.join(path, "perf.json")
        with open(path) as f:
            view = _json.load(f)
    if "ranks" not in view or "fleet" not in view:
        # single-rank hvd.perf_report() payload: wrap it
        rank = str(view.get("rank", 0))
        from ..perf.ledger import merge_perf_reports
        view = merge_perf_reports({f"rank.{rank}":
                                   _json.dumps(view).encode()})
    return view


def _render_perf_memory(fleet: Dict[str, Any], ranks: Dict[str, Any]
                        ) -> List[str]:
    """The MEMORY block of ``render_perf``: measured residency vs the
    zero_memory_bytes prediction per rank, the fleet's worst watermark,
    and one rank's per-plane attribution table (docs/memory.md).  Empty
    when no rank carries a ``memory`` section (HOROVOD_MEM=0 or a
    payload that predates the plane)."""
    mem_ranks = [(r, ranks[r]["memory"]) for r in sorted(ranks)
                 if isinstance(ranks[r].get("memory"), dict)]
    if not mem_ranks:
        return []
    lines: List[str] = [""]
    lines.append("-- MEMORY: measured residency vs zero_memory_bytes "
                 "prediction (docs/memory.md) --")
    fmem = fleet.get("memory") or {}
    worst = fmem.get("worst_watermark") or {}
    if worst.get("watermark") is not None:
        lines.append(
            f"  fleet: {_fmt_bytes(fmem.get('bytes_in_use_total'))} "
            f"in use; worst watermark rank {worst.get('rank')} at "
            f"{worst.get('watermark'):.1%} "
            f"(headroom {_fmt_bytes(worst.get('headroom_bytes'))})")
    for r, m in mem_ranks:
        meas = m.get("measured", {})
        drift = m.get("model_drift_ratio")
        cap = meas.get("cap_bytes")
        wm = meas.get("watermark")
        lines.append(
            f"  rank {r} [{m.get('source', '?')}]: "
            f"{_fmt_bytes(meas.get('bytes_in_use'))} in use "
            f"(peak {_fmt_bytes(meas.get('peak_bytes_in_use'))}, "
            f"host RSS {_fmt_bytes(meas.get('host_rss_bytes'))})"
            + (f", cap {_fmt_bytes(cap)} @ {wm:.1%}"
               if cap and wm is not None else ", no cap (CPU-virtual)")
            + (f", drift {drift:.2f}x" if drift is not None else "")
            + (f", {m['pressure_events']} pressure event(s)"
               if m.get("pressure_events") else ""))
    # The per-plane table is per-rank attribution; one rank's view is
    # rendered — the worst-watermark rank when known, else the first
    # carrier (training-state planes are symmetric under ZeRO's equal
    # shards; kv_pool/native differ only in the tails).
    pick = str(worst.get("rank")) if str(worst.get("rank")) in \
        dict(mem_ranks) else mem_ranks[0][0]
    table = dict(mem_ranks)[pick].get("planes") or {}
    if table:
        lines.append(f"  per-plane (rank {pick}): "
                     "plane        predicted    attributed")
        for plane, row in table.items():
            pred = row.get("predicted_bytes")
            lines.append(
                f"    {plane:<12} "
                f"{_fmt_bytes(pred) if pred is not None else '-':<12} "
                f"{_fmt_bytes(row.get('attributed_bytes'))}")
    return lines


def render_perf(view: Dict[str, Any]) -> str:
    """Bottleneck-verdict-first text rendering of one merged /perf view
    (the same numbers GET /perf serves — docs/profiling.md)."""
    lines: List[str] = []
    fleet = view.get("fleet", {})
    ranks = view.get("ranks", {})
    lines.append(f"== hvdrun doctor --perf: step-time attribution "
                 f"({len(ranks)} rank(s)) ==")
    verdict = fleet.get("verdict")
    if verdict is None:
        lines.append("BOTTLENECK: no perf reports recorded — enable "
                     "HOROVOD_PERF and record steps with "
                     "hvd.perf.timed_step() (docs/profiling.md)")
        # A serving fleet or an early run can carry memory samples with
        # no recorded steps — the residency table still renders.
        lines.extend(_render_perf_memory(fleet, ranks))
        return "\n".join(lines)
    if verdict == "straggler-bound":
        s = fleet.get("straggler", {})
        lines.append(
            f"BOTTLENECK: straggler-bound — rank {s.get('rank')} at "
            f"{_fmt_ms(s.get('step_time_s'))}/step vs peer median "
            f"{_fmt_ms(s.get('peer_median_s'))}")
    else:
        d = fleet.get("decomposition", {})
        total = sum(v for v in d.values()
                    if isinstance(v, (int, float))) or 1.0
        split = " | ".join(
            f"{k[:-2].replace('_', '-')} {100.0 * v / total:.0f}%"
            for k, v in d.items())
        lines.append(f"BOTTLENECK: {verdict} (fleet mean decomposition: "
                     f"{split})")
    lines.append("")
    lines.append("Per-rank decomposition (mean seconds/step; components "
                 "sum to the measured step):")
    for r in sorted(ranks, key=lambda x: int(x) if x.isdigit() else 0):
        rep = ranks[r]
        d = rep.get("decomposition", {})
        st = rep.get("step_time_s", {}).get("mean")
        lines.append(
            f"  rank {r}: step {_fmt_ms(st)} = "
            f"compute {_fmt_ms(d.get('compute_s'))} + "
            f"comm {_fmt_ms(d.get('exposed_comm_s'))} + "
            f"input {_fmt_ms(d.get('host_input_s'))} + "
            f"stall {_fmt_ms(d.get('stall_s'))}  "
            f"[{rep.get('verdict', '?')}, {rep.get('steps', 0)} steps]")
    drifts = [(r, ranks[r].get("model_drift_ratio")) for r in sorted(ranks)
              if ranks[r].get("model_drift_ratio") is not None]
    if drifts:
        lines.append("")
        lines.append("Cost-model drift (modeled/measured; 1.0 = exact): "
                     + ", ".join(f"rank {r} {v:.2f}x" for r, v in drifts))
    # Memory plane (docs/memory.md) — absent on payloads from ranks that
    # predate it or run with HOROVOD_MEM=0.
    lines.extend(_render_perf_memory(fleet, ranks))
    # ZeRO what-if table (docs/zero.md): one rank's view suffices — the
    # table is an analytical function of (workload, topology), identical
    # on every rank; render the first rank that carries it.
    for r in sorted(ranks):
        zero = ranks[r].get("zero")
        if not zero:
            continue
        active = zero.get("active_level")
        lines.append("")
        lines.append(f"-- ZeRO memory-vs-comm what-if (active level: "
                     f"{active if active is not None else '?'}; "
                     "per-rank analytical, docs/zero.md) --")
        lines.append("  level  params      grads       opt-state   "
                     "wire-bytes/step  exposed-comm")
        for row in zero.get("levels", []):
            mem = row.get("memory", {})
            mark = "*" if row.get("level") == active else " "
            lines.append(
                f"  {mark}{row.get('level')}     "
                f"{_fmt_bytes(mem.get('params_bytes')):<11} "
                f"{_fmt_bytes(mem.get('grads_bytes')):<11} "
                f"{_fmt_bytes(mem.get('opt_state_bytes')):<11} "
                f"{_fmt_bytes(row.get('comm', {}).get('total_bytes')):<16} "
                f"{_fmt_ms(row.get('exposed_comm_s'))}")
        break
    # Layout solver table (docs/parallelism.md): like the ZeRO table an
    # analytical function of (workload, topology) — first rank carrying
    # it renders the ranked candidates and the active row's drift.
    for r in sorted(ranks):
        lay = ranks[r].get("layout")
        if not lay:
            continue
        lines.extend(_render_perf_layout(lay))
        break
    for r in sorted(ranks):
        ops = ranks[r].get("native_ops")
        if not ops:
            continue
        lines.append("")
        lines.append(f"-- rank {r} native ops (enqueue->done) --")
        for op in ops[:5]:
            lines.append(
                f"  {op.get('name')}: n={op.get('count')} "
                f"mean={op.get('mean_us', 0):.0f}us "
                f"max={op.get('max_us')}us bytes={op.get('bytes')}")
    return "\n".join(lines)


def _render_perf_layout(lay: Dict[str, Any]) -> List[str]:
    """The 3D-layout candidate table of one rank's layout section
    (docs/parallelism.md): rank-ordered (dp, tp, pp) factorizations with
    predicted step / bubble / per-chip memory, the memory cap, and the
    active row's predicted-vs-measured drift."""
    lines: List[str] = [""]
    chosen = lay.get("chosen") or {}
    cl = chosen.get("layout", {})
    cap = lay.get("mem_cap_bytes")
    lines.append(
        f"-- layout solver ({lay.get('n_candidates')} candidates at "
        f"world={lay.get('world')}; cap "
        f"{_fmt_bytes(cap) if cap else 'none'}; "
        "docs/parallelism.md) --")
    active = lay.get("active") or {}
    al = active.get("layout", {})
    lines.append("  rank  dp x tp x pp  zero  wire    bubble  "
                 "step(pred)  mem/chip  fits")
    for row in lay.get("candidates", [])[:8]:
        l = row.get("layout", {})
        is_active = l and l == al
        mark = "*" if is_active else ("+" if l == cl else " ")
        lines.append(
            f"  {mark}{row.get('rank'):<4} "
            f"{l.get('dp')} x {l.get('tp')} x {l.get('pp')}       "
            f"{row.get('zero_level')}     "
            f"{str(row.get('wire_format')):<7} "
            f"{row.get('bubble_fraction', 0.0):.2f}    "
            f"{_fmt_ms(row.get('step_s')):<11} "
            f"{_fmt_bytes(row.get('memory', {}).get('total_bytes')):<9} "
            f"{'yes' if row.get('fits', True) else 'NO'}")
    if lay.get("candidates_truncated"):
        lines.append(f"  ... ({lay.get('n_candidates')} total; "
                     "GET /perf serves the full table)")
    pvm = lay.get("predicted_vs_measured")
    if pvm and pvm.get("step_ratio") is not None:
        which = "active" if active else "chosen"
        lines.append(
            f"  {which} layout predicted/measured step ratio: "
            f"{pvm['step_ratio']:.2f}x "
            "(drift bound proven by bench --layout; CPU-virtual "
            "numbers are NOT TPU predictions)")
    return lines


# ----------------------------------------------------------- serve plane
def load_serve_view(source: str) -> Dict[str, Any]:
    """Resolve a ``--serve`` argument to the /serve/stats payload: an
    http URL or bare host:port fetches the live route; anything else is
    a saved JSON file."""
    import json as _json
    import os
    import urllib.request
    if source.startswith(("http://", "https://")) or (
            ":" in source and not os.path.exists(source)
            and "/" not in source):
        url = source if source.startswith("http") else f"http://{source}"
        if not url.rstrip("/").endswith("/serve/stats"):
            url = url.rstrip("/") + "/serve/stats"
        with urllib.request.urlopen(url, timeout=10) as resp:
            return _json.loads(resp.read())
    with open(source) as f:
        return _json.load(f)


def render_serve(view: Dict[str, Any]) -> str:
    """Operational rendering of one /serve/stats payload: admission
    state first (can the fleet take traffic?), then durability (journal
    depth = what a reset would replay), then the engine's utilization."""
    lines: List[str] = []
    router = view.get("router", {})
    journal = view.get("journal", {})
    engine = view.get("engine")
    state = ("DRAINING" if router.get("draining")
             else "SHEDDING" if router.get("pending", 0) >=
             router.get("shed_high", 1 << 30)
             else "ACCEPTING")
    lines.append("== hvdrun doctor --serve: fleet front door ==")
    lines.append(
        f"ADMISSION: {state} — pending {router.get('pending', '?')} "
        f"(shed high/low {router.get('shed_high', '?')}/"
        f"{router.get('shed_low', '?')}, hard cap "
        f"{router.get('max_pending', '?')})")
    lines.append(
        f"  lifetime: submitted {router.get('submitted', '?')}, "
        f"completed {router.get('completed', '?')}, rejected "
        f"{router.get('rejected', '?')} (shed {router.get('shed', '?')})")
    jstate = ("on" if journal.get("enabled")
              else "OFF (degraded: a fleet reset drops in-flight streams)")
    lines.append(
        f"JOURNAL: {jstate} — {journal.get('entries', '?')} entries; a "
        "reset replays the unfinished ones "
        "(docs/serving.md#fault-tolerance)")
    # Watch plane (docs/watch.md) — absent on payloads from routers
    # that predate it.
    al = view.get("alerts")
    if isinstance(al, dict):
        if al.get("firing"):
            lines.append(
                f"ALERTS: {al.get('firing')} firing "
                f"({al.get('critical', 0)} critical): "
                f"{', '.join(al.get('rules') or [])} — details: "
                "GET /alerts / hvdrun doctor --watch")
        else:
            lines.append("ALERTS: none firing")
    # Control-plane shard health (docs/control-plane.md) — absent on
    # payloads from unsharded fleets or routers that predate sharding.
    shards = view.get("kv_shards")
    if isinstance(shards, list) and shards:
        dark = [s for s in shards if not s.get("alive", True)]
        head = (f"{len(dark)} of {len(shards)} shard(s) DARK — scopes "
                "they own stall, everything else proceeds"
                if dark else f"all {len(shards)} shards up")
        lines.append(f"KV SHARDS: {head}")
        for s in shards:
            state_s = "up" if s.get("alive", True) else "DARK"
            lines.append(
                f"  shard {s.get('shard', '?')} [{state_s}] port "
                f"{s.get('port', '?')}: {s.get('requests', '?')} "
                f"requests, {s.get('keys', '?')} keys "
                f"({', '.join(s.get('scopes') or []) or 'empty'})")
    # Replicated tier (docs/serving.md#replicated-tier) — absent on
    # single-fleet deployments and routers that predate it.
    reps = view.get("replicas")
    if isinstance(reps, dict) and reps.get("per_replica"):
        per = reps["per_replica"]
        live = reps.get("live") or []
        rate = reps.get("affinity_hit_rate")
        lines.append(
            f"REPLICAS: {len(per)} registered, {len(live)} live — "
            f"affinity {'on' if reps.get('affinity') else 'OFF'}, "
            f"hit rate {'?' if rate is None else rate} "
            f"({reps.get('affinity_hits', '?')} hits / "
            f"{reps.get('affinity_misses', '?')} misses), "
            f"{reps.get('redispatches', '?')} re-dispatched streams")
        engines = view.get("engines") or {}
        # Dark replicas first: the one getting no traffic is the one
        # the operator is hunting (docs/troubleshooting.md).
        order = sorted(per, key=lambda r: (not per[r].get("dark"),
                                           int(r)))
        for rid in order:
            rec = per[rid]
            est = engines.get(rid) if isinstance(engines, dict) else None
            pool = (est or {}).get("kv_pool") or {}
            spill = (est or {}).get("spill") or pool.get("spill") or {}
            state_r = ("DARK" if rec.get("dark")
                       else "shedding" if rec.get("shed") else "up")
            kv_s = (f"{pool.get('used_blocks', '?')}/"
                    f"{pool.get('num_blocks', '?')} blk"
                    if pool else "?")
            spill_s = (f", spill {spill.get('held_blocks', '?')} held "
                       f"({spill.get('spilled_total', '?')} out / "
                       f"{spill.get('reloaded_total', '?')} back)"
                       if spill else "")
            lines.append(
                f"  replica {rid} [{state_r}]: routed "
                f"{rec.get('routed', '?')} "
                f"({rec.get('affinity_hits', '?')} affinity), queue "
                f"{rec.get('queue_depth', '?')}, kv {kv_s}{spill_s}, "
                f"tree {rec.get('fps', '?')} fps "
                f"digest {rec.get('digest', '?')}")
    if engine is None:
        lines.append("ENGINE: no stats published — fleet starting, "
                     "drained, or dead (check GET /health)")
        return "\n".join(lines)
    lines.append(
        f"ENGINE: tick {engine.get('tick', '?')} — active "
        f"{engine.get('active', '?')}, waiting "
        f"{engine.get('waiting', '?')}, completed "
        f"{engine.get('completed', '?')}, batch fill "
        f"{engine.get('batch_fill', '?')}, free blocks "
        f"{engine.get('free_blocks', '?')}")
    lines.append(
        f"  tokens: prefill {engine.get('tokens_prefill', '?')} "
        f"({engine.get('prefill_chunks', '?')} chunks), "
        f"decode {engine.get('tokens_decode', '?')}")
    # KV-pool occupancy (docs/memory.md#kv-pool) — absent on payloads
    # from engines that predate the memory plane.
    pool = engine.get("kv_pool")
    if isinstance(pool, dict):
        lines.append(
            f"KV POOL: {pool.get('used_blocks', '?')}/"
            f"{pool.get('num_blocks', '?')} blocks used "
            f"({pool.get('free_blocks', '?')} free, "
            f"{pool.get('shared_blocks', '?')} shared) = "
            f"{_fmt_bytes(pool.get('used_bytes'))} of "
            f"{_fmt_bytes(pool.get('pool_bytes'))}; fragmentation "
            f"{pool.get('fragmentation', '?')}, eviction pressure "
            f"{pool.get('eviction_pressure', '?')}")
        # Host-RAM spill tier (docs/serving.md#replicated-tier) —
        # absent when HOROVOD_SERVE_SPILL_BLOCKS is 0.
        sp = pool.get("spill")
        if isinstance(sp, dict):
            lines.append(
                f"  spill (host RAM): {sp.get('held_blocks', '?')}/"
                f"{sp.get('capacity_blocks', '?')} blocks held = "
                f"{_fmt_bytes(sp.get('held_bytes_est'))}; "
                f"{sp.get('spilled_total', '?')} spilled, "
                f"{sp.get('reloaded_total', '?')} reloaded, "
                f"{sp.get('dropped_total', '?')} dropped")
    # Raw-speed legs (docs/serving.md#raw-speed) — absent on payloads
    # from engines that predate them.
    prefix = engine.get("prefix_cache")
    if isinstance(prefix, dict):
        if prefix.get("enabled"):
            rate = prefix.get("hit_rate")
            lines.append(
                f"PREFIX CACHE: on — hit rate "
                f"{'?' if rate is None else rate} "
                f"({prefix.get('hits', '?')} hits, "
                f"{prefix.get('blocks_shared', '?')} blocks shared, "
                f"{prefix.get('cow_copies', '?')} CoW copies, "
                f"{prefix.get('cached_blocks', '?')} cached blocks, "
                f"{prefix.get('evictions', '?')} evictions)")
        else:
            lines.append("PREFIX CACHE: OFF (every prompt recomputes; "
                         "docs/serving.md#raw-speed)")
    spec = engine.get("spec")
    if isinstance(spec, dict):
        if spec.get("enabled"):
            rate = spec.get("accept_rate")
            lines.append(
                f"SPECULATIVE DECODE: on — accept rate "
                f"{'?' if rate is None else rate} "
                f"({spec.get('drafted_tokens', '?')} drafted, "
                f"{spec.get('accepted_tokens', '?')} accepted; low rate "
                "=> n-gram-unfriendly traffic, see "
                "docs/troubleshooting.md)")
        else:
            lines.append("SPECULATIVE DECODE: OFF (one token per tick "
                         "per slot; docs/serving.md#raw-speed)")
    return "\n".join(lines)


# --------------------------------------------------- request forensics
def load_trace_view(source: str) -> Dict[str, Any]:
    """Resolve a ``--request`` source to the ``GET /serve/trace``
    payload (which carries the raw per-request records alongside the
    rollup): an http URL or bare host:port fetches the live route;
    anything else is a saved JSON file — either the route payload or a
    single trace record."""
    import json as _json
    import os
    import urllib.request
    if source.startswith(("http://", "https://")) or (
            ":" in source and not os.path.exists(source)
            and "/" not in source):
        url = source if source.startswith("http") else f"http://{source}"
        if not url.rstrip("/").endswith("/serve/trace"):
            url = url.rstrip("/") + "/serve/trace"
        with urllib.request.urlopen(url, timeout=10) as resp:
            return _json.loads(resp.read())
    with open(source) as f:
        return _json.load(f)


def find_request(view: Dict[str, Any], rid: str) -> Optional[Dict[str, Any]]:
    """The trace record for ``rid`` inside a /serve/trace payload — or
    the payload itself when it IS one saved record."""
    if view.get("rid") == rid:
        return view
    for rec in view.get("records") or []:
        if isinstance(rec, dict) and rec.get("rid") == rid:
            return rec
    return None


# Lifecycle hops in causal order, with the lane each span lands on in
# the merged timeline (docs/serving.md#request-lifecycle).  HANDOFF and
# SPILL_RELOAD only appear on disaggregated / spilling fleets, REDRIVE
# only after a fleet reset — the renderer marks them conditional.
_TRACE_HOPS = (
    ("ROUTE", "router", ""),
    ("NEGOTIATE", "engine", ""),
    ("PREFILL", "engine", ""),
    ("HANDOFF", "engine", " [disaggregated only]"),
    ("SPILL_RELOAD", "engine", " [on spill reload]"),
    ("DECODE", "engine", ""),
    ("STREAM", "stream", ""),
)


def render_request(rec: Dict[str, Any]) -> str:
    """``hvdrun doctor --request RID``: one request's lifecycle,
    root-cause-first — status and the worst component up top, then the
    exact SLO attribution (components sum to the measured wall time —
    serve/trace.py ``attribute``), the placement attempts with their
    affinity-vs-least-loaded verdicts and any re-dispatch suppression
    boundary, and the deterministic causal span ids (re-minted here via
    ``span_id``, so they MATCH what every hop emitted into the merged
    timeline).  A pure function of the record: the live route and the
    post-exit KV render byte-identically."""
    from ..serve import trace as trace_mod
    lines: List[str] = []
    rid = str(rec.get("rid", "?"))
    status = str(rec.get("status", "?"))
    comps = rec.get("components") or {}
    wall = rec.get("wall_s")
    attempts = [a for a in (rec.get("attempts") or [])
                if isinstance(a, dict)]
    lines.append(f"== hvdrun doctor --request {rid} ==")
    # 1. Root cause line first: what happened, and what it cost.
    if status == "done" and comps:
        worst = max(comps, key=lambda c: (float(comps[c] or 0.0), c))
        lines.append(
            f"STATUS: done ({rec.get('finish_reason', '?')}) in "
            f"{float(wall or 0.0):.6f}s — worst component "
            f"{worst} {float(comps[worst] or 0.0):.6f}s")
    elif status == "shed":
        lines.append(
            "STATUS: SHED — rejected 429 before a sequence number was "
            "claimed (no lifecycle to attribute; the rid names the "
            "shed slot)")
    elif status in ("timeout", "running"):
        last = attempts[-1] if attempts else {}
        lines.append(
            f"STATUS: {status.upper()} — the stream never delivered "
            f".done (died mid-flight on replica "
            f"{last.get('replica', '?')} after {len(attempts)} "
            "placement attempt(s); no components to attribute)")
    else:
        lines.append(f"STATUS: {status}")
    lines.append(
        f"REQUEST: prompt {rec.get('prompt_tokens', '?')} tokens, "
        f"max_new {rec.get('max_new_tokens', '?')}"
        + (f", generated {rec.get('n_tokens')}"
           if rec.get("n_tokens") is not None else "")
        + (f", ttft {float(rec['ttft_s']):.6f}s"
           if isinstance(rec.get("ttft_s"), (int, float)) else ""))
    # 2. The exact attribution (sums to wall; over-attribution visible).
    if comps and isinstance(wall, (int, float)):
        ratio = rec.get("overattribution", 1.0)
        over = ("" if not isinstance(ratio, (int, float)) or ratio <= 1.0
                else f"; OVER-ATTRIBUTED x{ratio:.3f}, parts rescaled")
        lines.append(f"ATTRIBUTION (components sum exactly to wall "
                     f"{wall:.6f}s{over}):")
        for c in trace_mod.COMPONENTS:
            v = float(comps.get(c, 0.0) or 0.0)
            pct = (100.0 * v / wall) if wall > 0 else 0.0
            bar = "#" * int(round(pct / 4))
            lines.append(f"  {c:<10} {v:10.6f}s  {pct:5.1f}%  {bar}")
    # 3. Placement: every attempt, verdict, re-dispatch boundary.
    if attempts:
        lines.append(f"PLACEMENT: {len(attempts)} attempt(s), "
                     f"{float(rec.get('placement_s') or 0.0):.6f}s "
                     "spent placing:")
        for i, at in enumerate(attempts):
            v = at.get("verdict") or {}
            kind = v.get("kind", "single-fleet")
            line = (f"  attempt {i}: replica {at.get('replica', '?')} "
                    f"[{kind}]")
            if at.get("affinity_blocks"):
                line += f", {at['affinity_blocks']} affinity blocks"
            if at.get("redispatched_from") is not None:
                line += (
                    f" — RE-DISPATCHED off dark replica "
                    f"{at['redispatched_from']}: suppressing "
                    f"{at.get('suppressed_tokens', '?')} already-"
                    f"delivered token(s), publishing resumes at part "
                    f"{at.get('resume_part', '?')}")
            lines.append(line)
            for cand in v.get("candidates") or []:
                mark = (" <- winner"
                        if cand.get("replica") == v.get("winner") else "")
                lines.append(
                    f"    candidate replica {cand.get('replica', '?')}: "
                    f"prefix depth {cand.get('depth', '?')}, queue "
                    f"{cand.get('queue_depth', '?')}"
                    + (" [shedding]" if cand.get("shed") else "")
                    + mark)
    # 4. The causal span chain — ids recomputed from the determinism
    #    contract, so grepping the merged Perfetto trace for them finds
    #    the exact slices this request produced.
    ctx = rec.get("trace") or {}
    if ctx.get("rid"):
        root = ctx.get("span") or trace_mod.span_id(rid, "admit")
        lines.append("SPANS (deterministic ids — serve/trace.py; grep "
                     "the merged timeline for them):")
        lines.append(f"  admit        {root}  (root, minted at router "
                     "admission)")
        for hop, lane, note in _TRACE_HOPS:
            lines.append(f"  {hop:<12} {trace_mod.span_id(rid, hop)}  "
                         f"(lane {lane}, parent {root}){note}")
    return "\n".join(lines)


def _refusal(what: str) -> str:
    return (f"launch doctor: {what} is not ported yet: it renders what the "
            "postmortem and watch planes write (ROADMAP queue 1 item 4.3)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="launch doctor",
        description="Render the fleet step-time attribution (--perf), the "
                    "serving fleet's view (--serve) or one request's "
                    "lifecycle (--request)")
    ap.add_argument("path",
                    help="with --perf: a GET /perf URL (or host:port), a "
                         "saved /perf JSON, or a directory holding "
                         "perf.json; with --serve / --request: a URL, "
                         "host:port or a saved JSON")
    ap.add_argument("--events", type=int, default=25,
                    help="postmortem events to show (item 4.3)")
    ap.add_argument("--perf", action="store_true",
                    help="render the perf-attribution view")
    ap.add_argument("--serve", action="store_true",
                    help="render the serving fleet's operational view "
                         "(GET /serve/stats URL, host:port, or a saved "
                         "JSON)")
    ap.add_argument("--request", metavar="RID", default=None,
                    help="render one request's lifecycle from the trace "
                         "plane (path = GET /serve/trace URL, host:port, "
                         "or a saved JSON)")
    ap.add_argument("--watch", action="store_true",
                    help="live watch-plane follow mode (item 4.3)")
    ap.add_argument("--once", action="store_true",
                    help="with --watch: a single frame (item 4.3)")
    ap.add_argument("--interval", type=float, default=2.0,
                    help="with --watch: seconds between frames")
    ap.add_argument("--json", action="store_true",
                    help="dump the raw JSON instead of the rendering")
    args = ap.parse_args(argv)
    if args.watch:
        print(_refusal("--watch"), file=sys.stderr)
        return 2
    if args.request:
        try:
            view = load_trace_view(args.path)
        except Exception as e:
            print(f"launch doctor: {e}", file=sys.stderr)
            return 2
        rec = find_request(view, args.request)
        if rec is None:
            print(f"launch doctor: no trace record for "
                  f"{args.request!r}: retention is bounded "
                  "(serve/trace.py TRACE_RETAIN), or the rid never "
                  "passed this router", file=sys.stderr)
            return 2
        if args.json:
            json.dump(rec, sys.stdout, indent=1)
            print()
        else:
            print(render_request(rec))
        return 0
    if args.serve or args.perf:
        load, render = ((load_serve_view, render_serve) if args.serve
                        else (load_perf_view, render_perf))
        try:
            view = load(args.path)
        except Exception as e:
            print(f"launch doctor: {e}", file=sys.stderr)
            return 2
        if args.json:
            json.dump(view, sys.stdout, indent=1)
            print()
        else:
            print(render(view))
        return 0
    print(_refusal("the postmortem view"), file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
