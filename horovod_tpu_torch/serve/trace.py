"""Request-lifecycle tracing plane: the port's copy of
``horovod_tpu/serve/trace.py`` (docs/serving.md#request-lifecycle), whole:
the same span ids, rollups and pruning, so both packages mint the same ids
for the same request.

The replicated serving tier broke the single-fleet assumption the first
timeline was built on: one request now crosses the router, a
prefix-affinity-placed replica, a prefill-role engine, a KV handoff to
a decode-role engine, possibly a host-RAM spill reload, a dark-replica
re-dispatch, and the direct stream.  This module is the causal glue —
a compact trace context minted at router admission and propagated
through every hop, plus the per-request SLO attribution that decomposes
measured TTFT/decode wall time into lifecycle components that sum
EXACTLY to the measurement (the perf/ledger.py sums-exactly
discipline).

Determinism contract (the hvdlint ``trace-context`` rule): span ids are
a pure function of (request id, hop name) — FNV-1a, never RNG or
clock — so a journal redrive, a re-dispatched stream, or a scenario
replay re-mints the IDENTICAL ids, and the merged Perfetto view links
parents to children across replica fleets without coordination.  This
module deliberately imports neither ``time`` nor ``random``: callers
pass timestamps in (the scenario harness passes virtual-clock ticks).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

# KV scope holding one bounded-retention record per traced request.
TRACE_SCOPE = "serve_trace"

# Per-request records retained in the serve_trace scope (oldest keys
# pruned on write; rids are req.{seq:06d}, so sorted order = admission
# order).
TRACE_RETAIN = 256

# Lifecycle components, in causal order.  ``attribute`` guarantees they
# sum exactly to the measured wall time; ``stream`` is the residual leg
# (router observe -> client delivery plus anything unmodeled).
COMPONENTS = ("queue", "placement", "prefill", "handoff", "decode",
              "stream")

_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3
_FNV_MASK = 0xFFFFFFFFFFFFFFFF


def _fnv64(data: str) -> int:
    h = _FNV_OFFSET
    for b in data.encode("utf-8"):
        h = ((h ^ b) * _FNV_PRIME) & _FNV_MASK
    return h


def span_id(rid: str, hop: str) -> str:
    """Deterministic span id: a pure function of (request id, hop name).
    Two processes that never talked emit the same id for the same hop of
    the same request — that is what links the merged trace."""
    return f"{_fnv64(f'{rid}/{hop}'):016x}"


def mint(rid: str) -> Dict[str, Any]:
    """Trace context minted once, at router admission: the root span id
    plus a hop counter every downstream leg increments."""
    return {"rid": rid, "span": span_id(rid, "admit"), "hop": 0}


def child(ctx: Dict[str, Any], hop: str) -> Dict[str, Any]:
    """Derive the next hop's context: new span id, parent = the previous
    hop's span, hop counter bumped.  Pure — re-deriving the same hop of
    the same request yields the same ids."""
    rid = str(ctx.get("rid", ""))
    n = int(ctx.get("hop", 0)) + 1
    return {"rid": rid, "span": span_id(rid, f"{n}.{hop}"),
            "parent": ctx.get("span"), "hop": n}


def span_args(ctx: Optional[Dict[str, Any]], hop: str,
              **extra: Any) -> Dict[str, Any]:
    """Timeline ``record_span`` args carrying the causal context — the
    shape the hvdlint trace-context rule recognizes (a ``rid`` key,
    span ids minted via :func:`span_id`).  Tolerates a missing context
    (pre-trace submitters): the rid-only args still tag the lane."""
    ctx = ctx or {}
    rid = str(ctx.get("rid", extra.pop("rid", "")))
    args: Dict[str, Any] = {"rid": rid, "hop": hop,
                            "span": span_id(rid, hop)}
    if ctx.get("span"):
        args["parent"] = ctx["span"]
    args.update(extra)
    return args


# ------------------------------------------------------- SLO attribution
def attribute(wall_s: float, measured: Dict[str, Any]
              ) -> Tuple[Dict[str, float], float]:
    """Decompose a request's measured wall time into the lifecycle
    components, ledger-style: the named components come from measured
    hop durations, ``stream`` absorbs the unattributed residual, and
    when measurement skew makes the parts overshoot the wall they are
    rescaled to fit with the overshoot kept OBSERVABLE as the returned
    over-attribution ratio (modeled/measured; 1.0 = parts fit).

    Invariant: ``math.fsum(components.values()) == wall_s`` exactly
    (float-exact — the residual leg is computed as a difference, and
    rescale dust is folded back into the largest modeled part)."""
    wall = max(0.0, float(wall_s))
    parts = {c: max(0.0, float(measured.get(c) or 0.0))
             for c in COMPONENTS if c != "stream"}
    modeled = math.fsum(parts.values())
    ratio = 1.0
    scale = 1.0
    if modeled > wall:
        # wall == 0 with modeled parts is unbounded overshoot; clamp to
        # a finite, JSON-safe ratio that still reads as "over".
        ratio = (modeled / wall) if wall > 0.0 else max(1.0, modeled)
        scale = (wall / modeled) if modeled > 0.0 else 0.0
    comps = {c: parts[c] * scale for c in parts}
    resid = wall - math.fsum(comps.values())
    if resid < 0.0 and comps:
        big = max(comps, key=lambda c: (comps[c], c))
        comps[big] = max(0.0, comps[big] + resid)
        resid = wall - math.fsum(comps[c] for c in comps)
    comps["stream"] = max(0.0, resid)
    ordered = {c: comps.get(c, 0.0) for c in COMPONENTS}
    return ordered, ratio


# --------------------------------------------------------- fleet rollup
def percentile(values: List[float], q: float) -> float:
    """Nearest-rank percentile — deterministic, no numpy (the
    scenario-harness convention)."""
    if not values:
        return 0.0
    vs = sorted(values)
    idx = min(len(vs) - 1, max(0, int(math.ceil(q / 100.0 * len(vs))) - 1))
    return vs[idx]


def rollup(records: List[Dict[str, Any]], slowest: int = 10
           ) -> Dict[str, Any]:
    """Tail analytics over per-request trace records (``GET
    /serve/trace``): per-component p50/p99 across completed requests
    plus the slowest-requests table, wall-time descending."""
    comp_vals: Dict[str, List[float]] = {c: [] for c in COMPONENTS}
    walls: List[Tuple[float, Dict[str, Any]]] = []
    completed = 0
    for rec in records:
        comps = rec.get("components")
        if comps:
            completed += 1
            for c in COMPONENTS:
                comp_vals[c].append(float(comps.get(c, 0.0) or 0.0))
        walls.append((float(rec.get("wall_s", 0.0) or 0.0), rec))
    walls.sort(key=lambda t: (-t[0], str(t[1].get("rid", ""))))
    table = []
    for wall, rec in walls[:max(0, int(slowest))]:
        comps = rec.get("components") or {}
        worst = max(((c, float(comps.get(c, 0.0) or 0.0))
                     for c in COMPONENTS), key=lambda t: t[1],
                    default=(None, 0.0))
        table.append({
            "rid": rec.get("rid"), "status": rec.get("status"),
            "wall_s": round(wall, 6),
            "replica": (rec.get("attempts") or [{}])[-1].get("replica"),
            "attempts": len(rec.get("attempts") or []),
            "worst_component": worst[0] if worst[1] > 0.0 else None,
            "worst_s": round(worst[1], 6),
        })
    return {
        "requests": len(records),
        "completed": completed,
        "components": {
            c: {"count": len(comp_vals[c]),
                "p50_s": round(percentile(comp_vals[c], 50), 6),
                "p99_s": round(percentile(comp_vals[c], 99), 6)}
            for c in COMPONENTS},
        "slowest": table,
    }


def prune_keys(keys: List[str], retain: int = TRACE_RETAIN) -> List[str]:
    """Keys to delete so the serve_trace scope keeps at most ``retain``
    records: the oldest (lowest-sorting — rids embed the admission
    sequence number) beyond the retention bound."""
    if retain <= 0:
        return sorted(keys)
    extra = len(keys) - retain
    if extra <= 0:
        return []
    return sorted(keys)[:extra]
