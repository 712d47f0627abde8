"""The port of ``horovod_tpu/scenario/storm.py``, over the port's chaos
spec (``chaos/spec.py``).

Fault storms: chaos events scheduled on the trace's logical clock.

The chaos plane (horovod_tpu_torch/chaos) places events at hand-picked
training steps; a storm places the SAME event kinds — elastic
kill/restart (resize storms, preemption races), completion ``stall``
windows, per-shard ``kv_blackout`` outages — at logical-clock offsets
(``at_s``) on the scenario's trace, so "a kill 300 ms into the burst"
is data, not a hand-tuned step number (docs/scenarios.md#storms).

Two consumers:

  * :func:`to_chaos_spec` converts a storm into a plain
    :class:`~horovod_tpu_torch.chaos.spec.ChaosSpec` (``at_s`` -> the tick
    index, the replay harness's step clock) for fleet distribution;
    launch.py merges it with any ``--chaos`` spec via
    :func:`~horovod_tpu_torch.chaos.spec.merge_specs` — conflicts fail the
    LAUNCH.
  * :func:`windows` expands a storm into the [start_tick, end_tick)
    outage windows the replay harness executes in-process
    (scenario/harness.py): kill windows tear the engine down and
    rebuild it (overlapping kills — a preemption race — extend one
    outage), stall windows freeze completions, blackout windows buffer
    admissions or hold deliveries depending on which serve scope (or
    KV shard, via the deterministic scope->shard map) is dark.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional

from ..chaos.spec import EVENT_KINDS, ChaosEvent, ChaosSpec

_STORM_FIELD_TYPES: Dict[str, Any] = {
    "kind": str,
    "at_s": (int, float), "down_s": (int, float),
    "duration_s": (int, float),
    "rank": int, "exit_code": int, "shard": int, "replica": int,
    "point": str, "op": str, "scope": str,
}


@dataclasses.dataclass
class StormEvent:
    kind: str                 # a chaos EVENT_KINDS member
    at_s: float               # logical-clock offset into the trace
    down_s: float = 0.3       # kill/crash_commit: outage before restart
    duration_s: float = 0.2   # stall/kv_blackout: window length
    rank: int = -1            # virtual target rank; -1 = whole fleet
    exit_code: int = 1
    point: str = ""           # stall/crash_commit injection point
    op: str = ""              # kv_blackout: put | get | "" (any)
    scope: str = ""           # kv_blackout: one KV scope; "" = all
    shard: int = -1           # kv_blackout: scopes mapping to this shard
    replica: int = -1         # kill: one serving replica; -1 = the tier
                              # (docs/serving.md#replicated-tier)


def parse_storm(items: Any) -> List[StormEvent]:
    """Validate a spec's ``storm:`` list — chaos-spec discipline: every
    error names the event index and field."""
    if items is None:
        return []
    if not isinstance(items, list):
        raise ValueError(
            f"scenario storm must be a list, got {type(items).__name__}")
    out: List[StormEvent] = []
    fields = {f.name for f in dataclasses.fields(StormEvent)}
    for i, raw in enumerate(items):
        if not isinstance(raw, dict):
            raise ValueError(f"scenario storm: event #{i} must be a "
                             "mapping")
        if "kind" not in raw and len(raw) == 1:
            # chaos shorthand: - kill: {at_s: 1.0}
            kind, body = next(iter(raw.items()))
            if body is not None and not isinstance(body, dict):
                raise ValueError(
                    f"scenario storm: event #{i} ({kind}) body must be "
                    f"a mapping, got {body!r}")
            raw = dict(body or {}, kind=kind)
        kind = raw.get("kind")
        if kind not in EVENT_KINDS:
            raise ValueError(
                f"scenario storm: event #{i} kind {kind!r} not in "
                f"{EVENT_KINDS}")
        bad = set(raw) - fields
        if bad:
            raise ValueError(
                f"scenario storm: event #{i} ({kind}) unknown fields "
                f"{sorted(bad)}")
        if "at_s" not in raw:
            raise ValueError(
                f"scenario storm: event #{i} ({kind}) missing 'at_s'")
        for name in sorted(raw):
            want = _STORM_FIELD_TYPES[name]
            ok = isinstance(raw[name], want) and not (
                isinstance(raw[name], bool) and want is not str)
            if not ok:
                want_name = want.__name__ if isinstance(want, type) \
                    else "/".join(t.__name__ for t in want)
                raise ValueError(
                    f"scenario storm: event #{i} ({kind}) field "
                    f"{name!r}: expected {want_name}, got {raw[name]!r} "
                    f"({type(raw[name]).__name__})")
        for name in ("at_s", "down_s", "duration_s"):
            if name in raw and raw[name] < 0:
                raise ValueError(
                    f"scenario storm: event #{i} ({kind}) field "
                    f"{name!r}: must be >= 0, got {raw[name]!r}")
        out.append(StormEvent(**raw))
    out.sort(key=lambda e: (e.at_s, e.kind, e.rank))
    return out


# ------------------------------------------------------- chaos conversion
def to_chaos_spec(storm: List[StormEvent], tick_s: float,
                  seed: int = 0) -> ChaosSpec:
    """Storm -> distributable chaos spec: logical seconds become tick
    indices (the harness's step clock; on a real fleet, training steps).
    kv_blackout windows approximate ``duration_s`` as an op count at
    one KV op per tick — exact on the replay harness, a lower bound on
    a chattier real fleet."""
    events: List[ChaosEvent] = []
    for ev in storm:
        step = int(round(ev.at_s / tick_s))
        if ev.kind in ("kill", "crash_commit"):
            events.append(ChaosEvent(
                kind=ev.kind, rank=max(ev.rank, 0), step=step,
                exit_code=ev.exit_code, point=ev.point))
        elif ev.kind == "stall":
            events.append(ChaosEvent(
                kind="stall", rank=ev.rank, step=step,
                duration_ms=ev.duration_s * 1000.0, point=ev.point))
        else:  # kv_blackout
            events.append(ChaosEvent(
                kind="kv_blackout", rank=ev.rank, step=step,
                count=max(1, int(math.ceil(ev.duration_s / tick_s))),
                op=ev.op, scope=ev.scope, shard=ev.shard))
    return ChaosSpec(seed=seed, events=events)


# --------------------------------------------------------- replay windows
@dataclasses.dataclass
class Window:
    kind: str            # "outage" | "stall" | "blackout"
    start_tick: int
    end_tick: int        # exclusive; recovery measured from here
    at_s: float          # declared fault time (report attribution)
    event: StormEvent
    admission: bool = False   # blackout gates arrivals (serve_req side)
    delivery: bool = False    # blackout holds token deliveries (serve_out)


def _blackout_sides(ev: StormEvent, kv_shards: int) -> (bool, bool):
    """Which serve-facing KV legs a blackout darkens: the request scope
    (admission), the stream scope (delivery), or both.  ``shard``
    resolves through the SAME deterministic scope->shard map every rank
    and router derive (runner/kvshard.py)."""
    if ev.shard >= 0:
        from ..runner.kvshard import shard_for_scope
        return (shard_for_scope("serve_req", kv_shards) == ev.shard,
                shard_for_scope("serve_out", kv_shards) == ev.shard)
    if ev.scope:
        return ev.scope == "serve_req", ev.scope == "serve_out"
    if ev.op:
        # op put = the client's submit leg; op get = the stream poll leg
        return ev.op == "put", ev.op == "get"
    return True, True


def windows(storm: List[StormEvent], tick_s: float,
            kv_shards: int = 3) -> List[Window]:
    """Expand a storm into replay windows on the tick clock.
    Overlapping/adjacent kill windows merge into ONE outage (the
    preemption-race composition: a second kill during recovery extends
    the downtime, it does not double the fleet)."""
    outages: List[Window] = []
    others: List[Window] = []
    for ev in storm:
        start = int(round(ev.at_s / tick_s))
        if ev.kind in ("kill", "crash_commit"):
            end = start + max(1, int(round(ev.down_s / tick_s)))
            outages.append(Window("outage", start, end, ev.at_s, ev))
        elif ev.kind == "stall":
            end = start + max(1, int(round(ev.duration_s / tick_s)))
            others.append(Window("stall", start, end, ev.at_s, ev))
        else:
            end = start + max(1, int(round(ev.duration_s / tick_s)))
            adm, dlv = _blackout_sides(ev, kv_shards)
            others.append(Window("blackout", start, end, ev.at_s, ev,
                                 admission=adm, delivery=dlv))
    outages.sort(key=lambda w: (w.event.replica, w.start_tick))
    merged: List[Window] = []
    for w in outages:
        if merged and merged[-1].event.replica == w.event.replica \
                and w.start_tick <= merged[-1].end_tick:
            # Same-target overlap extends ONE outage; kills aimed at
            # DIFFERENT replicas stay independent windows.
            merged[-1].end_tick = max(merged[-1].end_tick, w.end_tick)
        else:
            merged.append(w)
    out = merged + others
    out.sort(key=lambda w: (w.start_tick, w.kind))
    return out


def active(wins: List[Window], tick: int, kind: str,
           side: Optional[str] = None) -> bool:
    """Is any ``kind`` window (optionally one gating ``side``) open at
    ``tick``?"""
    for w in wins:
        if w.kind != kind or not (w.start_tick <= tick < w.end_tick):
            continue
        if side is None or getattr(w, side):
            return True
    return False
