"""The port of ``horovod_tpu/chaos/spec.py``.

Chaos spec: one declarative, seeded description of the faults a run
injects — the experiment file of the chaos plane (docs/chaos.md).

The reference's fault-tolerance story (elastic recovery, Sergeev & Del
Balso, arxiv 1802.05799) is only ever exercised by hand-written
worker-kill tests; this spec makes every failure mode a repeatable,
CI-checkable experiment.  A spec names WHAT fails (kill / stall /
kv_blackout / crash_commit events plus native transport faults), WHERE
(rank), WHEN (step or call count) and under WHICH seed; ``launch
--chaos spec.yaml`` distributes it through the rendezvous KV so every
rank injects from the same plan (runner/launch.py), and the per-rank
:class:`~horovod_tpu_torch.chaos.injector.ChaosInjector` executes it
deterministically.

YAML shape (both event spellings are accepted)::

    seed: 42
    state_dir: /tmp/chaos            # one-shot event memory across restarts
    transport:                       # -> HOROVOD_CHAOS_TCP_* env (csrc)
      close_after: 5
      rank: 1
    events:
      - kill: {rank: 1, step: 2, exit_code: 1}
      - stall: {rank: 1, point: negotiate, duration_ms: 30}
      - kv_blackout: {op: put, count: 2}
      - kv_blackout: {op: get, scope: serve_plan, count: 3}
      - kv_blackout: {shard: 1, step: 12, count: 6}
      - crash_commit: {rank: 0, step: 3, point: pre_marker}
      - {kind: stall, rank: 0, step: 4, duration_ms: 100}

``kv_blackout`` windows: each event keeps its OWN per-rank counters, so
independent blackouts ride independently.  ``shard`` restricts the
event to KV ops whose scope the deterministic scope->shard map
(runner/kvshard.py, HOROVOD_KV_SHARDS) assigns to that shard — the
partial-outage experiment where one shard server is dark and only the
scopes it owns stall (docs/control-plane.md).  For kv_blackout,
``step`` is an OP offset, not a training step: the event starts failing
only after ``step`` matching KV ops were observed (a mid-run outage
window [step, step+count) instead of a bring-up blackout).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional

EVENT_KINDS = ("kill", "stall", "kv_blackout", "crash_commit")

# spec key -> env knob for the native transport injector (csrc/transport.cc
# reads these directly; common/knobs.py registers them).
TRANSPORT_ENV = {
    "rank": "HOROVOD_CHAOS_TCP_RANK",
    "close_after": "HOROVOD_CHAOS_TCP_CLOSE_AFTER",
    "close_rate": "HOROVOD_CHAOS_TCP_CLOSE_RATE",
    "drop_rate": "HOROVOD_CHAOS_TCP_DROP_RATE",
    "dup_rate": "HOROVOD_CHAOS_TCP_DUP_RATE",
    "delay_rate": "HOROVOD_CHAOS_TCP_DELAY_RATE",
    "delay_ms": "HOROVOD_CHAOS_TCP_DELAY_MS",
}


@dataclasses.dataclass
class ChaosEvent:
    kind: str                 # kill | stall | kv_blackout | crash_commit
    rank: int = -1            # target rank; -1 = every rank
    step: int = -1            # fire at this step; -1 = every matching call
    duration_ms: float = 0.0  # stall: sleep length
    count: int = 0            # kv_blackout: consecutive KV ops to fail
    exit_code: int = 1        # kill / crash_commit: process exit status
    point: str = ""           # stall: injection point (e.g. "negotiate");
                              # crash_commit: pre_marker | pre_manifest
    op: str = ""              # kv_blackout: put | get | "" (any)
    scope: str = ""           # kv_blackout: restrict to one KV scope
                              # (e.g. "serve_plan"); "" = every scope
    shard: int = -1           # kv_blackout: restrict to scopes the
                              # deterministic map assigns to this KV
                              # shard (runner/kvshard.py); -1 = any

    def matches_rank(self, rank: int) -> bool:
        return self.rank < 0 or self.rank == rank

    def matches_step(self, step: Optional[int]) -> bool:
        return self.step < 0 or (step is not None and self.step == step)


@dataclasses.dataclass
class ChaosSpec:
    seed: int = 0
    state_dir: str = ""       # one-shot event memory surviving restarts
    events: List[ChaosEvent] = dataclasses.field(default_factory=list)
    transport: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def transport_env(self) -> Dict[str, str]:
        """The HOROVOD_CHAOS_* env block the launcher exports so the
        native transport injector sees the spec without a C API change."""
        env = {}
        for key, value in self.transport.items():
            env[TRANSPORT_ENV[key]] = str(value)
        if self.seed:
            env["HOROVOD_CHAOS_SEED"] = str(self.seed)
        return env

    def to_json(self) -> str:
        """Wire format for rendezvous-KV distribution (JSON: workers must
        not need a YAML parser to join the plan)."""
        return json.dumps({
            "seed": self.seed,
            "state_dir": self.state_dir,
            "transport": self.transport,
            "events": [dataclasses.asdict(e) for e in self.events],
        }, sort_keys=True)


# Per-field value types: a bad value must name the EVENT INDEX and the
# FIELD (a multi-event spec that raised a bare TypeError out of
# ChaosEvent(**raw) left the experimenter bisecting by hand).  bool is
# excluded from the int fields — YAML's `rank: true` is a typo, not -1.
_EVENT_FIELD_TYPES: Dict[str, Any] = {
    "kind": str,
    "rank": int, "step": int, "count": int, "exit_code": int,
    "shard": int,
    "duration_ms": (int, float),
    "point": str, "op": str, "scope": str,
}


def _check_event_field(i: int, kind: str, name: str, value: Any) -> None:
    want = _EVENT_FIELD_TYPES[name]
    ok = isinstance(value, want) and not (
        isinstance(value, bool) and want is not str)
    if not ok:
        want_name = want.__name__ if isinstance(want, type) else \
            "/".join(t.__name__ for t in want)
        raise ValueError(
            f"chaos spec: event #{i} ({kind}) field {name!r}: expected "
            f"{want_name}, got {value!r} ({type(value).__name__})")


def parse_spec(doc: Dict[str, Any]) -> ChaosSpec:
    """Build + validate a spec from a parsed YAML/JSON document.  Raises
    ``ValueError`` on unknown kinds/fields — and on wrong-typed field
    values, naming the event index AND field — so a typo'd experiment
    fails at launch, not silently at the injection site."""
    if not isinstance(doc, dict):
        raise ValueError(f"chaos spec must be a mapping, got {type(doc)}")
    unknown = set(doc) - {"seed", "state_dir", "events", "transport"}
    if unknown:
        raise ValueError(f"chaos spec: unknown top-level keys {sorted(unknown)}")
    transport = dict(doc.get("transport") or {})
    bad = set(transport) - set(TRANSPORT_ENV)
    if bad:
        raise ValueError(
            f"chaos spec: unknown transport faults {sorted(bad)} "
            f"(known: {sorted(TRANSPORT_ENV)})")
    events: List[ChaosEvent] = []
    fields = {f.name for f in dataclasses.fields(ChaosEvent)}
    for i, raw in enumerate(doc.get("events") or []):
        if not isinstance(raw, dict):
            raise ValueError(f"chaos spec: event #{i} must be a mapping")
        if "kind" not in raw and len(raw) == 1:
            # shorthand: - kill: {rank: 1, step: 2}
            kind, body = next(iter(raw.items()))
            if body is not None and not isinstance(body, dict):
                raise ValueError(
                    f"chaos spec: event #{i} ({kind}) body must be a "
                    f"mapping, got {body!r} ({type(body).__name__})")
            raw = dict(body or {}, kind=kind)
        if raw.get("kind") not in EVENT_KINDS:
            raise ValueError(
                f"chaos spec: event #{i} kind {raw.get('kind')!r} not in "
                f"{EVENT_KINDS}")
        bad = set(raw) - fields
        if bad:
            raise ValueError(
                f"chaos spec: event #{i} unknown fields {sorted(bad)}")
        for name in sorted(raw):
            _check_event_field(i, raw["kind"], name, raw[name])
        events.append(ChaosEvent(**raw))
    return ChaosSpec(seed=int(doc.get("seed") or 0),
                     state_dir=str(doc.get("state_dir") or ""),
                     events=events, transport=transport)


def merge_specs(base: ChaosSpec, extra: ChaosSpec,
                origins: tuple = ("--chaos", "scenario storm")
                ) -> ChaosSpec:
    """Compose two chaos plans into the ONE spec the launcher publishes
    (docs/chaos.md#composition): ``launch --chaos`` + a scenario's
    embedded storm (scenario/storm.py) both reach the fleet, so their
    merge semantics are defined HERE and validated at launch, never
    improvised by a worker.

    Events concatenate base-first (injectors keep per-event state, so
    ordering only affects log/readback order).  Scalars must AGREE:
    a seed/state_dir/transport-key set on both sides with different
    values is a contradiction the launch must refuse — silently picking
    one would replay a different experiment than either file describes.
    Unset (falsy) values defer to the other side."""
    b_name, e_name = origins
    for field in ("seed", "state_dir"):
        b, e = getattr(base, field), getattr(extra, field)
        if b and e and b != e:
            raise ValueError(
                f"chaos spec merge: {field} conflicts between {b_name} "
                f"({b!r}) and {e_name} ({e!r}); set it on one side only")
    transport = dict(base.transport)
    for key, value in extra.transport.items():
        if key in transport and transport[key] != value:
            raise ValueError(
                f"chaos spec merge: transport fault {key!r} conflicts "
                f"between {b_name} ({transport[key]!r}) and {e_name} "
                f"({value!r}); set it on one side only")
        transport[key] = value
    return ChaosSpec(
        seed=base.seed or extra.seed,
        state_dir=base.state_dir or extra.state_dir,
        events=list(base.events) + list(extra.events),
        transport=transport)


def load_spec(path: str) -> ChaosSpec:
    """Load a spec file: YAML (launcher side) or JSON (either)."""
    with open(path) as f:
        text = f.read()
    return loads_spec(text)


def loads_spec(text: str) -> ChaosSpec:
    try:
        doc = json.loads(text)
    except ValueError:
        import yaml
        doc = yaml.safe_load(text)
    return parse_spec(doc or {})
