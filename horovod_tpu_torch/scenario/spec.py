"""The port of ``horovod_tpu/scenario/spec.py``: the same keys, defaults,
error messages and JSON wire format.

Scenario spec: one declarative YAML document composing a workload
trace with a fault storm, an SLO expectation, and an alert expectation
(docs/scenarios.md).

Shape::

    name: burst-serve
    seed: 42
    virtual_ranks: 32        # virtual request sources (>= 1)
    tick_ms: 10              # logical tick = one engine step
    engine: virtual          # virtual | real (serve/engine.py ServeEngine)
    vocab: 256
    kv_shards: 3             # scope->shard map the storm's per-shard
                             # kv_blackout windows resolve against
    engine_config: {max_slots: 8, max_batch_tokens: 64, prefill_chunk: 16}
    shed_high: 0             # admission latch (router semantics); 0 = off
    shed_low: 0
    phases:
      - name: calm
        kind: serve          # serve | train | mixed
        duration_s: 2.0
        arrivals: {process: poisson, rate: 30}
        shapes: {prompt_mean: 12, prompt_max: 48, prefix_groups: 4}
      - name: burst
        kind: serve
        duration_s: 2.0
        arrivals: {process: mmpp, rate: 20, rate_high: 120, switch_s: 0.5}
    storm:                   # scenario/storm.py — logical-clock faults
      - {at_s: 1.0, kind: kill, down_s: 0.3}
      - {at_s: 2.5, kind: kv_blackout, scope: serve_req, duration_s: 0.4}
    alert_rules:             # watch/rules.py schema, merged over defaults
      - {name: scenario-queue-deep, family: hvd_scenario_queue_depth,
         kind: threshold, op: ">=", value: 8, severity: warning}
    expect_alerts: [scenario-queue-deep]

Validation follows the chaos-spec contract: unknown keys, unknown
kinds and wrong-typed values raise ``ValueError`` naming the phase or
storm-event INDEX and the FIELD, so a typo'd scenario fails the launch
(or the bench), never a replay mid-run.  ``to_json`` is the
rendezvous-KV wire format (scope ``scenario``), sorted-keys JSON like
the chaos spec — workers must not need a YAML parser to join the plan.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List

from .storm import StormEvent, parse_storm
from .trace import ARRIVAL_PROCESSES

PHASE_KINDS = ("serve", "train", "mixed")
ENGINES = ("virtual", "real")

_TOP_KEYS = {"name", "seed", "virtual_ranks", "tick_ms", "engine",
             "vocab", "kv_shards", "engine_config", "shed_high",
             "shed_low", "replicas", "phases", "storm", "alert_rules",
             "expect_alerts"}
_PHASE_KEYS = {"name", "kind", "duration_s", "arrivals", "shapes",
               "train_rate"}
_ARRIVAL_KEYS = {"process", "rate", "rate_high", "switch_s", "burst_s",
                 "amplitude", "period_s"}
_SHAPE_KEYS = {"prompt_mean", "prompt_alpha", "prompt_min", "prompt_max",
               "output_mean", "output_alpha", "output_min", "output_max",
               "prefix_groups", "prefix_skew", "prefix_frac"}
_ENGINE_CONFIG_KEYS = {"max_slots", "max_batch_tokens", "prefill_chunk",
                       "block_size", "cache_blocks", "max_seq_len"}


@dataclasses.dataclass
class ScenarioSpec:
    name: str
    seed: int = 42
    virtual_ranks: int = 32
    tick_ms: float = 10.0
    engine: str = "virtual"
    vocab: int = 256
    kv_shards: int = 3
    engine_config: Dict[str, int] = dataclasses.field(default_factory=dict)
    shed_high: int = 0
    shed_low: int = 0
    replicas: int = 1   # serving replica fleets behind one router
                        # (docs/serving.md#replicated-tier)
    phases: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    storm: List[StormEvent] = dataclasses.field(default_factory=list)
    alert_rules: List[Dict[str, Any]] = dataclasses.field(
        default_factory=list)
    expect_alerts: List[str] = dataclasses.field(default_factory=list)

    @property
    def tick_s(self) -> float:
        return self.tick_ms / 1000.0

    @property
    def horizon_s(self) -> float:
        return sum(float(p["duration_s"]) for p in self.phases)

    def to_json(self) -> str:
        """Rendezvous-KV wire format (scope ``scenario`` key ``spec``)."""
        return json.dumps({
            "name": self.name, "seed": self.seed,
            "virtual_ranks": self.virtual_ranks, "tick_ms": self.tick_ms,
            "engine": self.engine, "vocab": self.vocab,
            "kv_shards": self.kv_shards,
            "engine_config": self.engine_config,
            "shed_high": self.shed_high, "shed_low": self.shed_low,
            "replicas": self.replicas,
            "phases": self.phases,
            "storm": [dataclasses.asdict(e) for e in self.storm],
            "alert_rules": self.alert_rules,
            "expect_alerts": self.expect_alerts,
        }, sort_keys=True)


def _num(where: str, field: str, value: Any, *, lo=None) -> float:
    if isinstance(value, bool) or not isinstance(value, (int, float)):
        raise ValueError(
            f"scenario spec: {where} field {field!r}: expected number, "
            f"got {value!r} ({type(value).__name__})")
    if lo is not None and value < lo:
        raise ValueError(
            f"scenario spec: {where} field {field!r}: must be >= {lo}, "
            f"got {value!r}")
    return float(value)


def _check_mapping(where: str, raw: Any, allowed: set) -> Dict[str, Any]:
    if raw is None:
        return {}
    if not isinstance(raw, dict):
        raise ValueError(f"scenario spec: {where} must be a mapping, "
                         f"got {type(raw).__name__}")
    bad = set(raw) - allowed
    if bad:
        raise ValueError(
            f"scenario spec: {where} unknown fields {sorted(bad)} "
            f"(known: {sorted(allowed)})")
    return dict(raw)


def _parse_phase(i: int, raw: Any) -> Dict[str, Any]:
    phase = _check_mapping(f"phase #{i}", raw, _PHASE_KEYS)
    if not phase:
        raise ValueError(f"scenario spec: phase #{i} must be a mapping")
    kind = phase.get("kind", "serve")
    if kind not in PHASE_KINDS:
        raise ValueError(f"scenario spec: phase #{i} kind {kind!r} not "
                         f"in {PHASE_KINDS}")
    if "duration_s" not in phase:
        raise ValueError(f"scenario spec: phase #{i} missing 'duration_s'")
    _num(f"phase #{i}", "duration_s", phase["duration_s"], lo=1e-6)
    arrivals = _check_mapping(f"phase #{i} arrivals",
                              phase.get("arrivals"), _ARRIVAL_KEYS)
    if kind in ("serve", "mixed") and not arrivals:
        raise ValueError(
            f"scenario spec: phase #{i} ({kind}) needs an 'arrivals' "
            "section")
    if arrivals:
        process = arrivals.get("process", "poisson")
        if process not in ARRIVAL_PROCESSES:
            raise ValueError(
                f"scenario spec: phase #{i} field 'arrivals.process': "
                f"{process!r} not in {ARRIVAL_PROCESSES}")
        for key in arrivals:
            if key != "process":
                _num(f"phase #{i} arrivals", key, arrivals[key], lo=0)
        if _num(f"phase #{i} arrivals", "rate",
                arrivals.get("rate", 0)) <= 0:
            raise ValueError(
                f"scenario spec: phase #{i} field 'arrivals.rate': "
                "must be > 0")
    shapes = _check_mapping(f"phase #{i} shapes", phase.get("shapes"),
                            _SHAPE_KEYS)
    for key in shapes:
        _num(f"phase #{i} shapes", key, shapes[key], lo=0)
    if "train_rate" in phase:
        _num(f"phase #{i}", "train_rate", phase["train_rate"], lo=0)
    phase["kind"] = kind
    phase.setdefault("name", f"phase{i}")
    if not isinstance(phase["name"], str):
        raise ValueError(
            f"scenario spec: phase #{i} field 'name': expected str, got "
            f"{phase['name']!r} ({type(phase['name']).__name__})")
    return phase


def parse_scenario(doc: Any) -> ScenarioSpec:
    """Build + validate a scenario from a parsed YAML/JSON document."""
    if not isinstance(doc, dict):
        raise ValueError(
            f"scenario spec must be a mapping, got {type(doc).__name__}")
    top = _check_mapping("top level", doc, _TOP_KEYS)
    name = top.get("name")
    if not name or not isinstance(name, str):
        raise ValueError("scenario spec: 'name' (a string) is required")
    engine = top.get("engine", "virtual")
    if engine not in ENGINES:
        raise ValueError(
            f"scenario spec: engine {engine!r} not in {ENGINES}")
    phases_raw = top.get("phases")
    if not isinstance(phases_raw, list) or not phases_raw:
        raise ValueError("scenario spec: 'phases' (a non-empty list) is "
                         "required")
    phases = [_parse_phase(i, p) for i, p in enumerate(phases_raw)]
    engine_config = _check_mapping("engine_config",
                                   top.get("engine_config"),
                                   _ENGINE_CONFIG_KEYS)
    for key in engine_config:
        engine_config[key] = int(_num("engine_config", key,
                                      engine_config[key], lo=1))
    spec = ScenarioSpec(
        name=name,
        seed=int(_num("top level", "seed", top.get("seed", 42), lo=0)),
        virtual_ranks=int(_num("top level", "virtual_ranks",
                               top.get("virtual_ranks", 32), lo=1)),
        tick_ms=_num("top level", "tick_ms", top.get("tick_ms", 10.0),
                     lo=1e-3),
        engine=engine,
        vocab=int(_num("top level", "vocab", top.get("vocab", 256),
                       lo=2)),
        kv_shards=int(_num("top level", "kv_shards",
                           top.get("kv_shards", 3), lo=1)),
        engine_config=engine_config,
        shed_high=int(_num("top level", "shed_high",
                           top.get("shed_high", 0), lo=0)),
        shed_low=int(_num("top level", "shed_low",
                          top.get("shed_low", 0), lo=0)),
        replicas=int(_num("top level", "replicas",
                          top.get("replicas", 1), lo=1)),
        phases=phases,
        storm=parse_storm(top.get("storm")),
        alert_rules=list(top.get("alert_rules") or []),
        expect_alerts=[str(x) for x in (top.get("expect_alerts") or [])],
    )
    if spec.shed_high and spec.shed_low >= spec.shed_high:
        raise ValueError("scenario spec: shed_low must be < shed_high")
    horizon = spec.horizon_s
    for j, ev in enumerate(spec.storm):
        if ev.at_s >= horizon:
            raise ValueError(
                f"scenario spec: storm event #{j} field 'at_s': "
                f"{ev.at_s} is past the {horizon}s trace horizon")
        if ev.replica >= spec.replicas:
            raise ValueError(
                f"scenario spec: storm event #{j} field 'replica': "
                f"{ev.replica} out of range for replicas="
                f"{spec.replicas}")
    # alert_rules parse through the watch plane's own validator so a
    # typo'd rule fails HERE with its rule-#i message, and expect_alerts
    # must reference a rule that can actually exist (embedded or a
    # committed default).
    from ..watch.rules import DEFAULT_RULES, parse_rules
    rules = parse_rules(spec.alert_rules)
    known = {r.name for r in rules} | {r.name for r in DEFAULT_RULES}
    for want in spec.expect_alerts:
        if want not in known:
            raise ValueError(
                f"scenario spec: expect_alerts names unknown rule "
                f"{want!r} (embedded alert_rules: "
                f"{sorted(r.name for r in rules)})")
    return spec


def loads_scenario(text: str) -> ScenarioSpec:
    try:
        doc = json.loads(text)
    except ValueError:
        import yaml
        doc = yaml.safe_load(text)
    return parse_scenario(doc or {})


def load_scenario(path: str) -> ScenarioSpec:
    with open(path) as f:
        return loads_scenario(f.read())
