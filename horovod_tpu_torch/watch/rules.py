"""Declarative alert rules: detection ON TOP of the fleet time series (the
port of ``horovod_tpu/watch/rules.py``).

The Horovod paper's timeline (arxiv 1802.05799) was born as an in-flight
diagnosis tool; this module is that idea made *standing*: YAML rules —
distributed like chaos specs (``launch --alerts rules.yaml``, KV scope
``alerts``) — evaluated continuously by the driver's
:class:`AlertEngine` against the :class:`~.series.SeriesStore`
(docs/watch.md).  Five closed kinds:

  * ``threshold``       — latest value ``op`` value;
  * ``rate_of_change``  — per-second rate over ``window`` ``op`` value
                          (``roc``; counters become rates here);
  * ``mad``             — |latest - rolling median| > value x MAD over
                          ``window`` (``mad-anomaly``; a flat series has
                          MAD 0 — the ``zero_band`` field is the
                          absolute floor that decides whether a first
                          deviation off a constant fires, default 0 =
                          never, so quantized-flat series stay quiet);
  * ``absence``         — no new point for ``window`` seconds (only for
                          series that existed: bring-up is not absence);
  * ``nonfinite``       — latest value is NaN/Inf.

``for:`` durations gate firing on the condition holding continuously;
severities are ``info | warning | critical``.  Firing alerts surface at
``GET /alerts``, as instants in the merged Perfetto timeline, and as the
``hvd_alerts_total{rule,severity}`` / ``hvd_alerts_firing`` families.

The committed :data:`DEFAULT_RULES` cover the fleet's standing failure
modes: straggler suspect (the 4x-median-p99 check, now a rule —
:func:`straggler_skew` is the ONE implementation both the rules engine
and ``utils.metrics.detect_straggler`` evaluate), perf model drift,
serve shed rate, KV shard unavailability, heartbeat staleness, and the
training-quality sentinels (watch/sentinel.py).

Stdlib-only at module level (yaml and the metrics registry import
lazily), the utils/metrics.py discipline — the engine runs inside the
rendezvous server's request handlers.
"""

from __future__ import annotations

import dataclasses
import json
import math
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

KINDS = ("threshold", "rate_of_change", "mad", "absence", "nonfinite")
_KIND_ALIASES = {"roc": "rate_of_change", "rate-of-change": "rate_of_change",
                 "mad-anomaly": "mad"}
SEVERITIES = ("info", "warning", "critical")
OPS: Dict[str, Callable[[float, float], bool]] = {
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
}

KV_SCOPE = "alerts"
KV_KEY = "rules"


@dataclasses.dataclass(frozen=True)
class AlertRule:
    name: str
    family: str
    kind: str
    op: str = ">"
    value: float = 0.0
    window: float = 30.0      # roc/mad/absence horizon, seconds
    for_s: float = 0.0        # condition must hold this long ("for:")
    severity: str = "warning"
    rank: int = -1            # pin to one rank; -1 = every rank
    zero_band: float = 0.0    # mad: absolute floor when MAD == 0
    context_family: str = ""  # attach this family's latest value to
                              # firings (e.g. the nonfinite step number)

    def describe(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["for"] = d.pop("for_s")
        return d


# -------------------------------------------------------------- validation
def parse_rules(doc: Any) -> List[AlertRule]:
    """Build + validate rules from a parsed YAML/JSON document (a
    mapping with a ``rules`` list, or a bare list).  Raises ValueError
    on unknown kinds/ops/fields so a typo'd ruleset fails at launch,
    not silently at the detection site — the chaos-spec contract."""
    if isinstance(doc, dict):
        unknown = set(doc) - {"rules"}
        if unknown:
            raise ValueError(
                f"alert rules: unknown top-level keys {sorted(unknown)}")
        items = doc.get("rules") or []
    elif isinstance(doc, list) or doc is None:
        items = doc or []
    else:
        raise ValueError(
            f"alert rules must be a mapping or list, got {type(doc)}")
    fields = {f.name for f in dataclasses.fields(AlertRule)} | {"for"}
    rules: List[AlertRule] = []
    seen = set()
    for i, raw in enumerate(items):
        if not isinstance(raw, dict):
            raise ValueError(f"alert rules: rule #{i} must be a mapping")
        raw = dict(raw)
        if "for" in raw:
            raw["for_s"] = raw.pop("for")
        bad = set(raw) - fields
        if bad:
            raise ValueError(
                f"alert rules: rule #{i} unknown fields {sorted(bad)}")
        for req in ("name", "family", "kind"):
            if not raw.get(req):
                raise ValueError(f"alert rules: rule #{i} missing {req!r}")
        raw["kind"] = _KIND_ALIASES.get(str(raw["kind"]), str(raw["kind"]))
        if raw["kind"] not in KINDS:
            raise ValueError(
                f"alert rules: rule {raw['name']!r} kind {raw['kind']!r} "
                f"not in {KINDS}")
        if str(raw.get("op", ">")) not in OPS:
            raise ValueError(
                f"alert rules: rule {raw['name']!r} op {raw.get('op')!r} "
                f"not in {sorted(OPS)}")
        if str(raw.get("severity", "warning")) not in SEVERITIES:
            raise ValueError(
                f"alert rules: rule {raw['name']!r} severity "
                f"{raw.get('severity')!r} not in {SEVERITIES}")
        for num in ("value", "window", "for_s", "zero_band"):
            if num in raw:
                raw[num] = float(raw[num])
        if raw.get("for_s", 0.0) < 0 or raw.get("window", 30.0) <= 0:
            raise ValueError(
                f"alert rules: rule {raw['name']!r} needs for >= 0 and "
                "window > 0")
        if raw["name"] in seen:
            raise ValueError(
                f"alert rules: duplicate rule name {raw['name']!r}")
        seen.add(raw["name"])
        rules.append(AlertRule(**raw))
    return rules


def loads_rules(text: str) -> List[AlertRule]:
    try:
        doc = json.loads(text)
    except ValueError:
        import yaml
        doc = yaml.safe_load(text)
    return parse_rules(doc)


def load_rules(path: str) -> List[AlertRule]:
    with open(path) as f:
        return loads_rules(f.read())


def rules_to_json(rules: List[AlertRule]) -> str:
    """Wire format for rendezvous-KV distribution (scope ``alerts``):
    JSON, so readers never need a YAML parser — the chaos contract."""
    return json.dumps({"rules": [r.describe() for r in rules]},
                      sort_keys=True)


# ------------------------------------------------------- straggler signal
def straggler_skew(p99_by_rank: Dict[int, float],
                   floor_seconds: float = 1e-3
                   ) -> Dict[int, Dict[str, float]]:
    """Per-rank negotiation-age skew: rank's p99 over the median of its
    PEERS' p99s — the ONE implementation of the straggler check.
    ``utils.metrics.detect_straggler`` (the live monitor + end-of-run
    report path) and the series store's derived ``hvd_straggler_skew``
    family (which the committed `straggler-suspect` threshold rule
    watches) both evaluate THIS.  Ratios below the absolute floor are
    reported as 0 so µs-level jitter on an idle fleet never fires; the
    default threshold stays 4x because power-of-2 histogram buckets make
    2x degenerate (adjacent buckets differ by exactly 2x)."""
    out: Dict[int, Dict[str, float]] = {}
    if len(p99_by_rank) < 2:
        return out  # detection needs a peer baseline
    for rank, p99 in p99_by_rank.items():
        peers = sorted(v for r, v in p99_by_rank.items() if r != rank)
        peer_median = peers[len(peers) // 2]
        ratio = p99 / max(peer_median, 1e-9)
        if p99 < floor_seconds:
            ratio = 0.0
        out[rank] = {"ratio": ratio, "p99": p99,
                     "peer_median_p99": peer_median}
    return out


def straggler_verdict(p99_by_rank: Dict[int, float],
                      skew_ratio: float = 4.0,
                      floor_seconds: float = 1e-3
                      ) -> Optional[Dict[str, float]]:
    """The monitor-shaped verdict over :func:`straggler_skew`: the
    worst-skewed rank iff its ratio clears the threshold, else None."""
    skews = straggler_skew(p99_by_rank, floor_seconds=floor_seconds)
    if not skews:
        return None
    rank = max(skews, key=lambda r: skews[r]["ratio"])
    s = skews[rank]
    if not OPS[">="](s["ratio"], skew_ratio):
        return None
    return {"rank": rank, "p99": s["p99"],
            "peer_median_p99": s["peer_median_p99"],
            "ratio": s["ratio"]}


# --------------------------------------------------------- default ruleset
# The standing failure modes every fleet watches (docs/watch.md#defaults);
# `launch --alerts` rules MERGE over these by name (a user rule named
# like a default replaces it).
DEFAULT_RULES: List[AlertRule] = parse_rules({"rules": [
    # The 4x-median-p99 straggler check as a rule: the series store
    # derives hvd_straggler_skew from the shared _age_rows/straggler_skew
    # path, so this threshold IS the old monitor's comparison.
    {"name": "straggler-suspect", "family": "hvd_straggler_skew",
     "kind": "threshold", "op": ">=", "value": 4.0, "severity": "warning"},
    # Perf plane self-assessment: the roofline model pricing less than
    # half of what the wall clock measures for 15 s means the
    # attribution (and anything autoscaling on it) is off the rails.
    {"name": "perf-model-drift", "family": "hvd_perf_model_drift_ratio",
     "kind": "threshold", "op": ">=", "value": 2.0, "for": 15,
     "severity": "warning"},
    # Serving front door under duress: any sustained shedding is an
    # incident (capacity, not code — but an incident).
    {"name": "serve-shed-rate", "family": "hvd_serve_sheds_total",
     "kind": "rate_of_change", "op": ">", "value": 0.0, "window": 30,
     "for": 5, "severity": "warning"},
    # Control-plane partial outage: client-side per-attempt failures
    # against a KV shard (docs/control-plane.md).
    {"name": "kv-shard-unavailable",
     "family": "hvd_kv_shard_unavailable_total",
     "kind": "rate_of_change", "op": ">", "value": 0.0, "window": 30,
     "severity": "critical"},
    # Liveness: a rank that heartbeated before has gone silent (the
    # health plane's staleness as a standing rule).
    {"name": "heartbeat-stale", "family": "heartbeat", "kind": "absence",
     "window": 15, "severity": "critical"},
    # Training-quality sentinels (watch/sentinel.py): a nonfinite step
    # (counter moved — context carries the step number), a NaN loss
    # series, and a loss diverging from its own EMA.
    {"name": "sentinel-nonfinite",
     "family": "hvd_sentinel_nonfinite_total", "kind": "rate_of_change",
     "op": ">", "value": 0.0, "window": 60, "severity": "critical",
     "context_family": "hvd_sentinel_last_nonfinite_step"},
    {"name": "sentinel-loss-nonfinite", "family": "hvd_sentinel_loss",
     "kind": "nonfinite", "severity": "critical"},
    {"name": "sentinel-loss-divergence",
     "family": "hvd_sentinel_loss_divergence", "kind": "threshold",
     "op": ">=", "value": 3.0, "for": 20, "severity": "warning"},
    # Memory plane (perf/memstats.py; docs/memory.md): device residency
    # sustained above the high watermark — the page that precedes the
    # kernel's SIGKILL.  `for:` keeps a transient allocation spike from
    # paging; the memstats sentinel separately fires once per crossing
    # (flight dump reason 'mem'), so the black box exists even when the
    # rule's duration gate never opens.
    {"name": "mem-pressure-high", "family": "hvd_mem_watermark",
     "kind": "threshold", "op": ">=", "value": 0.9, "for": 10,
     "severity": "critical", "context_family": "hvd_mem_bytes_in_use"},
    # Serve KV-cache pool exhausted: admission stalls and eviction
    # pressure follow — capacity, not code, but an incident
    # (docs/serving.md, docs/memory.md#kv-pool).  Watches utilization,
    # not the free count: an unset gauge snapshots as 0, so free <= 0
    # would read as 'dry' on every non-serving rank, while util only
    # reaches 1.0 when an ACTIVE pool has no free blocks.
    {"name": "kv-pool-dry", "family": "hvd_mem_kv_util",
     "kind": "threshold", "op": ">=", "value": 1.0, "for": 10,
     "severity": "warning", "context_family": "hvd_mem_kv_blocks_used"},
    # Request-lifecycle component regressions (docs/serving.md#request-
    # lifecycle): the series store derives per-component p99 gauges from
    # the hvd_serve_component_seconds histogram.  A sustained handoff
    # p99 means the prefill->decode KV transfer (or the router transit
    # under it) is the tail — the disaggregation tax made visible; a
    # sustained queue p99 is admission backlog ahead of any engine work.
    {"name": "serve-handoff-p99", "family": "hvd_serve_handoff_p99_seconds",
     "kind": "threshold", "op": ">=", "value": 0.5, "for": 10,
     "severity": "warning"},
    {"name": "serve-queue-p99", "family": "hvd_serve_queue_p99_seconds",
     "kind": "threshold", "op": ">=", "value": 2.0, "for": 10,
     "severity": "warning"},
    # Memory model self-assessment: measured residency 2x away from the
    # zero_memory_bytes prediction for 15 s means the attribution (and
    # the layout solver consuming its headroom number) is off the rails
    # — the perf plane's drift discipline, for bytes-resident.
    {"name": "mem-model-drift", "family": "hvd_mem_model_drift_ratio",
     "kind": "threshold", "op": ">=", "value": 2.0, "for": 15,
     "severity": "warning"},
]})


def merge_rules(user_rules: Optional[List[AlertRule]]) -> List[AlertRule]:
    """Defaults + user rules, user winning by name."""
    by_name = {r.name: r for r in DEFAULT_RULES}
    for r in (user_rules or []):
        by_name[r.name] = r
    return [by_name[n] for n in by_name]


# ----------------------------------------------------------------- engine
class AlertEngine:
    """Evaluate rules against a SeriesStore; track ``for:`` state,
    firing transitions, the alert metric families, and the timeline
    instants.  Evaluation is cheap (latest points + small windows) and
    runs on every metrics ingest and every ``GET /alerts``."""

    HISTORY = 256

    def __init__(self, store, rules: Optional[List[AlertRule]] = None,
                 instant_fn: Optional[Callable[..., None]] = None,
                 log_fn: Optional[Callable[[str], None]] = None):
        self.store = store
        self.rules = merge_rules(rules)
        self.user_rule_names: List[str] = [r.name for r in (rules or [])]
        self._instant_fn = instant_fn
        self._log = log_fn
        self._lock = threading.Lock()
        # (rule, rank) -> {"pending_since", "firing_since", "value"}
        self._state: Dict[Tuple[str, int], Dict[str, Any]] = {}
        self._fired_total: Dict[Tuple[str, str], int] = {}
        self._history: deque = deque(maxlen=self.HISTORY)

    def set_rules(self, rules: Optional[List[AlertRule]]) -> None:
        with self._lock:
            self.rules = merge_rules(rules)
            self.user_rule_names = [r.name for r in (rules or [])]
            self._state.clear()

    # ---------------------------------------------------------- evaluation
    def _condition(self, rule: AlertRule, rank: int, now: float
                   ) -> Tuple[bool, Optional[float]]:
        """(condition holds, observed value) for one (rule, rank)."""
        cmp = OPS[rule.op]
        if rule.kind == "absence":
            latest = self.store.latest(rank, rule.family)
            if latest is None:
                return False, None  # never seen: bring-up, not absence
            age = now - latest[0]
            return age > rule.window, age
        latest = self.store.latest(rank, rule.family)
        if latest is None:
            return False, None
        t, v = latest
        if rule.kind == "threshold":
            return cmp(v, rule.value), v
        if rule.kind == "nonfinite":
            return not math.isfinite(v), v
        pts = self.store.points(rank, rule.family, now, rule.window)
        if rule.kind == "rate_of_change":
            if len(pts) < 2:
                return False, None
            (t0, v0), (t1, v1) = pts[0], pts[-1]
            if t1 <= t0:
                return False, None
            rate = (v1 - v0) / (t1 - t0)
            return cmp(rate, rule.value), rate
        if rule.kind == "mad":
            if len(pts) < 4:
                return False, None  # too little history to call anomaly
            vals = sorted(p[1] for p in pts[:-1])
            median = vals[len(vals) // 2]
            mad = sorted(abs(x - median) for x in vals)[len(vals) // 2]
            dev = abs(v - median)
            if mad > 0:
                return dev > rule.value * mad, dev / mad
            # MAD zero-band: a perfectly flat history fires only past
            # the explicit absolute band (default 0 = never) — power-of-2
            # bucket quantization makes flat series the common case.
            return (rule.zero_band > 0 and dev > rule.zero_band), dev
        return False, None

    def _candidate_ranks(self, rule: AlertRule) -> List[int]:
        if rule.rank >= 0:
            return [rule.rank]
        return self.store.ranks(rule.family)

    def evaluate(self, now: Optional[float] = None
                 ) -> List[Dict[str, Any]]:
        """One evaluation pass; returns the currently-firing list (the
        ``GET /alerts`` ``firing`` payload).  Transitions update the
        hvd_alerts_* families, the bounded history, the timeline
        instants, and the log."""
        now = time.time() if now is None else float(now)
        with self._lock:
            rules = list(self.rules)
        firing: List[Dict[str, Any]] = []
        per_rule_firing: Dict[str, int] = {r.name: 0 for r in rules}
        for rule in rules:
            for rank in self._candidate_ranks(rule):
                cond, value = self._condition(rule, rank, now)
                key = (rule.name, rank)
                with self._lock:
                    st = self._state.setdefault(
                        key, {"pending_since": None, "firing_since": None})
                    if not cond:
                        st["pending_since"] = None
                        if st["firing_since"] is not None:
                            st["firing_since"] = None
                            self._history.append(
                                {"t": now, "rule": rule.name, "rank": rank,
                                 "event": "resolved"})
                        continue
                    if st["pending_since"] is None:
                        st["pending_since"] = now
                    if now - st["pending_since"] < rule.for_s:
                        continue  # condition true, `for:` not yet served
                    newly = st["firing_since"] is None
                    if newly:
                        st["firing_since"] = now
                        k = (rule.name, rule.severity)
                        self._fired_total[k] = \
                            self._fired_total.get(k, 0) + 1
                        self._history.append(
                            {"t": now, "rule": rule.name, "rank": rank,
                             "event": "firing",
                             "severity": rule.severity, "value": value})
                    since = st["firing_since"]
                entry = {"rule": rule.name, "severity": rule.severity,
                         "kind": rule.kind, "family": rule.family,
                         "rank": rank, "since": since, "value": value}
                if rule.context_family:
                    ctx = self.store.latest(rank, rule.context_family)
                    if ctx is not None:
                        entry["context"] = {rule.context_family: ctx[1]}
                firing.append(entry)
                per_rule_firing[rule.name] += 1
                if newly:
                    self._announce(rule, rank, value, now)
        self._update_metrics(per_rule_firing)
        return firing

    def _announce(self, rule: AlertRule, rank: int, value, now: float
                  ) -> None:
        msg = (f"[hvd] ALERT {rule.severity} {rule.name}: rank {rank} "
               f"{rule.family} {rule.kind} value={value}")
        if self._log is not None:
            try:
                self._log(msg)
            except Exception:
                pass  # alerting must never take the server down
        if self._instant_fn is not None:
            try:
                self._instant_fn(rule=rule.name, rank=rank,
                                 severity=rule.severity, now=now)
            except Exception:
                pass

    def _update_metrics(self, per_rule_firing: Dict[str, int]) -> None:
        try:  # lazy: the engine must stay importable standalone
            from ..utils import metrics as M
        except ImportError:
            return
        with self._lock:
            fired = dict(self._fired_total)
        for (rule, severity), count in fired.items():
            M.ALERTS_TOTAL.set_total(count, rule=rule, severity=severity)
        for rule, n in per_rule_firing.items():
            M.ALERTS_FIRING.set(n, rule=rule)

    # --------------------------------------------------------------- views
    def fired_total(self) -> List[Dict[str, Any]]:
        """Lifetime firing transitions by (rule, severity) — the shape
        bench.py's ``fired_alerts`` artifact section records."""
        with self._lock:
            return [{"rule": r, "severity": s, "count": c}
                    for (r, s), c in sorted(self._fired_total.items())]

    def view(self, now: Optional[float] = None) -> Dict[str, Any]:
        """The ``GET /alerts`` payload: firing first, then the ruleset
        and the bounded transition history."""
        now = time.time() if now is None else float(now)
        firing = self.evaluate(now)
        with self._lock:
            history = list(self._history)
        return {
            "now": now,
            "firing": sorted(
                firing,
                key=lambda f: (-SEVERITIES.index(f["severity"]),
                               f["rule"], f["rank"])),
            "rules": [r.describe() for r in self.rules],
            "user_rules": list(self.user_rule_names),
            "fired_total": self.fired_total(),
            "history": history,
        }
