"""The scenario plane: the port of ``horovod_tpu/scenario/`` (trace,
storm, spec and the replay harness), with the same event streams, digests,
SLO rows, KV scope and knobs; it imports neither JAX nor ``horovod_tpu``.

One YAML spec composes a workload trace (arrival processes, heavy-tailed
request shapes, shared-prefix skew, mixed train+serve phases —
scenario/trace) with a fault storm (chaos-event kinds on the trace's
logical clock — scenario/storm), an SLO expectation and an alert
expectation; the replay harness (scenario/harness) executes it
deterministically against the port's router, serving engine and watch
planes (docs/scenarios.md).  The committed corpus lives under
``scenarios/``.

Distribution follows the chaos-spec contract: ``launch --scenario``
validates at launch, publishes the spec to rendezvous-KV scope
``scenario``, merges the embedded storm with any ``--chaos`` spec
(chaos/spec.py ``merge_specs`` — conflicts fail the launch) and installs
the spec's embedded alert rules.

Knobs (common/knobs.py; validated here at ``hvd.init``):

  * ``HOROVOD_SCENARIO`` — scenario spec path ("" = none); when set the
    file must exist and parse;
  * ``HOROVOD_SCENARIO_RANKS`` — virtual-rank override (0 = the spec's
    ``virtual_ranks``); the event stream is byte-identical either way;
  * ``HOROVOD_SCENARIO_TICK_MS`` — tick override (0 = the spec's).
"""

from __future__ import annotations

from .harness import (  # noqa: F401
    ScenarioHarness, VirtualEngine, canonical_rows, rows_jsonl)
from .spec import (  # noqa: F401
    ScenarioSpec, load_scenario, loads_scenario, parse_scenario)
from .storm import (  # noqa: F401
    StormEvent, parse_storm, to_chaos_spec, windows)
from .trace import (  # noqa: F401
    Stream, arrival_times, builtin_arrivals, events_digest,
    events_jsonl, generate_events, rank_for, stream_seed)

KV_SCOPE = "scenario"
KV_KEY = "spec"


def validate_scenario_knobs(knobs) -> None:
    """Init-time validation of the scenario knob surface
    (common/knobs.py contract: a bad value fails hvd.init, never a
    replay mid-run).  Partial-mapping tolerant for old callers."""
    def get(name, default):
        try:
            v = knobs[name]
        except (KeyError, TypeError):
            return default
        return v
    ranks = int(get("HOROVOD_SCENARIO_RANKS", 0))
    if ranks < 0:
        raise ValueError(
            f"HOROVOD_SCENARIO_RANKS={ranks} invalid; 0 defers to the "
            "spec's virtual_ranks, otherwise >= 1 (docs/scenarios.md)")
    tick = float(get("HOROVOD_SCENARIO_TICK_MS", 0.0))
    if tick < 0:
        raise ValueError(
            f"HOROVOD_SCENARIO_TICK_MS={tick} invalid; 0 defers to the "
            "spec's tick_ms, otherwise a positive tick length in ms "
            "(docs/scenarios.md)")
    path = str(get("HOROVOD_SCENARIO", "") or "")
    if path:
        try:
            load_scenario(path)
        except OSError as e:
            raise ValueError(
                f"HOROVOD_SCENARIO={path!r} unreadable: {e} "
                "(docs/scenarios.md)") from e
        except ValueError as e:
            raise ValueError(
                f"HOROVOD_SCENARIO={path!r} invalid: {e}") from e


__all__ = [
    "KV_KEY", "KV_SCOPE", "ScenarioHarness", "ScenarioSpec",
    "StormEvent", "Stream", "VirtualEngine", "arrival_times",
    "builtin_arrivals", "canonical_rows", "events_digest",
    "events_jsonl", "generate_events", "load_scenario",
    "loads_scenario", "parse_scenario", "parse_storm", "rank_for",
    "rows_jsonl", "stream_seed", "to_chaos_spec",
    "validate_scenario_knobs", "windows",
]
