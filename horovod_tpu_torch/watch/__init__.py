"""The port of ``horovod_tpu/watch/``.

Watch plane: fleet time-series history, declarative alert rules, and
training-quality sentinels (docs/watch.md).

Three legs over the planes already built:

  * :mod:`~horovod_tpu_torch.watch.series` — a bounded, downsampling
    time-series store on the rendezvous KV shard that owns the
    ``metrics`` scope (piggybacks on MetricsPublisher PUTs, survives
    elastic resets), served at ``GET /series``;
  * :mod:`~horovod_tpu_torch.watch.rules` — YAML alert rules ({threshold,
    rate-of-change, MAD-anomaly, absence, nonfinite} with ``for:``
    durations and severities) evaluated by the driver's AlertEngine,
    served at ``GET /alerts``, surfaced as timeline instants and the
    ``hvd_alerts_*`` families, distributed via ``launch --alerts``;
  * :mod:`~horovod_tpu_torch.watch.sentinel` — ``hvd.sentinel``-wrapped train
    steps computing trace-time grad-norm / nonfinite / loss-EMA
    scalars, with a nonfinite step firing an explicit flight dump
    (reason ``nan``) plus the committed critical rule.

:class:`WatchState` is the server-side composition the rendezvous
server installs at start (runner/http_server.py): ingest hooks for the
``metrics`` and ``health`` scopes, rate-limited by the series
resolution, plus the engine the routes evaluate.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Any, Dict, List, Optional

from .rules import (AlertEngine, AlertRule, DEFAULT_RULES, KV_KEY,
                    KV_SCOPE, load_rules, loads_rules, merge_rules,
                    parse_rules, rules_to_json, straggler_skew,
                    straggler_verdict)
from .series import SeriesStore
from . import sentinel  # noqa: F401  (hvd.sentinel rides this package)


class WatchState:
    """SeriesStore + AlertEngine behind the rendezvous server's ingest
    hooks.  ``ingest_metrics`` is called from the KV PUT handler for
    every ``metrics``-scope write and rate-limits the (JSON-parse +
    fold) work per rank to the series resolution, so a fast publisher
    costs the server nothing extra."""

    def __init__(self, retention_s: float = 600.0,
                 resolution_s: float = 5.0,
                 rules: Optional[List[AlertRule]] = None,
                 instant_fn=None, log_fn=None):
        self.store = SeriesStore(retention_s=retention_s,
                                 resolution_s=resolution_s)
        self.engine = AlertEngine(self.store, rules=rules,
                                  instant_fn=instant_fn, log_fn=log_fn)
        self._lock = threading.Lock()
        self._last_ingest: Dict[str, float] = {}

    def ingest_metrics(self, key: str, value: bytes,
                       t: Optional[float] = None) -> bool:
        """Fold one metrics-scope PUT into the series store and run an
        evaluation pass.  Returns False when skipped (rate limit or a
        torn payload — telemetry must never fail a KV op)."""
        t = time.time() if t is None else float(t)
        with self._lock:
            last = self._last_ingest.get(key)
            if last is not None and t - last < self.store.resolution:
                return False
            self._last_ingest[key] = t
        try:
            snap = json.loads(value)
            rank = int(snap.get("rank",
                                key.rsplit(".", 1)[-1]))
        except (ValueError, TypeError):
            return False
        self.store.ingest_snapshot(rank, snap, t)
        self.engine.evaluate(t)
        return True

    def note_heartbeat(self, key: str, t: Optional[float] = None) -> None:
        try:
            rank = int(key.rsplit(".", 1)[-1])
        except ValueError:
            return
        self.store.note_heartbeat(rank, t)


def make_watch_state(instant_fn=None, log_fn=None,
                     rules: Optional[List[AlertRule]] = None
                     ) -> WatchState:
    """WatchState from the env knobs — what RendezvousServer.start()
    installs on the ``metrics``-owning shard store."""
    from ..common.knobs import current
    return WatchState(
        retention_s=float(current("HOROVOD_SERIES_RETENTION")),
        resolution_s=float(current("HOROVOD_SERIES_RESOLUTION")),
        rules=rules, instant_fn=instant_fn, log_fn=log_fn)


def validate_watch_knobs(knobs) -> None:
    """Init-time validation of the watch-plane knob surface
    (common/knobs.py contract: a bad value fails hvd.init, never a
    detector mid-run).  Partial-mapping tolerant for old callers."""
    def get(name, default):
        try:
            v = knobs[name]
        except (KeyError, TypeError):
            return default
        return v
    retention = float(get("HOROVOD_SERIES_RETENTION", 600.0))
    resolution = float(get("HOROVOD_SERIES_RESOLUTION", 5.0))
    if retention <= 0:
        raise ValueError(
            f"HOROVOD_SERIES_RETENTION={retention} invalid; the series "
            "store needs a positive history horizon in seconds "
            "(docs/watch.md)")
    if resolution <= 0 or resolution > retention:
        raise ValueError(
            f"HOROVOD_SERIES_RESOLUTION={resolution} invalid; must be "
            "positive and no larger than HOROVOD_SERIES_RETENTION="
            f"{retention} (docs/watch.md)")
    interval = int(get("HOROVOD_SENTINEL_INTERVAL", 1))
    if interval < 1:
        raise ValueError(
            f"HOROVOD_SENTINEL_INTERVAL={interval} invalid; the sentinel "
            "records every Nth step with N >= 1 (docs/watch.md)")
    alerts = str(get("HOROVOD_ALERTS", "") or "")
    if alerts:
        try:
            load_rules(alerts)
        except OSError as e:
            raise ValueError(
                f"HOROVOD_ALERTS={alerts!r} unreadable: {e} "
                "(docs/watch.md#rules)") from e
        except ValueError as e:
            raise ValueError(
                f"HOROVOD_ALERTS={alerts!r} invalid: {e}") from e


__all__ = [
    "AlertEngine", "AlertRule", "DEFAULT_RULES", "KV_KEY", "KV_SCOPE",
    "SeriesStore", "WatchState", "load_rules", "loads_rules",
    "make_watch_state", "merge_rules", "parse_rules", "rules_to_json",
    "sentinel", "straggler_skew", "straggler_verdict",
    "validate_watch_knobs",
]
