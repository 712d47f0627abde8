"""Fleet time-series store: bounded history of the planes' signals (the
port of ``horovod_tpu/watch/series.py``).

The other observability planes (metrics, tracing, postmortem, perf)
answer questions about *now* or about a crash that already happened; this store keeps the *history* detection needs
(docs/watch.md).  It lives SERVER-side, on the rendezvous KV shard that
owns the ``metrics`` scope (runner/http_server.py), which buys three
properties for free:

  * **zero extra worker traffic** — it piggybacks on the MetricsPublisher
    PUTs workers already send every ``HOROVOD_METRICS_INTERVAL``;
  * **elastic survival** — the rendezvous server (and its shards) live in
    the driver process, which outlives every reset round, so history
    spans fleet incarnations;
  * **one clock** — points are stamped with the server's receipt time,
    the same reference clock the tracing plane aligns against.

Memory is bounded twice over: each ``(rank, family)`` series is a
downsampling ring holding at most ``retention / resolution + 1`` points
(a newer sample inside the same resolution bucket *replaces* the bucket's
point — last-wins, correct for the cumulative counters and gauges that
ride snapshots), and the store caps the total series count — beyond it
new families are counted as dropped, never grown.  Knobs:
``HOROVOD_SERIES_RETENTION`` / ``HOROVOD_SERIES_RESOLUTION``
(common/knobs.py; validated at hvd.init).

Deliberately stdlib-only at module level (lazy package imports inside
methods), mirroring utils/metrics.py: ingest runs inside the KV server's
request handler and must never import torch.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

# Derived families the ingest computes from snapshots (not raw registry
# families): the negotiation-age p99 per rank and the straggler skew
# ratio the committed `straggler-suspect` default rule thresholds
# (watch/rules.py — ONE detection path with the straggler monitor).
NEGOTIATION_AGE_P99 = "hvd_negotiation_age_p99"
STRAGGLER_SKEW = "hvd_straggler_skew"
# Heartbeat liveness series (value = 1 at each receipt): what the
# `heartbeat-stale` default rule's absence kind ages against.
HEARTBEAT_FAMILY = "heartbeat"
# Request-lifecycle attribution (docs/serving.md#request-lifecycle):
# ingest derives one plain p99 gauge series per lifecycle component from
# the hvd_serve_component_seconds histogram buckets, so the committed
# component-regression rules (e.g. `serve-handoff-p99`, watch/rules.py)
# threshold a scalar instead of re-deriving quantiles per evaluation.
SERVE_COMPONENT_FAMILY = "hvd_serve_component_seconds"
SERVE_COMPONENT_P99_FMT = "hvd_serve_{}_p99_seconds"


class SeriesRing:
    """One (rank, family) series: a bounded, downsampling point ring."""

    __slots__ = ("retention", "resolution", "cap", "points")

    def __init__(self, retention_s: float, resolution_s: float):
        self.retention = float(retention_s)
        self.resolution = float(resolution_s)
        # +1: the in-progress resolution bucket rides beside a full
        # retention window of closed buckets.
        self.cap = max(2, int(math.ceil(self.retention / self.resolution))
                       + 1)
        self.points: List[List[float]] = []  # [[t, v], ...] ascending t

    def add(self, t: float, v: float) -> None:
        if self.points and t - self.points[-1][0] < self.resolution:
            # Downsample: last value wins within a resolution bucket
            # (cumulative counters and gauges both want the newest).
            self.points[-1][1] = v
            return
        self.points.append([float(t), float(v)])
        if len(self.points) > self.cap:
            del self.points[0]
        cutoff = t - self.retention
        while len(self.points) > 1 and self.points[0][0] < cutoff:
            del self.points[0]

    def latest(self) -> Optional[Tuple[float, float]]:
        if not self.points:
            return None
        t, v = self.points[-1]
        return t, v

    def window(self, now: float, window_s: float) -> List[List[float]]:
        cutoff = now - float(window_s)
        return [[t, v] for t, v in self.points if t >= cutoff]


class SeriesStore:
    """Per-(rank, family) rings + the snapshot-ingest logic."""

    def __init__(self, retention_s: float = 600.0,
                 resolution_s: float = 5.0, max_series: int = 4096):
        self.retention = float(retention_s)
        self.resolution = float(resolution_s)
        self.max_series = int(max_series)
        self._lock = threading.Lock()
        self._series: Dict[Tuple[int, str], SeriesRing] = {}
        self.dropped_series = 0

    # ------------------------------------------------------------ raw add
    def add(self, rank: int, family: str, t: float, v: float) -> None:
        key = (int(rank), str(family))
        with self._lock:
            ring = self._series.get(key)
            if ring is None:
                if len(self._series) >= self.max_series:
                    self.dropped_series += 1
                    return  # bounded cardinality: drop, never grow
                ring = SeriesRing(self.retention, self.resolution)
                self._series[key] = ring
            ring.add(t, v)

    def latest(self, rank: int, family: str
               ) -> Optional[Tuple[float, float]]:
        with self._lock:
            ring = self._series.get((int(rank), str(family)))
            return ring.latest() if ring else None

    def ranks(self, family: str) -> List[int]:
        """Ranks that ever produced this family, ascending."""
        with self._lock:
            return sorted(r for r, f in self._series if f == family)

    def families(self) -> List[str]:
        with self._lock:
            return sorted({f for _, f in self._series})

    def points(self, rank: int, family: str, now: float,
               window_s: Optional[float] = None) -> List[List[float]]:
        with self._lock:
            ring = self._series.get((int(rank), str(family)))
            if ring is None:
                return []
            if window_s is None:
                return [list(p) for p in ring.points]
            return ring.window(now, window_s)

    def point_count(self) -> int:
        with self._lock:
            return sum(len(r.points) for r in self._series.values())

    # ------------------------------------------------------ snapshot ingest
    def ingest_snapshot(self, rank: int, snap: Dict[str, Any],
                        t: Optional[float] = None) -> int:
        """Fold one MetricsRegistry.snapshot() into the store: counters
        and gauges as their label-summed value, histograms as their
        observation count, plus the derived negotiation-age p99 and the
        fleet straggler skew.  Returns the number of families stored."""
        t = time.time() if t is None else float(t)
        fams = snap.get("families", {})
        stored = 0
        for name, fam in fams.items():
            kind = fam.get("kind")
            samples = fam.get("samples", [])
            if kind == "histogram":
                v = float(sum(s.get("count", 0) for s in samples))
            else:
                v = float(sum(s.get("value", 0.0) for s in samples))
            self.add(rank, name, t, v)
            stored += 1
        self._ingest_derived(rank, snap, t)
        return stored

    def _ingest_derived(self, rank: int, snap: Dict[str, Any],
                        t: float) -> None:
        """Negotiation-age p99 (shared _age_rows source) + the straggler
        skew of EVERY rank, recomputed from latest p99s — the series the
        committed `straggler-suspect` rule thresholds."""
        fam = snap.get("families", {}).get(SERVE_COMPONENT_FAMILY)
        if isinstance(fam, dict) and fam.get("kind") == "histogram":
            bounds = fam.get("bounds") or []
            for s in fam.get("samples", []):
                comp = (s.get("labels") or {}).get("component")
                count = int(s.get("count") or 0)
                if not comp or not count or not bounds:
                    continue
                # Bucket-upper-bound p99, same math as
                # Histogram.quantile — recomputed here because ingest
                # only sees the snapshot, not the registry object.
                target = 0.99 * count
                cum, p99c = 0, float(bounds[-1])
                for c, bound in zip(s.get("counts") or [], bounds):
                    cum += int(c)
                    if cum >= target:
                        p99c = float(bound)
                        break
                self.add(rank, SERVE_COMPONENT_P99_FMT.format(comp),
                         t, p99c)
        from ..utils.metrics import _age_rows
        rows = _age_rows({int(rank): snap})
        if not rows:
            return
        _, _, p99, _ = rows[0]
        if p99 is None:
            return
        self.add(rank, NEGOTIATION_AGE_P99, t, float(p99))
        p99_by_rank = {}
        for r in self.ranks(NEGOTIATION_AGE_P99):
            latest = self.latest(r, NEGOTIATION_AGE_P99)
            if latest is not None:
                p99_by_rank[r] = latest[1]
        from .rules import straggler_skew
        for r, skew in straggler_skew(p99_by_rank).items():
            self.add(r, STRAGGLER_SKEW, t, skew["ratio"])

    def note_heartbeat(self, rank: int, t: Optional[float] = None) -> None:
        """One heartbeat receipt: the absence-kind liveness series."""
        self.add(rank, HEARTBEAT_FAMILY,
                 time.time() if t is None else float(t), 1.0)

    # -------------------------------------------------------------- query
    def query(self, family: Optional[str] = None,
              rank: Optional[int] = None,
              window_s: Optional[float] = None,
              now: Optional[float] = None) -> Dict[str, Any]:
        """The ``GET /series`` payload: every matching series with its
        points, plus the store's own bounds so readers know the math."""
        now = time.time() if now is None else float(now)
        out: List[Dict[str, Any]] = []
        with self._lock:
            keys = sorted(self._series)
        for r, f in keys:
            if family is not None and f != family:
                continue
            if rank is not None and r != int(rank):
                continue
            pts = self.points(r, f, now, window_s)
            if pts:
                out.append({"rank": r, "family": f, "points": pts})
        return {"now": now, "retention_s": self.retention,
                "resolution_s": self.resolution,
                "dropped_series": self.dropped_series,
                "series": out}
