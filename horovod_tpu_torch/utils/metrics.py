"""Metrics plane: Counter/Gauge/Histogram registry + Prometheus
exposition, the port of ``horovod_tpu/utils/metrics.py``.

The process-global registry every layer of the port records into:

  * native controller counters/histograms imported from the port's C++
    core (``csrc/core/c_api.cc`` ``hvd_core_metrics``) via
    :func:`import_core_metrics`,
  * eager collectives and fusion planning (``ops/collectives.py``,
    ``ops/fusion.py``), the stall inspector and the negotiated path
    (``ops/negotiated.py``),
  * the serving fleet (``serve/``: engine, router, direct stream, worker).

Family names, help strings, label keys and histogram buckets are the JAX
module's letter for letter, so a scrape from either package reads the
same; the whole standard family set is declared here, the families of
planes the port does not record yet (elastic) included, so a fleet
scrape already has the whole schema.

Exposition: each worker periodically PUTs a JSON :func:`MetricsRegistry.
snapshot` to the rendezvous KV (``MetricsPublisher``); the rendezvous HTTP
server's ``/metrics`` route renders the fleet-wide Prometheus text view
(``runner/http_server.py``), and the launcher prints a rank-0 end-of-run
straggler report (:func:`straggler_report`).

Stdlib-only; its one package-relative import, the straggler check it
shares with the watch plane (``watch/rules.py``), is stdlib-only too.
Histogram buckets are power-of-2 microseconds (expressed in seconds),
matching the native core's fixed-bucket layout so native histograms
import loss-free.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.request
from typing import Any, Callable, Dict, List, Optional, Tuple

# the ONE straggler check, shared with the watch plane's series store and
# its `straggler-suspect` rule
from ..watch.rules import straggler_skew, straggler_verdict  # noqa: F401

SNAPSHOT_VERSION = 1

# Power-of-2 µs upper bounds in seconds: bucket b counts observations
# <= 2^b µs; the native core uses the identical layout (28 buckets,
# ~134 s ceiling) so its histograms map 1:1.
NATIVE_BUCKETS = 28
BUCKET_BOUNDS: Tuple[float, ...] = tuple(
    (1 << b) * 1e-6 for b in range(NATIVE_BUCKETS))


def _label_key(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str):
        self.name = name
        self.help = help
        self._lock = threading.Lock()

    def to_family(self) -> Dict[str, Any]:
        raise NotImplementedError


class Counter(_Metric):
    """Monotonic counter; ``set_total`` imports an externally-accumulated
    value (native core counters) instead of re-counting it."""

    kind = "counter"

    def __init__(self, name: str, help: str):
        super().__init__(name, help)
        self._values: Dict[Tuple[Tuple[str, str], ...], float] = {}

    def inc(self, value: float = 1.0, **labels: str) -> None:
        key = _label_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + value

    def set_total(self, value: float, **labels: str) -> None:
        with self._lock:
            self._values[_label_key(labels)] = float(value)

    def value(self, **labels: str) -> float:
        with self._lock:
            return self._values.get(_label_key(labels), 0.0)

    def to_family(self) -> Dict[str, Any]:
        with self._lock:
            samples = [{"labels": dict(k), "value": v}
                       for k, v in sorted(self._values.items())]
        if not samples:
            samples = [{"labels": {}, "value": 0.0}]
        return {"kind": self.kind, "help": self.help, "samples": samples}


class Gauge(Counter):
    kind = "gauge"

    def set(self, value: float, **labels: str) -> None:
        with self._lock:
            self._values[_label_key(labels)] = float(value)


class Histogram(_Metric):
    """Fixed-bound histogram (power-of-2 µs by default)."""

    kind = "histogram"

    def __init__(self, name: str, help: str,
                 bounds: Tuple[float, ...] = BUCKET_BOUNDS):
        super().__init__(name, help)
        self.bounds = tuple(bounds)
        self._series: Dict[Tuple[Tuple[str, str], ...], Dict[str, Any]] = {}

    def _get(self, key):
        s = self._series.get(key)
        if s is None:
            s = {"counts": [0] * len(self.bounds), "sum": 0.0, "count": 0}
            self._series[key] = s
        return s

    def observe(self, value: float, **labels: str) -> None:
        with self._lock:
            s = self._get(_label_key(labels))
            b = 0
            while b < len(self.bounds) - 1 and value > self.bounds[b]:
                b += 1
            s["counts"][b] += 1
            s["sum"] += float(value)
            s["count"] += 1

    def set_native(self, counts: List[int], total_sum: float, count: int,
                   **labels: str) -> None:
        """Replace a series with an externally-accumulated (native core)
        histogram; counts are per-bucket, already in this bound layout."""
        with self._lock:
            s = self._get(_label_key(labels))
            padded = list(counts)[:len(self.bounds)]
            padded += [0] * (len(self.bounds) - len(padded))
            s["counts"] = [int(c) for c in padded]
            s["sum"] = float(total_sum)
            s["count"] = int(count)

    def quantile(self, q: float, **labels: str) -> Optional[float]:
        """Upper-bound estimate of the q-quantile from the buckets."""
        with self._lock:
            s = self._series.get(_label_key(labels))
            if not s or not s["count"]:
                return None
            target = q * s["count"]
            cum = 0
            for c, bound in zip(s["counts"], self.bounds):
                cum += c
                if cum >= target:
                    return bound
            return self.bounds[-1]

    def to_family(self) -> Dict[str, Any]:
        with self._lock:
            samples = [{"labels": dict(k), "counts": list(s["counts"]),
                        "sum": s["sum"], "count": s["count"]}
                       for k, s in sorted(self._series.items())]
        if not samples:
            samples = [{"labels": {}, "counts": [0] * len(self.bounds),
                        "sum": 0.0, "count": 0}]
        return {"kind": self.kind, "help": self.help,
                "bounds": list(self.bounds), "samples": samples}


class MetricsRegistry:
    """Named metric families, get-or-create, order-preserving."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    def _register(self, cls, name: str, help: str, **kw) -> Any:
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if not isinstance(m, cls) or type(m) is not cls:
                    raise ValueError(
                        f"metric {name!r} already registered as {m.kind}")
                return m
            m = cls(name, help, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str) -> Counter:
        return self._register(Counter, name, help)

    def gauge(self, name: str, help: str) -> Gauge:
        return self._register(Gauge, name, help)

    def histogram(self, name: str, help: str,
                  bounds: Tuple[float, ...] = BUCKET_BOUNDS) -> Histogram:
        return self._register(Histogram, name, help, bounds=bounds)

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def snapshot(self) -> Dict[str, Any]:
        """JSON-able snapshot: the wire format workers PUT to the KV."""
        with self._lock:
            metrics = list(self._metrics.items())
        return {"version": SNAPSHOT_VERSION, "time": time.time(),
                "families": {name: m.to_family() for name, m in metrics}}


REGISTRY = MetricsRegistry()


# --------------------------------------------------------- standard families
# Declared centrally so every process (worker AND driver) exposes the same
# family set — a fleet /metrics view always spans all four layers even when
# a layer recorded nothing yet (zero-valued families, not absent ones).

# Layer 1: native controller (imported from csrc via hvd_core_metrics).
CONTROLLER_CYCLES = REGISTRY.counter(
    "hvd_controller_cycles_total", "Controller negotiation cycles run.")
CONTROLLER_CACHE_HITS = REGISTRY.counter(
    "hvd_controller_cache_hits_total",
    "Requests served via the response-cache bit-vector fast path.")
CONTROLLER_CACHE_MISSES = REGISTRY.counter(
    "hvd_controller_cache_misses_total",
    "Requests that took the full gather negotiation path.")
CONTROLLER_STALL_WARNINGS = REGISTRY.counter(
    "hvd_controller_stall_warnings_total",
    "Native stall-inspector warnings (ranks disagreeing about a tensor).")
CONTROLLER_RESPONSES = REGISTRY.counter(
    "hvd_controller_responses_total", "Negotiated responses emitted.")
CONTROLLER_CACHED_RESPONSES = REGISTRY.counter(
    "hvd_controller_cached_responses_total",
    "Responses reconstructed from the replicated cache.")
CONTROLLER_BYTES_GATHERED = REGISTRY.counter(
    "hvd_controller_bytes_gathered_total",
    "Outbound gather-frame coordination bytes.")
CONTROLLER_BYTES_BROADCAST = REGISTRY.counter(
    "hvd_controller_bytes_broadcast_total",
    "Broadcast-frame coordination bytes seen by this rank.")
CONTROLLER_BYTES_REDUCED = REGISTRY.counter(
    "hvd_controller_bytes_reduced_total",
    "Payload bytes of negotiated reduce-class collectives.")
CONTROLLER_TENSORS = REGISTRY.counter(
    "hvd_controller_tensors_negotiated_total",
    "Tensors carried by OK responses (tensors/cycle numerator).")
CONTROLLER_FUSED_BATCHES = REGISTRY.counter(
    "hvd_controller_fused_batches_total",
    "Fused response batches executed.")
CONTROLLER_FUSED_BYTES = REGISTRY.counter(
    "hvd_controller_fused_batch_bytes_total",
    "Total payload bytes across fused response batches.")
CONTROLLER_FILL_RATIO = REGISTRY.gauge(
    "hvd_controller_fusion_fill_ratio",
    "Mean fused-batch bytes / fusion threshold (fusion buffer fill).")
CONTROLLER_BYPASS_CYCLES = REGISTRY.counter(
    "hvd_controller_bypass_cycles_total",
    "Steady-state replay rounds served from the locked plan epoch with "
    "ZERO controller transport round trips (docs/tensor-fusion.md).")
CONTROLLER_EPOCH_LOCKS = REGISTRY.counter(
    "hvd_controller_epoch_locks_total",
    "Plan-epoch locks applied (rank 0 saw HOROVOD_BYPASS_STABLE_CYCLES "
    "identical negotiated steps and broadcast the lock).")
CONTROLLER_EPOCH_INVALIDATIONS = REGISTRY.counter(
    "hvd_controller_epoch_invalidations_total",
    "Plan-epoch breaks (new/missing tensor, JOIN, shutdown, remote "
    "break) — each falls back to full negotiation.")
TRANSPORT_RECONNECTS = REGISTRY.counter(
    "hvd_transport_reconnects_total",
    "Controller TCP reconnects that succeeded (resync handshake done).")
TRANSPORT_RECONNECT_FAILURES = REGISTRY.counter(
    "hvd_transport_reconnect_failures_total",
    "Controller TCP reconnect attempts that exhausted the retry budget.")
TRANSPORT_FRAMES_RESENT = REGISTRY.counter(
    "hvd_transport_frames_resent_total",
    "Coordination frames retransmitted after a connection break.")
TRANSPORT_FRAMES_DROPPED = REGISTRY.counter(
    "hvd_transport_frames_dropped_total",
    "Coordination frames dropped by chaos injection.")
TRANSPORT_FRAMES_COALESCED = REGISTRY.counter(
    "hvd_transport_frames_coalesced_total",
    "Coordination frames that shared one vectored write with a sibling "
    "(resync ack+replay batches — coalesced frame IO).")
TRANSPORT_COALESCED_BYTES = REGISTRY.counter(
    "hvd_transport_coalesced_bytes_total",
    "Bytes sent through the vectored (writev/sendmsg) frame path — one "
    "syscall per peer per cycle, no header/payload assembly copy.")
CHAOS_FAULTS_NATIVE = REGISTRY.counter(
    "hvd_chaos_faults_native_total",
    "Faults the native transport injector fired (csrc chaos plane).")
CHAOS_INJECTIONS = REGISTRY.counter(
    "hvd_chaos_injections_total",
    "Faults the Python chaos injector fired, by kind "
    "(kill/stall/kv_blackout/crash_commit).")
CONTROLLER_CYCLE_TIME = REGISTRY.histogram(
    "hvd_controller_cycle_time_seconds",
    "Controller RunCycle wall time (native power-of-2 µs buckets).")
CONTROLLER_NEGOTIATION_AGE = REGISTRY.histogram(
    "hvd_controller_negotiation_age_seconds",
    "Rank-0 per-tensor age from first submission to global readiness.")
# Watch plane, native leg (csrc/window.h; docs/watch.md): trailing-window
# rates differentiated inside the core against its epoch-stamped
# snapshot ring — no scraper clock in the math.  Imported from
# hvd_core_metrics_window by metrics_snapshot().
CONTROLLER_CYCLE_RATE = REGISTRY.gauge(
    "hvd_controller_cycle_rate",
    "Controller cycles per second over the trailing window, computed "
    "natively from the core's snapshot ring (hvd_core_metrics_window).")
CONTROLLER_BYTES_REDUCED_RATE = REGISTRY.gauge(
    "hvd_controller_bytes_reduced_rate",
    "Reduced payload bytes per second over the trailing window "
    "(native windowed rate, csrc/window.h).")
TRANSPORT_RECONNECTS_RATE = REGISTRY.gauge(
    "hvd_transport_reconnects_rate",
    "Controller TCP reconnects per MINUTE over the trailing window "
    "(native windowed rate — the flapping-transport detector's input).")
CONTROLLER_BYPASS_FRACTION = REGISTRY.gauge(
    "hvd_controller_bypass_fraction",
    "Fraction of the trailing window's negotiation rounds served from "
    "the locked plan epoch (bypass / (bypass + full cycles)) — the live "
    "steady-state health of the PR-9 fast path.")

# Layer 2: collectives + fusion planning (Python data-plane).
COLLECTIVE_OPS = REGISTRY.counter(
    "hvd_collective_ops_total", "Eager collective calls by op kind.")
COLLECTIVE_BYTES = REGISTRY.counter(
    "hvd_collective_bytes_total", "Eager collective payload bytes by op.")
COLLECTIVE_LATENCY = REGISTRY.histogram(
    "hvd_collective_latency_seconds",
    "Host-side latency of one eager collective call by op.")
FUSION_BUCKET_BYTES = REGISTRY.histogram(
    "hvd_fusion_bucket_bytes",
    "Planned fusion bucket sizes in bytes.",
    bounds=tuple(float(1 << b) for b in range(NATIVE_BUCKETS)))
FUSION_FLUSHES = REGISTRY.counter(
    "hvd_fusion_bucket_flush_total",
    "Fusion buckets closed, by reason (threshold/filled/tail).")
PLAN_CACHE_HITS = REGISTRY.counter(
    "hvd_fusion_plan_cache_hits_total", "Bucket-plan cache hits.")
PLAN_CACHE_MISSES = REGISTRY.counter(
    "hvd_fusion_plan_cache_misses_total", "Bucket-plan cache misses.")
# Wire-policy plane (ops/wire.py).  Decisions happen at TRACE time (one
# compiled program syncs the same buckets every step), so these count per
# trace, like the fusion-planning families above; multiply by steps for
# volume.  docs/tensor-fusion.md#wire-policies.
WIRE_BUCKETS = REGISTRY.counter(
    "hvd_wire_buckets_total",
    "Fusion buckets routed by the wire-policy plane, by chosen format.")
WIRE_BYTES_SAVED = REGISTRY.counter(
    "hvd_wire_bytes_saved_total",
    "Modeled wire bytes saved per compiled step vs the uncompressed "
    "format, by chosen format (bottleneck-fabric model, ops/wire.py).")
WIRE_RESIDUAL_NORM = REGISTRY.gauge(
    "hvd_wire_residual_norm",
    "L2 norm of the error-feedback residual, by bucket index (host-side "
    "report: optimizer.wire_residual_report).")
# Overlap plane (ops/overlap.py).  Set at TRACE time from the analytical
# byte model, like the wire families above: 'exposed' bytes are sync
# traffic issued with no concurrent compute to hide behind (the flush
# tail of the microbatch pipeline; the pipeline ends of the interleaved
# ZeRO chain), by plane (microbatch/zero1/zero2/zero3).
# docs/overlap.md, docs/zero.md.
OVERLAP_EXPOSED_BYTES = REGISTRY.gauge(
    "hvd_overlap_exposed_bytes",
    "Modeled sync bytes left on the critical path (not overlapped with "
    "compute) per compiled step, by plane (ops/overlap.py byte model).")
OVERLAP_FRACTION = REGISTRY.gauge(
    "hvd_overlap_overlapped_fraction",
    "Fraction of modeled sync bytes issued concurrently with compute "
    "per compiled step, by plane (1 - exposed/total; ops/overlap.py).")
# ZeRO weight-update sharding (parallel/zero.py; docs/zero.md).  Set at
# TRACE time like the overlap families: the level/prefetch of the last
# compiled zero chain and the ANALYTICAL per-rank residency of each
# state kind under it (the docs/zero.md memory model, priced by
# perf/costmodel.zero_memory_bytes).
ZERO_LEVEL = REGISTRY.gauge(
    "hvd_zero_level",
    "ZeRO weight-update sharding level of the last traced zero chain "
    "(1 = optimizer state sharded 1/n, 2 = + resident gradient shards, "
    "3 = + parameter shards; parallel/zero.py).")
ZERO_SHARDED_BYTES = REGISTRY.gauge(
    "hvd_zero_sharded_bytes",
    "Modeled per-rank resident bytes under the active ZeRO level, by "
    "kind (params/grads/opt_state/ef_residual) — the analytical memory "
    "model of docs/zero.md, set at trace time.")
ZERO_AG_PREFETCH = REGISTRY.gauge(
    "hvd_zero_ag_prefetch_depth",
    "ZeRO-3 parameter all-gather prefetch depth of the last traced "
    "zero chain (0 below level 3; HOROVOD_ZERO_AG_PREFETCH).")
# 3D layout solver (parallel/layout.py + perf/costmodel.solve_layout;
# docs/parallelism.md).  Set when a layout solve runs — at init under
# HOROVOD_LAYOUT=auto and on every perf_report() with a configured
# layout model — from the ANALYTICAL candidate table, like the ZeRO
# families above.
LAYOUT_CANDIDATES = REGISTRY.gauge(
    "hvd_layout_candidates",
    "Candidate (dp, tp, pp, zero_level, wire, overlap_depth) rows the "
    "layout solver enumerated for the topology in its last solve "
    "(perf/costmodel.solve_layout; docs/parallelism.md).")
LAYOUT_CHOSEN_RANK = REGISTRY.gauge(
    "hvd_layout_chosen_rank",
    "Rank (1 = fastest fitting candidate) of the layout the last solve "
    "selected — > 1 means HOROVOD_TP/HOROVOD_PP constraints or the "
    "memory cap displaced the unconstrained winner.")
LAYOUT_PREDICTED_STEP = REGISTRY.gauge(
    "hvd_layout_predicted_step_seconds",
    "Cost-model predicted step time of the chosen layout (roofline "
    "compute + TP/PP/ZeRO comm + pipeline bubble; the ledger bounds "
    "its drift against measured steps like the ZeRO table).")

# Serving plane (serve/engine.py; docs/serving.md).  SLO telemetry for
# the continuous-batching engine: latency distributions per REQUEST
# (ttft = submit->first token including queue wait; tpot = per-token
# decode latency after the first token) and per-tick utilization gauges.
# Rides the same publisher/exposition path as training, so /metrics and
# the straggler machinery answer serving questions for free.
SERVE_TTFT = REGISTRY.histogram(
    "hvd_serve_ttft_seconds",
    "Serving time-to-first-token per request: submit (queue entry) to "
    "the first generated token, including queue wait and prefill.")
SERVE_TPOT = REGISTRY.histogram(
    "hvd_serve_tpot_seconds",
    "Serving time-per-output-token per request: mean decode-step "
    "latency after the first token (requests with >= 2 tokens).")
SERVE_QUEUE_DEPTH = REGISTRY.gauge(
    "hvd_serve_queue_depth",
    "Requests waiting for a serving slot (admitted = out of the queue).")
SERVE_BATCH_FILL = REGISTRY.gauge(
    "hvd_serve_batch_fill",
    "Fraction of the max_batch_tokens admission budget the last engine "
    "tick actually processed (continuous-batching utilization).")
SERVE_REQUESTS = REGISTRY.counter(
    "hvd_serve_requests_total",
    "Serving requests by outcome (completed / eos / rejected).")
SERVE_TOKENS = REGISTRY.counter(
    "hvd_serve_tokens_total",
    "Tokens processed by the serving engine, by phase "
    "(prefill = prompt tokens cached, decode = tokens generated).")
# Fault-tolerant serving (serve/journal.py, docs/serving.md): journaled
# requests re-admitted after a fleet reset, watermark load sheds, and
# graceful drains — the robustness half of the serving SLO story.
SERVE_REDRIVES = REGISTRY.counter(
    "hvd_serve_redrives_total",
    "Journaled requests re-admitted and deterministically replayed "
    "past their emitted token prefix after a serving-fleet reset.")
SERVE_SHEDS = REGISTRY.counter(
    "hvd_serve_sheds_total",
    "Requests rejected by watermark load shedding (429 + Retry-After "
    "derived from measured TPOT x queue depth).")
SERVE_DRAINS = REGISTRY.counter(
    "hvd_serve_drains_total",
    "Graceful drains initiated via POST /admin/drain (admission stops, "
    "in-flight requests finish, the fleet exits 0).")
SERVE_JOURNAL_DEPTH = REGISTRY.gauge(
    "hvd_serve_journal_depth",
    "Accepted requests journaled for redrive and not yet finished "
    "(what a fleet reset would have to replay right now).")
# Serving raw speed (serve/engine.py; docs/serving.md#raw-speed): the
# prefix-cache / chunked-prefill / speculative-decoding telemetry —
# the rates behind 'is the fast path actually firing on this traffic'.
SERVE_PREFIX_HITS = REGISTRY.counter(
    "hvd_serve_prefix_hits_total",
    "Admissions whose prompt hit the radix prefix cache (>= 1 token "
    "served from already-resident KV blocks instead of recomputed).")
SERVE_PREFIX_BLOCKS_SHARED = REGISTRY.counter(
    "hvd_serve_prefix_blocks_shared_total",
    "Whole KV blocks mapped refcounted from the prefix cache at "
    "admission (prefill work avoided, block reservation shrunk).")
SERVE_PREFILL_CHUNKS = REGISTRY.counter(
    "hvd_serve_prefill_chunks_total",
    "Prefill chunks processed (prompts split across ticks at "
    "HOROVOD_SERVE_PREFILL_CHUNK inside the mixed-step token budget).")
SERVE_SPEC_DRAFTED = REGISTRY.counter(
    "hvd_serve_spec_drafted_tokens_total",
    "Tokens drafted by n-gram/prompt-lookup speculative decoding and "
    "submitted to the multi-token greedy verify step.")
SERVE_SPEC_ACCEPTED = REGISTRY.counter(
    "hvd_serve_spec_accepted_tokens_total",
    "Drafted tokens the greedy verify step accepted (emitted output "
    "stays bit-identical to plain greedy; the ratio to drafted is the "
    "accept rate).")
# Control-plane scale-out (runner/kvshard.py, serve/stream.py;
# docs/control-plane.md): per-shard rendezvous-KV traffic/outage
# accounting and the direct token stream that took the hottest serve
# path off KV polling.
KV_SHARD_REQUESTS = REGISTRY.counter(
    "hvd_kv_shard_requests_total",
    "Rendezvous-KV requests handled per shard server (labeled "
    "shard=index; counted by the driver's shard accept loops — only "
    "emitted when HOROVOD_KV_SHARDS > 1).")
KV_SHARD_UNAVAILABLE = REGISTRY.counter(
    "hvd_kv_shard_unavailable_total",
    "Transient KV-op failures against a shard (labeled shard=index; "
    "counted client-side per attempt, so a backoff riding a dark shard "
    "is visible while every other shard's traffic proceeds).")
SERVE_STREAM_DIRECT_TOKENS = REGISTRY.counter(
    "hvd_serve_stream_direct_tokens_total",
    "Tokens delivered over rank 0's persistent direct stream (POST "
    "/serve/stream) instead of serve_out KV PUTs + router polling; "
    "counted at the router's ingest, where client delivery is assured.")
# Replicated serving tier (serve/replica.py, serve/engine.py;
# docs/serving.md#replicated-tier): router-side placement accounting
# across replica fleets, the prefill->decode disaggregation handoff
# flow, and the host-RAM KV spill tier behind the device pool.
ROUTER_ROUTED = REGISTRY.counter(
    "hvd_router_routed_total",
    "Requests placed on a replica fleet by the front-door router "
    "(labeled replica=id) — affinity hits and least-loaded fallbacks "
    "both count; the per-replica split shows traffic balance.")
ROUTER_AFFINITY_HITS = REGISTRY.counter(
    "hvd_router_affinity_hits_total",
    "Requests routed to the replica advertising the longest cached "
    "prefix of their prompt (>= 1 full block matched the replica's "
    "published radix-tree fingerprints).")
ROUTER_AFFINITY_MISSES = REGISTRY.counter(
    "hvd_router_affinity_misses_total",
    "Requests placed least-loaded because no live replica advertised "
    "any prefix of their prompt (or affinity routing is off).")
ROUTER_REDISPATCHES = REGISTRY.counter(
    "hvd_router_redispatches_total",
    "Accepted streams re-dispatched to a surviving replica after their "
    "original fleet went dark mid-request (per-replica journal redrive "
    "driven router-side; emitted prefix suppressed, byte-identical).")
ROUTER_REPLICAS_UP = REGISTRY.gauge(
    "hvd_router_replicas_up",
    "Replica fleets currently live at the router (registered under the "
    "replicas KV scope with a fresh stats heartbeat; dark replicas — "
    "heartbeat older than HOROVOD_SERVE_REPLICA_DEAD_S — excluded).")
SERVE_HANDOFFS = REGISTRY.counter(
    "hvd_serve_handoffs_total",
    "Finished prefills exported by a prefill-role engine for a decode "
    "engine (prompt KV blocks + first sampled token; the request "
    "finishes with reason prefill_done on the prefill side).")
SERVE_IMPORTS = REGISTRY.counter(
    "hvd_serve_imports_total",
    "Prefill handoffs accepted by a decode-role engine (request "
    "installed directly in decode state with imported prompt KV).")
SERVE_SPILLS = REGISTRY.counter(
    "hvd_serve_spill_blocks_total",
    "Cold radix-cache KV blocks migrated from the device pool to the "
    "host-RAM spill tier at eviction instead of being dropped "
    "(HOROVOD_SERVE_SPILL_BLOCKS bounds the tier).")
SERVE_SPILL_RELOADS = REGISTRY.counter(
    "hvd_serve_spill_reload_blocks_total",
    "Spilled KV blocks reloaded into fresh device blocks on a prefix "
    "hit (the spill tier's payoff: a host copy instead of a prefill "
    "recompute).")
# Request-lifecycle tracing plane (serve/trace.py, serve/router.py;
# docs/serving.md#request-lifecycle): per-request SLO attribution —
# each completed request's measured wall time decomposed into
# queue/placement/prefill/handoff/decode/stream components that sum
# exactly to the measurement, plus the serve_trace record accounting.
SERVE_COMPONENT_SECONDS = REGISTRY.histogram(
    "hvd_serve_component_seconds",
    "Per-request lifecycle component durations (labeled component = "
    "queue / placement / prefill / handoff / decode / stream), observed "
    "at stream completion; per request the components sum exactly to "
    "the router-measured wall time (over-attribution rescaled).")
SERVE_TRACE_RECORDS = REGISTRY.counter(
    "hvd_serve_trace_records_total",
    "Per-request trace records written to the serve_trace KV scope "
    "(admission + completion + re-dispatch updates each count once).")
SERVE_TRACE_PRUNED = REGISTRY.counter(
    "hvd_serve_trace_pruned_total",
    "serve_trace records dropped by the bounded-retention prune "
    "(oldest-first once the scope exceeds the retention cap).")
SERVE_TRACE_OVERATTRIBUTION = REGISTRY.gauge(
    "hvd_serve_trace_overattribution_ratio",
    "Last completed request's modeled-components / measured-wall ratio "
    "before the ledger-style rescale (1.0 = the measured hop durations "
    "fit the wall exactly; > 1.0 = clock skew made them overshoot and "
    "they were rescaled to fit — the overshoot stays observable here).")

# Perf-attribution plane (horovod_tpu/perf/; docs/profiling.md).  The
# step-time decomposition ledger records here: measured step times, the
# per-component split (components sum exactly to the measured step), the
# roofline model's self-assessed drift, and the native controller's
# per-op-name aggregates imported from hvd_core_op_stats.
PERF_STEPS = REGISTRY.counter(
    "hvd_perf_steps_total",
    "Train steps recorded by the perf-attribution ledger "
    "(hvd.perf.record_step / timed_step).")
PERF_STEP_TIME = REGISTRY.histogram(
    "hvd_perf_step_time_seconds",
    "Measured wall time of recorded train steps (the quantity the "
    "decomposition components sum to).")
PERF_COMPONENT = REGISTRY.gauge(
    "hvd_perf_component_seconds",
    "Last recorded step's decomposition by component "
    "(compute / exposed_comm / host_input / stall — docs/profiling.md; "
    "the four sum exactly to the measured step time).")
PERF_MODEL_DRIFT = REGISTRY.gauge(
    "hvd_perf_model_drift_ratio",
    "Mean (modeled + measured-input) / measured step-time ratio over "
    "recorded steps: 1.0 = the roofline cost model prices exactly what "
    "the wall clock measures; drift is itself observable.")
PERF_NATIVE_OP_US = REGISTRY.counter(
    "hvd_perf_native_op_us_total",
    "Cumulative enqueue->done latency (µs) of negotiated collectives by "
    "collapsed op name (csrc hvd_core_op_stats — the native leg of the "
    "attribution plane).")
PERF_NATIVE_OP_BYTES = REGISTRY.counter(
    "hvd_perf_native_op_bytes_total",
    "Cumulative payload bytes of negotiated collectives by collapsed "
    "op name (csrc hvd_core_op_stats).")

# Memory plane (horovod_tpu/perf/memstats.py; docs/memory.md): the
# measured fleet memory ledger — device/host residency sampled per rank,
# attributed to planes from known geometry, reconciled against the
# zero_memory_bytes prediction, and watched by the committed mem-* alert
# rules plus the OOM-proximity sentinel.
MEM_BYTES_IN_USE = REGISTRY.gauge(
    "hvd_mem_bytes_in_use",
    "Measured device bytes in use on this rank: device.memory_stats() "
    "bytes_in_use where the backend provides it, else the aggregate "
    "jax.live_arrays() size (CPU-virtual fallback; the sample's "
    "'source' field says which — docs/memory.md#sources).")
MEM_PEAK_BYTES = REGISTRY.gauge(
    "hvd_mem_peak_bytes",
    "Measured peak device bytes (memory_stats peak_bytes_in_use; under "
    "the CPU fallback the running max of sampled bytes_in_use).")
MEM_CAP_BYTES = REGISTRY.gauge(
    "hvd_mem_cap_bytes",
    "Device memory capacity in bytes (memory_stats bytes_limit); 0 when "
    "the backend reports no cap (CPU fallback) — the watermark and "
    "headroom need a nonzero cap.")
MEM_HOST_RSS = REGISTRY.gauge(
    "hvd_mem_host_rss_bytes",
    "Host resident set of this rank's process (/proc/self/status VmRSS) "
    "— the host leg of the ledger, reported beside (never inside) the "
    "device drift ratio.")
MEM_WATERMARK = REGISTRY.gauge(
    "hvd_mem_watermark",
    "bytes_in_use / cap as a fraction (0 when no cap is known); the "
    "committed mem-pressure-high rule and the OOM-proximity sentinel "
    "threshold this against HOROVOD_MEM_HIGH_WATERMARK.")
MEM_PLANE_BYTES = REGISTRY.gauge(
    "hvd_mem_plane_bytes",
    "Geometry-attributed residency by plane (params / grads / opt_state "
    "/ ef_residual from the ZeRO level + bucket plan, kv_pool from the "
    "BlockAllocator, fusion_overlap from threshold x depth, native_core "
    "from hvd_core_mem) — the per-plane side of the measured-vs-"
    "predicted table (docs/memory.md#attribution).")
MEM_MODEL_DRIFT = REGISTRY.gauge(
    "hvd_mem_model_drift_ratio",
    "Measured bytes_in_use over the zero_memory_bytes predicted total "
    "(1.0 = the memory model prices exactly what the device reports; "
    "the PR-14 drift discipline, for bytes-resident instead of "
    "bytes-moved).  The committed mem-model-drift rule watches it.")
MEM_PRESSURE_EVENTS = REGISTRY.counter(
    "hvd_mem_pressure_events_total",
    "OOM-proximity sentinel firings: watermark transitions above "
    "HOROVOD_MEM_HIGH_WATERMARK, each firing once — alert + timeline "
    "instant + flight dump reason 'mem' (docs/memory.md#oom).")
MEM_KV_BLOCKS_USED = REGISTRY.gauge(
    "hvd_mem_kv_blocks_used",
    "Serve KV-cache pool blocks currently allocated (BlockAllocator "
    "occupancy; docs/serving.md) — the observability prerequisite for "
    "host spill.")
MEM_KV_BLOCKS_FREE = REGISTRY.gauge(
    "hvd_mem_kv_blocks_free",
    "Serve KV-cache pool blocks on the free list (the kv-pool-dry "
    "rule's signal rides hvd_mem_kv_util, derived from this).")
MEM_KV_BLOCKS_SHARED = REGISTRY.gauge(
    "hvd_mem_kv_blocks_shared",
    "Serve KV-cache pool blocks with refcount > 1 (prefix-cache / "
    "beam sharing): bytes the used count double-books across "
    "sequences.")
MEM_KV_UTIL = REGISTRY.gauge(
    "hvd_mem_kv_util",
    "Serve KV-cache pool utilization: used / (used + free), in [0, 1]. "
    "Exactly 1.0 only when an ACTIVE pool has no free blocks — the "
    "committed kv-pool-dry rule watches this rather than the free count "
    "because an unset gauge snapshots as 0, which would read as 'dry' "
    "on every non-serving rank.")
MEM_NATIVE_BYTES = REGISTRY.gauge(
    "hvd_mem_native_bytes",
    "Native core footprint by kind (hvd_core_mem, stamped by the cycle "
    "loop: rss / peak_rss / trace_ring / window_ring / response_cache "
    "— csrc's own memory beside the device planes).")

# Watch plane, detection leg (horovod_tpu/watch/; docs/watch.md): the
# declarative rules engine's firing accounting.  Maintained by the
# DRIVER's AlertEngine (the rendezvous server evaluates rules against
# the fleet series store), so these families carry data on the /metrics
# driver row, not on workers.
ALERTS_TOTAL = REGISTRY.counter(
    "hvd_alerts_total",
    "Alert firing transitions by rule and severity (the rules engine's "
    "lifetime incident count; docs/watch.md#rules).")
ALERTS_FIRING = REGISTRY.gauge(
    "hvd_alerts_firing",
    "Currently-firing alert instances by rule (0 = quiet) — the live "
    "pager view of GET /alerts.")
# Watch plane, sentinel leg (watch/sentinel.py; docs/watch.md#sentinels):
# training-quality scalars computed at trace time inside the step
# (grad-norm / nonfinite via psum, SPMD-identical on all ranks) and
# recorded host-side — the model-health families the committed
# sentinel-* default rules watch.
SENTINEL_STEPS = REGISTRY.counter(
    "hvd_sentinel_steps_total",
    "Train steps the sentinel recorded (hvd.sentinel.wrap / record).")
SENTINEL_LOSS = REGISTRY.gauge(
    "hvd_sentinel_loss", "Last recorded training loss (pmean across "
    "ranks when the step passed an axis_name).")
SENTINEL_LOSS_EMA = REGISTRY.gauge(
    "hvd_sentinel_loss_ema",
    "Exponential moving average of the recorded loss (~50-step "
    "horizon) — the divergence baseline.")
SENTINEL_LOSS_DIVERGENCE = REGISTRY.gauge(
    "hvd_sentinel_loss_divergence",
    "Last loss over its EMA (1.0 = on trend); the committed "
    "sentinel-loss-divergence rule thresholds this.")
SENTINEL_GRAD_NORM = REGISTRY.gauge(
    "hvd_sentinel_grad_norm",
    "Global gradient L2 norm of the last recorded step (psum'd square "
    "sums over the finite gradient mass, trace-time).")
SENTINEL_NONFINITE = REGISTRY.counter(
    "hvd_sentinel_nonfinite_total",
    "Training steps with any nonfinite gradient element or loss (each "
    "also triggers an explicit flight dump, reason 'nan' — "
    "docs/watch.md#sentinels).")
SENTINEL_LAST_NONFINITE_STEP = REGISTRY.gauge(
    "hvd_sentinel_last_nonfinite_step",
    "Step number of the most recent nonfinite verdict (-1 = none); the "
    "sentinel-nonfinite alert carries it as context.")

# Layer 3: runtime (stall inspector + topology).
STRAGGLER_SUSPECT = REGISTRY.gauge(
    "hvd_straggler_suspect",
    "Rank the driver's live straggler check currently suspects (-1 = "
    "none): per-rank negotiation-age p99 skew beyond the ratio threshold "
    "every HOROVOD_STRAGGLER_CHECK_SECS (docs/metrics.md).")
RUNTIME_SIZE = REGISTRY.gauge(
    "hvd_runtime_size", "Worker chips in the mesh.")
RUNTIME_LOCAL_SIZE = REGISTRY.gauge(
    "hvd_runtime_local_size", "Chips driven by this process.")
NATIVE_SANITIZER_BUILD = REGISTRY.gauge(
    "hvd_native_sanitizer_build",
    "1 for the sanitizer tag of the loaded native core library "
    "(sanitizer=none|tsan|asan|ubsan, csrc/Makefile SAN modes): the "
    "build-info surface that keeps a 5-20x-slower sanitized library "
    "from silently leaking into a benchmark or production fleet "
    "(docs/static-analysis.md).")
STALL_WARNINGS = REGISTRY.counter(
    "hvd_stall_warnings_total",
    "Python stall-inspector warnings (submitted but not completed).")
STALL_PENDING = REGISTRY.gauge(
    "hvd_stall_pending_tensors",
    "Collectives currently submitted but not completed.")
NEGOTIATION_AGE = REGISTRY.histogram(
    "hvd_negotiation_age_seconds",
    "Per-rank submit-to-completion age of named collectives (the "
    "straggler report's source: a slow rank drags every peer's ages up).")

# Layer 4: elastic lifecycle.
WORKER_EXITS = REGISTRY.counter(
    "hvd_worker_exits_total",
    "Worker process exits observed by the launcher/elastic driver, by "
    "cause (clean / error:N / signal:NAME / stall / heartbeat-lost / "
    "terminated — the postmortem plane's exit taxonomy, "
    "docs/postmortem.md).")
ELASTIC_RESETS = REGISTRY.counter(
    "hvd_elastic_reset_rounds_total", "Elastic reset rounds started.")
ELASTIC_FAILURES = REGISTRY.counter(
    "hvd_elastic_worker_failures_total", "Worker processes that failed.")
ELASTIC_HOSTS_ADDED = REGISTRY.counter(
    "hvd_elastic_hosts_added_total", "Hosts added by discovery.")
ELASTIC_HOSTS_REMOVED = REGISTRY.counter(
    "hvd_elastic_hosts_removed_total",
    "Hosts removed by discovery or blacklisting.")
ELASTIC_ROUND_DURATION = REGISTRY.histogram(
    "hvd_elastic_round_duration_seconds",
    "Wall time of one elastic round (spawn to reset/finish).")
ELASTIC_COMMITS = REGISTRY.counter(
    "hvd_elastic_commits_total", "Elastic state commits.")
ELASTIC_COMMIT_DURATION = REGISTRY.histogram(
    "hvd_elastic_commit_duration_seconds",
    "Wall time of one elastic state commit.")
ELASTIC_RESTORES = REGISTRY.counter(
    "hvd_elastic_restores_total", "Elastic state restores after reset.")


_CORE_COUNTERS = (
    (CONTROLLER_CYCLES, "cycles"), (CONTROLLER_CACHE_HITS, "cache_hits"),
    (CONTROLLER_CACHE_MISSES, "cache_misses"),
    (CONTROLLER_STALL_WARNINGS, "stall_warnings"),
    (CONTROLLER_RESPONSES, "responses"),
    (CONTROLLER_CACHED_RESPONSES, "cached_responses"),
    (CONTROLLER_BYTES_GATHERED, "bytes_gathered"),
    (CONTROLLER_BYTES_BROADCAST, "bytes_broadcast"),
    (CONTROLLER_BYTES_REDUCED, "bytes_reduced"),
    (CONTROLLER_TENSORS, "tensors_negotiated"),
    (CONTROLLER_FUSED_BATCHES, "fused_batches"),
    (CONTROLLER_FUSED_BYTES, "fused_batch_bytes"),
    (CONTROLLER_BYPASS_CYCLES, "bypass_cycles"),
    (CONTROLLER_EPOCH_LOCKS, "epoch_locks"),
    (CONTROLLER_EPOCH_INVALIDATIONS, "epoch_invalidations"),
    (TRANSPORT_RECONNECTS, "transport_reconnects"),
    (TRANSPORT_RECONNECT_FAILURES, "transport_reconnect_failures"),
    (TRANSPORT_FRAMES_RESENT, "transport_frames_resent"),
    (TRANSPORT_FRAMES_DROPPED, "transport_frames_dropped"),
    (TRANSPORT_FRAMES_COALESCED, "transport_frames_coalesced"),
    (TRANSPORT_COALESCED_BYTES, "transport_coalesced_bytes"),
    (CHAOS_FAULTS_NATIVE, "chaos_faults_injected"),
)
# the totals of native cores this process has closed (an elastic hard
# reset brings up a new core, whose counters start again from 0), added
# by core_totals
_core_base: Dict[str, float] = {}


def import_core_metrics(native: Dict[str, Any]) -> None:
    """Map one native-core metrics dict (CoordinationCore.metrics()) onto
    the controller families.  Native values are cumulative, so they are
    imported with set_total/set_native rather than re-counted."""
    c = native.get("counters", {})
    for metric, key in _CORE_COUNTERS:
        metric.set_total(c.get(key, 0))
    batches = c.get("fused_batches", 0)
    threshold = c.get("fusion_threshold_bytes", 0)
    if batches and threshold:
        CONTROLLER_FILL_RATIO.set(
            c.get("fused_batch_bytes", 0) / (batches * threshold))
    for hname, metric in (("cycle_time_us", CONTROLLER_CYCLE_TIME),
                          ("negotiation_age_us", CONTROLLER_NEGOTIATION_AGE)):
        h = native.get("histograms", {}).get(hname)
        if h:
            metric.set_native(h["buckets"], h["sum"] * 1e-6, h["count"])


def core_totals(native: Dict[str, Any]) -> Dict[str, Any]:
    """``native`` with the counters of the cores this process retired
    (:func:`retire_core_metrics`) added, so a counter imported from it
    never goes back across an in-process reset."""
    if not _core_base:
        return native
    c = dict(native.get("counters", {}))
    for key, base in _core_base.items():
        c[key] = c.get(key, 0) + base
    return dict(native, counters=c)


def retire_core_metrics(native: Dict[str, Any]) -> None:
    """Fold a closing native core's final counters into the base that
    :func:`core_totals` adds to the next core's, and zero the windowed
    rates it fed (the runtime calls this at shutdown, before it closes the
    core)."""
    import_core_metrics(core_totals(native))
    c = native.get("counters", {})
    for _, key in _CORE_COUNTERS:
        _core_base[key] = _core_base.get(key, 0.0) + c.get(key, 0)
    import_window_rates({})


def import_window_rates(window: Dict[str, Any]) -> None:
    """Map one native windowed-rates dict (CoordinationCore.
    metrics_window()) onto the hvd_*_rate gauges.  The rates were
    differentiated inside the core against its own steady clock
    (csrc/window.h), so this is a straight copy."""
    CONTROLLER_CYCLE_RATE.set(window.get("cycle_rate", 0.0))
    CONTROLLER_BYTES_REDUCED_RATE.set(
        window.get("bytes_reduced_rate", 0.0))
    TRANSPORT_RECONNECTS_RATE.set(window.get("reconnect_rate", 0.0))
    CONTROLLER_BYPASS_FRACTION.set(window.get("bypass_fraction", 0.0))


# --------------------------------------------------------------- exposition
def _render_family(lines: List[str], name: str, fam: Dict[str, Any],
                   extra_labels: Dict[str, str]) -> None:
    for s in fam["samples"]:
        labels = dict(s.get("labels", {}))
        labels.update(extra_labels)
        if fam["kind"] == "histogram":
            cum = 0
            base = {k: v for k, v in labels.items()}
            for c, bound in zip(s["counts"], fam["bounds"]):
                cum += c
                lab = dict(base)
                lab["le"] = repr(float(bound))
                lines.append(f"{name}_bucket{_fmt_labels(lab)} {cum}")
            lab = dict(base)
            lab["le"] = "+Inf"
            lines.append(f"{name}_bucket{_fmt_labels(lab)} {s['count']}")
            lines.append(f"{name}_sum{_fmt_labels(base)} "
                         f"{_fmt_value(s['sum'])}")
            lines.append(f"{name}_count{_fmt_labels(base)} {s['count']}")
        else:
            lines.append(f"{name}{_fmt_labels(labels)} "
                         f"{_fmt_value(s['value'])}")


def _fmt_labels(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape(str(v))}"'
                     for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _fmt_value(v: float) -> str:
    f = float(v)
    return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def render_prometheus(snapshots: List[Tuple[Dict[str, str], Dict[str, Any]]]
                      ) -> str:
    """Prometheus text format (v0.0.4) from [(extra_labels, snapshot)].

    Families are merged by name across snapshots; each snapshot's samples
    carry its extra labels (e.g. ``rank="1"``), so one scrape shows the
    whole fleet."""
    order: List[str] = []
    merged: Dict[str, List[Tuple[Dict[str, str], Dict[str, Any]]]] = {}
    for extra, snap in snapshots:
        for name, fam in snap.get("families", {}).items():
            if name not in merged:
                merged[name] = []
                order.append(name)
            merged[name].append((extra, fam))
    lines: List[str] = []
    for name in order:
        first = merged[name][0][1]
        lines.append(f"# HELP {name} {first['help']}")
        lines.append(f"# TYPE {name} {first['kind']}")
        for extra, fam in merged[name]:
            _render_family(lines, name, fam, extra)
    return "\n".join(lines) + "\n"


def lint_exposition(text: str) -> List[str]:
    """Pure-Python promtool-style check of Prometheus text format.

    Returns a list of violations (empty = clean).  Covers the drift CI
    must catch: TYPE/HELP pairing, sample↔family consistency, histogram
    +Inf/_sum/_count completeness, numeric values, and duplicate series."""
    import re
    errors: List[str] = []
    typed: Dict[str, str] = {}
    seen_series = set()
    hist_state: Dict[str, Dict[str, bool]] = {}
    name_rx = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
    sample_rx = re.compile(
        r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})?\s+(\S+)$")
    label_rx = re.compile(
        r'^[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*"$')
    for i, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("# HELP "):
            parts = line.split(" ", 3)
            if len(parts) < 4 or not name_rx.match(parts[2]):
                errors.append(f"line {i}: malformed HELP")
            continue
        if line.startswith("# TYPE "):
            parts = line.split(" ")
            if len(parts) != 4 or parts[3] not in (
                    "counter", "gauge", "histogram", "summary", "untyped"):
                errors.append(f"line {i}: malformed TYPE")
                continue
            if parts[2] in typed:
                errors.append(f"line {i}: duplicate TYPE for {parts[2]}")
            typed[parts[2]] = parts[3]
            continue
        if line.startswith("#"):
            continue
        m = sample_rx.match(line)
        if not m:
            errors.append(f"line {i}: unparseable sample: {line!r}")
            continue
        name, labelstr, value = m.group(1), m.group(2) or "", m.group(3)
        base = name
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix) and name[:-len(suffix)] in typed and \
                    typed[name[:-len(suffix)]] == "histogram":
                base = name[:-len(suffix)]
        if base not in typed:
            errors.append(f"line {i}: sample {name} has no TYPE declaration")
            continue
        if typed[base] == "histogram":
            st = hist_state.setdefault(base, {})
            if name.endswith("_bucket") and 'le="+Inf"' in labelstr:
                st["inf"] = True
            if name.endswith("_sum"):
                st["sum"] = True
            if name.endswith("_count"):
                st["count"] = True
            if name == base:
                errors.append(
                    f"line {i}: bare sample for histogram {base}")
        if labelstr:
            for pair in _split_labels(labelstr[1:-1]):
                if pair and not label_rx.match(pair):
                    errors.append(f"line {i}: malformed label {pair!r}")
        if value not in ("+Inf", "-Inf", "NaN"):
            try:
                float(value)
            except ValueError:
                errors.append(f"line {i}: non-numeric value {value!r}")
        key = (name, labelstr)
        if key in seen_series:
            errors.append(f"line {i}: duplicate series {name}{labelstr}")
        seen_series.add(key)
    for base, st in hist_state.items():
        for part in ("inf", "sum", "count"):
            if not st.get(part):
                errors.append(f"histogram {base} missing "
                              f"{'+Inf bucket' if part == 'inf' else '_' + part}")
    return errors


def _split_labels(inner: str) -> List[str]:
    """Split 'a="x",b="y,z"' on commas outside quotes."""
    parts, cur, in_q, esc = [], "", False, False
    for ch in inner:
        if esc:
            cur += ch
            esc = False
        elif ch == "\\":
            cur += ch
            esc = True
        elif ch == '"':
            cur += ch
            in_q = not in_q
        elif ch == "," and not in_q:
            parts.append(cur)
            cur = ""
        else:
            cur += ch
    if cur:
        parts.append(cur)
    return parts


# ---------------------------------------------------------------- publisher
class MetricsPublisher:
    """Background thread PUT-ing periodic snapshots to the rendezvous KV
    (scope ``metrics``, key ``rank.N``) so the driver's ``/metrics`` route
    serves a fleet-wide view.  A final publish happens on close() so the
    end-of-run straggler report sees complete histograms."""

    SCOPE = "metrics"

    def __init__(self, addr: str, port: int, rank: int,
                 snapshot_fn: Callable[[], Dict[str, Any]],
                 interval: float = 5.0):
        self.addr = addr
        self.port = int(port)
        self.rank = int(rank)
        self.interval = max(0.1, float(interval))
        self._snapshot_fn = snapshot_fn
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if self.addr and self.port:
            self._thread = threading.Thread(target=self._loop, daemon=True)
            self._thread.start()

    def publish_now(self, retries: int = 3) -> bool:
        if not (self.addr and self.port):
            return False
        try:
            snap = self._snapshot_fn()
            snap["rank"] = self.rank
            body = json.dumps(snap).encode()
            # Sharded KV: the metrics scope may live on a shard server,
            # not the primary; resolve per publish.
            from ..runner.http_client import resolve_kv_addr
            addr, port, _ = resolve_kv_addr(self.addr, self.port,
                                            self.SCOPE)
            url = (f"http://{addr}:{port}/{self.SCOPE}/"
                   f"rank.{self.rank}")
            # Bounded retry: a transient refusal must not lose the FINAL
            # close() publish, which is what the straggler report reads.
            delay = 0.1
            for attempt in range(retries + 1):
                try:
                    req = urllib.request.Request(url, data=body,
                                                 method="PUT")
                    with urllib.request.urlopen(req, timeout=5):
                        pass
                    return True
                except Exception:
                    if attempt >= retries:
                        raise
                    time.sleep(delay)
                    delay = min(delay * 2, 1.0)
            return True
        except Exception:
            return False  # metrics must never take the job down

    def _loop(self) -> None:
        self.publish_now()
        while not self._stop.wait(self.interval):
            self.publish_now()

    def close(self) -> None:
        self._stop.set()
        self.publish_now()


# --------------------------------------------------------- straggler report
def _fmt_seconds(v: Optional[float]) -> str:
    if v is None:
        return "n/a"
    if v < 1e-3:
        return f"{v * 1e6:.0f}us"
    if v < 1.0:
        return f"{v * 1e3:.1f}ms"
    return f"{v:.2f}s"


def _hist_quantile(fam: Dict[str, Any], q: float) -> Optional[float]:
    """q-quantile (bucket upper bound) over ALL of a family's series."""
    bounds = fam.get("bounds", [])
    counts = [0] * len(bounds)
    total = 0
    for s in fam.get("samples", []):
        for i, c in enumerate(s.get("counts", [])[:len(bounds)]):
            counts[i] += c
        total += s.get("count", 0)
    if not total:
        return None
    target = q * total
    cum = 0
    for c, bound in zip(counts, bounds):
        cum += c
        if cum >= target:
            return float(bound)
    return float(bounds[-1]) if bounds else None


def _hist_count(fam: Dict[str, Any]) -> int:
    return sum(s.get("count", 0) for s in fam.get("samples", []))


def _age_rows(snapshots: Dict[int, Dict[str, Any]],
              family: str = "hvd_negotiation_age_seconds"
              ) -> List[Tuple[int, Optional[float], Optional[float], int]]:
    """Per-rank (rank, p50, p99, n) negotiation-age quantiles from
    harvested snapshots — the shared source of the end-of-run straggler
    report and the live in-run check (StragglerMonitor)."""
    rows = []
    for rank in sorted(snapshots):
        fam = snapshots[rank].get("families", {}).get(family)
        if not fam or not _hist_count(fam):
            # eager ages absent (pure SPMD run): fall back to the native
            # controller's negotiation ages, recorded on rank 0 only
            fam = snapshots[rank].get("families", {}).get(
                "hvd_controller_negotiation_age_seconds")
        if not fam or not _hist_count(fam):
            continue
        rows.append((rank, _hist_quantile(fam, 0.5),
                     _hist_quantile(fam, 0.99), _hist_count(fam)))
    return rows


def detect_straggler(snapshots: Dict[int, Dict[str, Any]],
                     skew_ratio: float = 4.0,
                     floor_seconds: float = 1e-3) -> Optional[Dict[str, Any]]:
    """Live straggler verdict from one round of fleet snapshots: the rank
    whose negotiation-age p99 exceeds ``skew_ratio`` times the median of
    its peers' p99s (and an absolute floor, so us-level jitter on an idle
    fleet never names anyone).  The default ratio is 4x because quantile
    estimates come from power-of-2 buckets: adjacent buckets differ by
    exactly 2x, so a 2x threshold would fire on quantization noise.
    None when no rank stands out or fewer than two ranks have data:
    detection needs a peer baseline (:func:`straggler_verdict`)."""
    rows = {r: p99 for r, _, p99, _ in _age_rows(snapshots)
            if p99 is not None}
    return straggler_verdict(rows, skew_ratio=skew_ratio,
                             floor_seconds=floor_seconds)


class StragglerMonitor:
    """Driver-side periodic straggler check (the in-run promotion of the
    end-of-run report): every ``interval`` seconds it re-reads the fleet's
    metric snapshots, logs a warning naming the suspect rank and sets the
    ``hvd_straggler_suspect`` gauge (-1 when nobody stands out).  Runs on
    the launcher, which owns the rendezvous KV the workers publish into
    (runner/launch.py)."""

    def __init__(self, snapshots_fn: Callable[[], Dict[int, Dict[str, Any]]],
                 interval: float, skew_ratio: float = 4.0,
                 log_fn: Optional[Callable[[str], None]] = None):
        self._snapshots_fn = snapshots_fn
        self.interval = max(0.1, float(interval))
        self.skew_ratio = float(skew_ratio)
        self._log = log_fn or (lambda msg: print(msg, flush=True))
        self._last_suspect: Optional[int] = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)

    def start(self) -> None:
        self._thread.start()

    def check_once(self) -> Optional[Dict[str, Any]]:
        try:
            verdict = detect_straggler(self._snapshots_fn(),
                                       skew_ratio=self.skew_ratio)
        except Exception:
            return None  # telemetry must never take the launcher down
        if verdict is None:
            STRAGGLER_SUSPECT.set(-1)
            self._last_suspect = None
            return None
        STRAGGLER_SUSPECT.set(verdict["rank"])
        if verdict["rank"] != self._last_suspect:  # warn on transitions,
            self._last_suspect = verdict["rank"]   # not every period
            self._log(
                f"[hvd] straggler suspect: rank {verdict['rank']} "
                f"(negotiation-age p99 {_fmt_seconds(verdict['p99'])} vs "
                f"peer median {_fmt_seconds(verdict['peer_median_p99'])})")
        return verdict

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            self.check_once()

    def stop(self) -> None:
        self._stop.set()


def straggler_report(snapshots: Dict[int, Dict[str, Any]],
                     family: str = "hvd_negotiation_age_seconds") -> str:
    """Rank-0 end-of-run report: per-rank negotiation-age p50/p99, naming
    the slowest rank (the fleet-level extension of the stall inspector —
    it tells you WHO was late, not only that someone was).

    ``snapshots`` maps rank -> snapshot dict (MetricsRegistry.snapshot()
    shape, as harvested from the rendezvous KV)."""
    rows = _age_rows(snapshots, family)
    if not rows:
        return ""
    slowest = max(rows, key=lambda r: (r[2] or 0.0, r[1] or 0.0))
    lines = ["[hvd] straggler report (negotiation age, per rank):"]
    for rank, p50, p99, n in rows:
        lines.append(f"  rank {rank}: p50={_fmt_seconds(p50)} "
                     f"p99={_fmt_seconds(p99)} (n={n})")
    lines.append(f"  slowest: rank {slowest[0]} "
                 f"(p99 {_fmt_seconds(slowest[2])})")
    return "\n".join(lines)
