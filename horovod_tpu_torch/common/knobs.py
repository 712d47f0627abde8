"""The ``HOROVOD_*`` knobs this port reads: its own copy of the entries of
``horovod_tpu/common/knobs.py`` that the data-parallel training path, the
wire and overlap planes, the input prefetch and ZeRO
(``data/loader.py``, ``parallel/zero.py``), the 3D layout plane
(``parallel/layout.py``), the eager API's controller
(``runtime.ensure_core``), the serving engine (``serve/config.py``
``from_knobs``), the launcher's rendezvous (``runner/``) and the
measurement plane (``utils/``, ``common/hvdlogging.py``), the
perf-attribution plane (``perf/``) and the forensics planes
(``postmortem.py``, ``utils/health.py``, ``watch/``, ``chaos/``) need,
with the same names, defaults and parsing (env > override > default); ``current``
reads one live (env > the runtime's snapshot > default)."""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Dict, Optional


def _parse_bool(v: str) -> bool:
    return v.strip().lower() in ("1", "true", "yes", "on")


@dataclasses.dataclass(frozen=True)
class Knob:
    name: str
    default: Any
    parse: Callable[[str], Any]
    help: str


KNOBS: Dict[str, Knob] = {}


def _knob(name: str, default: Any, parse: Callable[[str], Any],
          help: str) -> None:
    KNOBS[name] = Knob(name, default, parse, help)


_knob("HOROVOD_FUSION_THRESHOLD", 128 * 1024 * 1024, int,
      "Bucket (tensor-fusion) threshold in bytes; gradients are packed into "
      "flat buckets of at most this size before a single fused allreduce.")
_knob("HOROVOD_CACHE_CAPACITY", 1024, int,
      "Bucket-plan cache capacity (entries). 0 disables caching.")
_knob("HOROVOD_HIERARCHICAL_ALLREDUCE", False, _parse_bool,
      "Two-level allreduce on a two-level layout (1 < HOROVOD_LOCAL_SIZE < "
      "HOROVOD_SIZE): reduce-scatter inside the host, allreduce across "
      "hosts, allgather inside the host (parallel/hierarchical.py).")
_knob("HOROVOD_HIERARCHICAL_ALLGATHER", False, _parse_bool,
      "Two-level allgather on a two-level layout: gather inside the host, "
      "then across hosts, in host-major order.")
# --- the wire-policy plane (ops/wire.py) ---
_knob("HOROVOD_WIRE_POLICY", "none", str,
      "Per-bucket wire format for the fused gradient sync (ops/wire.py): "
      "'none', 'bf16', 'fp16', 'int8_ring', 'dcn_int8' apply one format to "
      "every bucket; 'auto' picks per bucket by (nbytes, dtype, layout).  "
      "Unknown names fail at init().")
_knob("HOROVOD_WIRE_EF", True, _parse_bool,
      "Error-feedback residuals for lossy wire formats (EF-SGD): the "
      "per-bucket quantization/cast error is kept per parameter and added "
      "back into the next step's gradient before compression.  Only "
      "consulted when a lossy wire policy is requested by argument.")
# --- the overlap plane (ops/overlap.py) ---
_knob("HOROVOD_OVERLAP", False, _parse_bool,
      "Enable the overlap plane (ops/overlap.py): with "
      "backward_passes_per_step > 1 the fused gradient sync of microbatch "
      "i runs on a side stream while microbatch i+1's forward/backward "
      "computes (numerically a scheduling change only).")
_knob("HOROVOD_OVERLAP_DEPTH", 1, int,
      "Microbatch-pipeline depth: how many gradient syncs may be in flight "
      "before the oldest is waited for.  Must be in [1, 8]; rejected at "
      "init() otherwise.")
_knob("HOROVOD_PREFETCH_DEPTH", 2, int,
      "Device-prefetch depth of data.loader.prefetch(): how many batches "
      "are copied to the device ahead of the step consuming them (2 = "
      "double buffered).  Must be >= 1; rejected at init() otherwise.")
# --- ZeRO weight-update sharding (parallel/zero.py) ---
_knob("HOROVOD_ZERO_LEVEL", 1, int,
      "Default ZeRO weight-update sharding level of the zero chain "
      "(parallel/zero.py; the zero_level argument wins): 1 shards the "
      "optimizer state 1/n along the fusion-bucket plan, 2 also keeps "
      "gradient shards (accumulation on the 1/n shard), 3 also keeps the "
      "parameters sharded between steps, gathered bucket by bucket at "
      "step start.  0 = off (plain data parallelism).  Must be in "
      "{0, 1, 2, 3}; rejected at init() otherwise.")
_knob("HOROVOD_ZERO_AG_PREFETCH", 2, int,
      "ZeRO-3 parameter all-gather prefetch depth: how many bucket "
      "gathers the level-3 step keeps in flight ahead of the bucket being "
      "unpacked at step start (plan order).  Must be in [1, 8]; rejected "
      "at init() otherwise.")
# --- the 3D layout plane (parallel/layout.py) ---
_knob("HOROVOD_LAYOUT", "", str,
      "Process layout policy (parallel/layout.py): '' leaves the flat "
      "data-parallel group; 'auto' runs the perf/costmodel.solve_layout "
      "ranking at init and builds the winning dp x tp x pp subgroups; "
      "'dp-only' pins (world, 1, 1); an explicit 'dp,tp,pp' triple pins "
      "that factorization.  dp*tp*pp must equal the world size.  Rejected "
      "at init() otherwise.")
_knob("HOROVOD_TP", 0, int,
      "Tensor-parallel degree constraint for HOROVOD_LAYOUT=auto (the "
      "solver only considers candidates with this tp), cross-checked "
      "against an explicit 'dp,tp,pp' triple.  0 = unconstrained.  Must be "
      ">= 0, divide the world size, and (for the llama family) divide "
      "n_heads and n_kv_heads; rejected at init() or step-build time "
      "otherwise.")
_knob("HOROVOD_PP", 0, int,
      "Pipeline-parallel degree constraint for HOROVOD_LAYOUT=auto (the "
      "solver only considers candidates with this pp), cross-checked "
      "against an explicit 'dp,tp,pp' triple.  0 = unconstrained.  Must be "
      ">= 0, divide the world size, and (for the llama family) divide "
      "n_layers; rejected at init() or step-build time otherwise.")
_knob("HOROVOD_RANK", -1, int, "Global process rank assigned by the launcher.")
_knob("HOROVOD_SIZE", -1, int, "Global process count assigned by the launcher.")
_knob("HOROVOD_LOCAL_RANK", -1, int, "Process rank within its host.")
_knob("HOROVOD_LOCAL_SIZE", -1, int, "Process count on this host.")
_knob("HOROVOD_COORDINATOR_ADDR", "", str,
      "host:port of the rendezvous for multi-process runs (rank 0 serves "
      "the torch.distributed TCP store there).")
_knob("HOROVOD_CROSS_RANK", -1, int, "Host index of this process.")
_knob("HOROVOD_CROSS_SIZE", -1, int, "Number of hosts.")
_knob("HOROVOD_HOSTNAME", "", str, "Hostname assigned by the launcher.")
# --- the launcher and its rendezvous KV (runner/) ---
_knob("HOROVOD_START_TIMEOUT", 300, int,
      "Seconds a worker waits for the torch.distributed store at "
      "HOROVOD_COORDINATOR_ADDR during bring-up before giving up "
      "(reference: horovodrun --start-timeout).")
_knob("HOROVOD_GLOO_TIMEOUT_SECONDS", 30, int,
      "Rendezvous KV client patience: how long a worker polls the HTTP "
      "rendezvous for a key before giving up (reference: "
      "--gloo-timeout-seconds).")
_knob("HOROVOD_RENDEZVOUS_ADDR", "", str, "Rendezvous HTTP server address.")
_knob("HOROVOD_RENDEZVOUS_PORT", 0, int, "Rendezvous HTTP server port.")
_knob("HOROVOD_KV_RETRIES", 4, int,
      "Max retries for rendezvous KV writes on transient connection "
      "errors, with exponential backoff + jitter.")
_knob("HOROVOD_KV_RETRY_BACKOFF_MS", 100, int,
      "Initial rendezvous KV retry backoff in ms (doubles per attempt, "
      "capped at 2000 ms, jittered).")
_knob("HOROVOD_KV_SHARDS", 1, int,
      "Rendezvous-KV shard count (the launcher's --kv-shards): every scope "
      "is owned by exactly one shard server per the deterministic "
      "scope->shard map (runner/kvshard.py).  Must be >= 1; rejected at "
      "init() otherwise.")
_knob("HOROVOD_KV_SHARD_ADDRS", "", str,
      "Comma-separated host:port list of the KV shard servers, primary "
      "(shard 0) first, stamped by the launcher when HOROVOD_KV_SHARDS > 1 "
      "and read by runner/http_client's per-scope routing.  Must list "
      "HOROVOD_KV_SHARDS entries; rejected at init() otherwise.  Empty = "
      "unsharded.")

# --- the eager API's native controller (runtime.ensure_core) ---
_knob("HOROVOD_CONTROLLER", "auto", str,
      "Eager-mode coordination controller: 'auto' (tcp when multi-process, "
      "none single-process), 'tcp', or 'none'.")
_knob("HOROVOD_CONTROLLER_PORT", 29499, int,
      "TCP port of the rank-0 controller listener.")
_knob("HOROVOD_CYCLE_TIME", 1.0, float,
      "Background coordination cycle time in milliseconds (eager frontends).")
_knob("HOROVOD_STALL_CHECK_TIME_SECONDS", 60, int,
      "Warn when ranks disagree about a tensor for this long.")
_knob("HOROVOD_STALL_CHECK_DISABLE", False, _parse_bool,
      "Disable the stalled-tensor watchdog.")
_knob("HOROVOD_STALL_SHUTDOWN_TIME_SECONDS", 0, int,
      "Abort training when a stall exceeds this many seconds (0 = never).")
# --- the measurement plane (utils/: metrics, timeline, autotune, stall) ---
_knob("HOROVOD_AUTOTUNE", False, _parse_bool,
      "Enable Bayesian autotuning of fusion threshold and cycle time.")
_knob("HOROVOD_AUTOTUNE_LOG", "", str, "CSV log file for autotune samples.")
_knob("HOROVOD_AUTOTUNE_WARMUP_SAMPLES", 3, int, "Autotune warmup discard count.")
_knob("HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE", 10, int, "Steps per autotune sample.")
_knob("HOROVOD_AUTOTUNE_BAYES_OPT_MAX_SAMPLES", 20, int, "Max BO samples.")
_knob("HOROVOD_AUTOTUNE_GAUSSIAN_PROCESS_NOISE", 0.8, float, "GP noise level.")
_knob("HOROVOD_TIMELINE", "", str,
      "Path of the Chrome-trace timeline JSON; empty disables. 'DYNAMIC' "
      "registers the file lazily on start_timeline().")
_knob("HOROVOD_TIMELINE_MARK_CYCLES", False, _parse_bool,
      "Mark coordination cycles in the timeline.")
_knob("HOROVOD_TIMELINE_MERGE_INTERVAL", 5.0, float,
      "Seconds between trace-chunk publishes to the rendezvous KV scope "
      "'timeline' (each publish also re-measures the rank's clock offset). "
      "Workers publish whenever a timeline is active and a rendezvous "
      "server is known; the launcher serves the merge at GET /timeline and "
      "writes it with --timeline-merge.")
_knob("HOROVOD_STRAGGLER_CHECK_SECS", 0.0, float,
      "Driver-side live straggler check period in seconds: every period "
      "the launcher compares per-rank negotiation-age p99 across the "
      "fleet's metric snapshots, logs a warning naming the suspect rank "
      "and sets the hvd_straggler_suspect gauge.  0 disables.  Needs the "
      "metrics plane (HOROVOD_METRICS / --metrics-port).")
_knob("HOROVOD_METRICS", False, _parse_bool,
      "Enable the metrics plane: every worker records Counter/Gauge/"
      "Histogram telemetry (utils/metrics.py) and publishes periodic "
      "snapshots to the rendezvous KV; the launcher serves the fleet view "
      "at /metrics (Prometheus text) and prints the end-of-run straggler "
      "report.")
_knob("HOROVOD_METRICS_INTERVAL", 5.0, float,
      "Seconds between metric-snapshot publishes to the rendezvous KV.")
_knob("HOROVOD_PERF", False, _parse_bool,
      "Enable the performance-attribution plane's publisher: the step-time "
      "decomposition ledger (hvd.perf_report(), hvd_perf_* metric "
      "families) publishes per-rank perf reports to the rendezvous KV "
      "scope 'perf', merged at GET /perf and rendered by `launch doctor "
      "--perf` (horovod_tpu_torch/perf/).")
_knob("HOROVOD_PERF_INTERVAL", 5.0, float,
      "Seconds between perf-report publishes to the rendezvous KV.  "
      "Must be positive; rejected at init() otherwise.")
_knob("HOROVOD_PERF_LINK", "auto", str,
      "Link class the roofline cost model prices gradient sync with: "
      "'ici', 'dcn', 'loopback', 'nvlink', or 'auto' (by topology: ranks "
      "on more than one host -> dcn, CUDA ranks on one host -> nvlink, "
      "the CPU -> loopback).  Unknown names fail at init().")
_knob("HOROVOD_MEM", True, _parse_bool,
      "Memory-plane kill switch (perf/memstats.py): with it on, each "
      "metrics snapshot samples torch.cuda.memory_stats() (on the CPU: "
      "the live tensors' storages + /proc RSS), attributes bytes to "
      "planes, updates the hvd_mem_* families, reconciles against the "
      "zero_memory_bytes prediction, and arms the OOM-proximity "
      "sentinel.  0 = no sampling, no mem section in perf reports.")
_knob("HOROVOD_MEM_INTERVAL", 0.0, float,
      "Minimum seconds between memory samples (memstats.MemSampler): 0 "
      "samples on every metrics snapshot; a positive value rate-limits "
      "the sampler.  Must be >= 0; rejected at init() otherwise.")
_knob("HOROVOD_MEM_HIGH_WATERMARK", 0.9, float,
      "OOM-proximity threshold as a fraction of the device memory cap: "
      "crossing it fires the mem sentinel once per transition (counter, "
      "timeline instant, warning).  Must be in (0, 1]; rejected at "
      "init() otherwise.")
_knob("HOROVOD_LOG_LEVEL", "warning", str,
      "trace|debug|info|warning|error|fatal")
_knob("HOROVOD_LOG_HIDE_TIME", False, _parse_bool, "Hide timestamps in logs.")
# --- the watch plane (watch/) ---
_knob("HOROVOD_SERIES_RETENTION", 600.0, float,
      "Fleet time-series history horizon in seconds (watch plane, "
      "horovod_tpu_torch/watch/series.py): the rendezvous server keeps one "
      "bounded downsampling ring per (rank, metric family), fed by the "
      "metric snapshots workers already publish, served at GET /series "
      "and evaluated by the alert rules engine.  Ring memory is "
      "retention/resolution points per series, enforced.  Must be "
      "positive; rejected at init() otherwise.")
_knob("HOROVOD_SERIES_RESOLUTION", 5.0, float,
      "Fleet time-series bucket width in seconds (watch plane): samples "
      "landing inside one resolution bucket replace the bucket's point "
      "(last wins), and metrics-scope ingest is rate-limited per rank "
      "to this cadence.  Must be positive and no larger than "
      "HOROVOD_SERIES_RETENTION; rejected at init() otherwise.")
_knob("HOROVOD_ALERTS", "", str,
      "Path of a YAML alert-rules file (watch plane, "
      "horovod_tpu_torch/watch/rules.py): rules merge over the committed "
      "default ruleset by name, are published to the rendezvous KV "
      "scope 'alerts' and evaluated by the driver's engine — firing "
      "alerts surface at GET /alerts, as merged-timeline instants and "
      "as the hvd_alerts_* families.  Equivalent to launch --alerts.  "
      "When set, the file must exist and parse; rejected at init() "
      "otherwise.  Empty = defaults only.")
_knob("HOROVOD_SENTINEL", True, _parse_bool,
      "Training-quality sentinel kill switch (watch plane, "
      "horovod_tpu_torch/watch/sentinel.py): with it on, hvd.sentinel.wrap "
      "computes the global grad-norm, the nonfinite count (summed over "
      "the group: the same verdict on every rank) and loss EMA/divergence "
      "scalars that ride the existing metrics publisher; a nonfinite "
      "step triggers an explicit native flight dump (reason 'nan') and "
      "the committed sentinel-nonfinite critical rule.  0 = "
      "hvd.sentinel.wrap returns the step untouched.")
_knob("HOROVOD_SENTINEL_INTERVAL", 1, int,
      "Sentinel gauge/EMA update cadence in recorded steps (1 = every "
      "step).  Nonfinite detection always runs every recorded step — a "
      "NaN must never slip between samples.  Must be >= 1; rejected at "
      "init() otherwise.")
# --- the scenario plane (scenario/; docs/scenarios.md) ---
_knob("HOROVOD_SCENARIO", "", str,
      "Path of a scenario spec (horovod_tpu_torch/scenario; "
      "docs/scenarios.md): a declarative YAML composing a workload "
      "trace (arrival processes, heavy-tailed request shapes, mixed "
      "train+serve phases) with a fault storm, an SLO expectation and "
      "an alert expectation.  Equivalent to launch --scenario: "
      "validated at launch, published to rendezvous-KV scope "
      "'scenario', its storm merged with any --chaos spec and its "
      "alert rules installed.  When set, the file must exist and "
      "parse; rejected at init() otherwise.  Empty = none.")
_knob("HOROVOD_SCENARIO_RANKS", 0, int,
      "Virtual-rank-count override for scenario replay (scenario/"
      "harness.py): 0 = the spec's virtual_ranks.  The generated event "
      "stream is byte-identical at any rank count (rank attribution is "
      "a pure replay-time function); this only re-scatters request "
      "sources.  Must be >= 0; rejected at init() otherwise.")
_knob("HOROVOD_SCENARIO_TICK_MS", 0.0, float,
      "Logical-tick-length override in ms for scenario replay (one "
      "tick = one engine step on the virtual clock): 0 = the spec's "
      "tick_ms.  Must be >= 0; rejected at init() otherwise.")
# --- the postmortem plane (postmortem.py, utils/health.py) ---
_knob("HOROVOD_HEARTBEAT", False, _parse_bool,
      "Enable per-rank heartbeats: a background thread PUTs a liveness "
      "snapshot (step, native cycle progress, queue depth, pending "
      "collectives) to the rendezvous KV scope 'health' on the aligned "
      "fleet clock; the launcher serves the fleet view at /health with "
      "per-rank staleness and supervises progress.  launch --postmortem "
      "implies this.")
_knob("HOROVOD_HEARTBEAT_INTERVAL", 1.0, float,
      "Seconds between heartbeat publishes to the rendezvous KV.")
_knob("HOROVOD_HEARTBEAT_TIMEOUT", 10.0, float,
      "Driver-side supervision threshold in seconds: a rank whose "
      "heartbeat goes silent for this long is declared heartbeat-lost; "
      "a rank whose recorded step stops advancing for this long while "
      "heartbeats continue is declared stalled and killed with SIGABRT "
      "so its flight record is captured (launch --postmortem).")
_knob("HOROVOD_FLIGHT_RECORD", "", str,
      "Path of this rank's crash-time flight record: when set, the "
      "native core arms fatal-signal/std::terminate handlers that dump "
      "the trace-ring tail, metrics snapshot and tensor-queue/transport "
      "state there (csrc/core/postmortem.cc).  launch --postmortem sets a "
      "per-rank path automatically.")
_knob("HOROVOD_POSTMORTEM_DIR", "", str,
      "Directory for crash forensics: launch collects per-rank flight "
      "records, log tails and final heartbeats there and writes "
      "postmortem.json on abnormal exit (render with `launch doctor`). "
      "Equivalent to the --postmortem flag.")
# --- the chaos plane (chaos/) ---
_knob("HOROVOD_CHAOS", False, _parse_bool,
      "Enable the chaos plane: workers fetch the fault-injection spec "
      "from the rendezvous KV (scope 'chaos', published by launch "
      "--chaos) and install a deterministic per-rank injector.")
_knob("HOROVOD_CHAOS_SPEC", "", str,
      "Path to a chaos spec YAML (horovod_tpu_torch/chaos/spec.py); used when "
      "no rendezvous-distributed spec is available.")
_knob("HOROVOD_CHAOS_SEED", 0, int,
      "Base seed of the chaos plane; every rank derives an independent "
      "deterministic stream from it (native and Python injectors).")
_knob("HOROVOD_CHAOS_TCP_RANK", -1, int,
      "Restrict native transport fault injection to this rank (-1=all).")
_knob("HOROVOD_CHAOS_TCP_CLOSE_AFTER", 0, int,
      "Close the controller socket before the Nth frame operation "
      "(one-shot, deterministic; 0 disables).")
_knob("HOROVOD_CHAOS_TCP_CLOSE_RATE", 0.0, float,
      "Per-frame-op probability of an injected controller socket close.")
_knob("HOROVOD_CHAOS_TCP_DROP_RATE", 0.0, float,
      "Per-frame-op probability of an injected frame drop (+ close: TCP "
      "cannot lose a frame on a live connection).")
_knob("HOROVOD_CHAOS_TCP_DUP_RATE", 0.0, float,
      "Per-frame-op probability of an injected duplicate frame "
      "(exercises receiver seq dedup).")
_knob("HOROVOD_CHAOS_TCP_DELAY_RATE", 0.0, float,
      "Per-frame-op probability of an injected delay.")
_knob("HOROVOD_CHAOS_TCP_DELAY_MS", 0, int,
      "Injected transport delay length in milliseconds.")

_knob("HOROVOD_SERVE_PORT", 0, int,
      "Port of the serving fleet's request router (0 = ephemeral). Must be "
      "in [0, 65535].")
_knob("HOROVOD_SERVE_MAX_BATCH_TOKENS", 2048, int,
      "Continuous-batching budget: prompt + decode tokens one engine tick "
      "may process across the slot table. Must be positive.")
_knob("HOROVOD_SERVE_MAX_SEQ_LEN", 2048, int,
      "Per-request cap on prompt + generated tokens; sizes the block "
      "tables. Must be positive and at most the model's max_seq.")
_knob("HOROVOD_SERVE_CACHE_BLOCKS", 4096, int,
      "Blocks in the preallocated paged KV pool. Must be positive.")
_knob("HOROVOD_SERVE_PREFILL_CHUNK", 64, int,
      "Chunked-prefill width: prompt tokens one tick may prefill per slot "
      "(the step's row width). Must be in [1, max_batch_tokens].")
_knob("HOROVOD_SERVE_PREFIX_CACHE", True, _parse_bool,
      "Refcounted radix prefix cache over the paged pool (copy-on-write on "
      "divergence inside a block). Output is unchanged; 0 disables.")
_knob("HOROVOD_SERVE_SPEC", True, _parse_bool,
      "Speculative decoding by prompt-lookup drafts with greedy "
      "verification. Output is unchanged; 0 disables.")
_knob("HOROVOD_SERVE_SPEC_K", 4, int,
      "Draft length per decode slot and tick. Must be >= 1 and "
      "spec_k + 1 <= prefill_chunk.")
_knob("HOROVOD_SERVE_REPLICAS", 1, int,
      "Replicated serving tier size. Must be >= 1.")
_knob("HOROVOD_SERVE_REPLICA_ID", 0, int,
      "This fleet's identity within the replica tier, in "
      "[0, HOROVOD_SERVE_REPLICAS).")
_knob("HOROVOD_SERVE_PREFILL_RANKS", 0, int,
      "Prefill/decode disaggregation: the first K ranks only prefill "
      "(0 = colocated). Must be >= 0.")
_knob("HOROVOD_SERVE_SPILL_BLOCKS", 0, int,
      "Host-RAM KV spill capacity in blocks behind the device pool (0 = "
      "off). Needs the prefix cache on; must be >= 0.")
_knob("HOROVOD_SERVE_JOURNAL", True, _parse_bool,
      "Request journal + redrive: the router journals every accepted "
      "request to KV scope 'serve_journal'; after a fleet reset the new "
      "rank 0 re-admits unfinished requests past their already-streamed "
      "prefix. 0 disables (a reset drops in-flight requests).")
_knob("HOROVOD_SERVE_DRAIN_TIMEOUT", 30.0, float,
      "Graceful-drain budget in seconds (POST /admin/drain): how long the "
      "router waits for the fleet's drained ack, and how long rank 0 keeps "
      "serving in-flight work after the signal. Must be positive.")
_knob("HOROVOD_SERVE_SHED_HIGH", 0, int,
      "Load-shedding high watermark on pending requests: at or above it "
      "the router answers 429 + Retry-After until the low watermark. 0 = "
      "the router's max_pending. Must be >= 0 and >= the low watermark.")
_knob("HOROVOD_SERVE_SHED_LOW", 0, int,
      "Load-shedding low watermark (hysteresis): admission resumes when "
      "pending requests fall to it. 0 = high - max(1, high / 4). Must be "
      ">= 0.")
_knob("HOROVOD_SERVE_DIRECT", True, _parse_bool,
      "Direct token streaming: rank 0 streams token parts to the router "
      "over one chunked POST /serve/stream connection, mirrored into "
      "'serve_out'; on connection loss each record falls back to a KV PUT. "
      "0 = every part rides the KV.")
_knob("HOROVOD_SERVE_POLL_INTERVAL", 0.02, float,
      "Base seconds between the router's 'serve_out' probes while it "
      "streams a response (the fallback cadence behind the wakeup "
      "condition). Must be positive.")
_knob("HOROVOD_SERVE_REPLICA_DEAD_S", 3.0, float,
      "Dark-replica threshold in seconds: a replica whose stats heartbeat "
      "is older is routed around and its streams re-dispatched to a "
      "survivor. Must be positive.")
_knob("HOROVOD_SERVE_AFFINITY", True, _parse_bool,
      "Prefix-affinity routing over the replicas' advertised radix-tree "
      "fingerprints; misses fall back to least-loaded. 0 = least-loaded "
      "only.")
# --- elastic (elastic/; reference: elastic/constants.py, driver.py:69-93) ---
_knob("HOROVOD_ELASTIC_TIMEOUT", 600, int,
      "Seconds to wait for the required number of slots in elastic mode.")
_knob("HOROVOD_ELASTIC_RESET_LIMIT", 0, int,
      "Max elastic reset rounds before giving up (0 = unlimited).")
_knob("HOROVOD_ELASTIC_ROUND", 0, int,
      "Reset-round number (0 on the first round and under the static "
      "launcher). The serving fleet uses it as the plan-stream epoch: "
      "'serve_plan' keys are namespaced by it, so a restarted fleet never "
      "replays a previous incarnation's plan.")


class Knobs:
    """A parsed snapshot of the knobs; values resolve env > override >
    default."""

    def __init__(self, overrides: Optional[Dict[str, Any]] = None):
        overrides = overrides or {}
        unknown = set(overrides) - set(KNOBS)
        if unknown:
            raise ValueError(f"unknown knobs: {sorted(unknown)}")
        self._values: Dict[str, Any] = {}
        for name, knob in KNOBS.items():
            env = os.environ.get(name, "")
            if env != "":
                self._values[name] = knob.parse(env)
            elif name in overrides:
                self._values[name] = overrides[name]
            else:
                self._values[name] = knob.default

    def __getitem__(self, name: str) -> Any:
        return self._values[name]


def current(name: str) -> Any:
    """Live value of a knob: env > the initialized runtime's snapshot >
    default, so tests and launchers switch a plane without re-running
    ``init``."""
    knob = KNOBS[name]
    env = os.environ.get(name, "")
    if env != "":
        return knob.parse(env)
    from .. import runtime as _rt
    if _rt.is_initialized():
        return _rt.get().knobs[name]
    return knob.default
