"""The ``HOROVOD_*`` knobs this port reads: its own copy of the entries of
``horovod_tpu/common/knobs.py`` that the data-parallel training path, the
wire and overlap planes, the input prefetch and ZeRO
(``data/loader.py``, ``parallel/zero.py``), the 3D layout plane
(``parallel/layout.py``), the eager API's controller
(``runtime.ensure_core``), the serving engine (``serve/config.py``
``from_knobs``) and the launcher's rendezvous (``runner/``) need, with the
same names, defaults and parsing (env > override > default); ``current``
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
_knob("HOROVOD_AUTOTUNE", False, _parse_bool,
      "Enable Bayesian autotuning of fusion threshold and cycle time. Not "
      "ported yet: setting it raises at init.")
_knob("HOROVOD_TIMELINE", "", str,
      "Path of the Chrome-trace timeline JSON; empty disables. Not ported "
      "yet: setting it raises at init.")
_knob("HOROVOD_FLIGHT_RECORD", "", str,
      "Path of this rank's crash-time flight record. Not ported yet: "
      "setting it raises at init.")

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
