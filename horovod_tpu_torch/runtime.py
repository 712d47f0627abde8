"""Process-global runtime: the port of ``horovod_tpu/runtime.py``'s
``Runtime``/``init``/``shutdown`` over ``torch.distributed``.

One process drives one device.  The process group is NCCL on a CUDA device
and gloo on the CPU.  With ``HOROVOD_SIZE > 1`` (what the launcher,
``python -m horovod_tpu_torch.runner.launch``, stamps) the group
rendezvouses at ``HOROVOD_COORDINATOR_ADDR`` with rank ``HOROVOD_RANK``,
waiting at most ``HOROVOD_START_TIMEOUT`` seconds for its peers; a single
process uses an in-process store and opens no port.  ``shutdown`` then
``init`` in one process (an elastic hard reset, ``elastic/worker.py``)
comes back whole: the TCP store is kept for the process and each init
rendezvouses in a namespace of its own, ``shutdown`` destroys every
process group (freeing its communicators) and folds the native core's
counters into the metrics registry before it closes the core, and the
``atexit`` hook is registered once.  The device is
``cuda:<local_rank>`` unless the caller passes ``device="cpu"``; with no
CUDA device and no ``device="cpu"``, ``init`` raises.

The eager API (``horovod_tpu_torch.torch``) negotiates its collectives
through the native controller (``common/basics.py``), which
``ensure_core`` brings up as ``horovod_tpu/runtime.py``'s does: with
``HOROVOD_CONTROLLER=tcp`` at ``init``, with ``auto`` (the default) on first
use when the job has more than one process, never with ``none``.  Rank 0
listens on ``HOROVOD_CONTROLLER_PORT`` at the host of
``HOROVOD_COORDINATOR_ADDR`` (127.0.0.1 when unset).

With ``HOROVOD_LAYOUT`` set, ``init`` resolves the (dp, tp, pp) layout of
the world (``parallel/layout.py``; ``auto`` through the cost model's
solver) after checking the layout knobs, and builds this rank's dp, tp and
pp subgroups (``Runtime.layout``).  With it unset there is no layout.

The measurement plane (``utils/``) is built at ``init`` as the JAX
runtime builds it: the clock sync against the rendezvous (when one is
named and a timeline is on), the ``Timeline`` (``HOROVOD_TIMELINE``) and
its chunk publisher, the ``Autotuner`` (``HOROVOD_AUTOTUNE``; with the
wire-policy arms under ``HOROVOD_WIRE_POLICY=auto`` and the depth arms
when overlap is on), the ``StallInspector`` (unless
``HOROVOD_STALL_CHECK_DISABLE``), the ``MetricsPublisher``
(``HOROVOD_METRICS``) and the perf plane's ``PerfPublisher``
(``HOROVOD_PERF``; ``perf/ledger.py``), whose link class it resolves.
The forensics planes follow: the heartbeat publisher
(``HOROVOD_HEARTBEAT``, ``utils/health.py``) and the chaos injector
(``chaos/``); the watch knobs are checked, and the native core arms its
flight recorder under ``HOROVOD_FLIGHT_RECORD`` when it comes up.
Each metrics snapshot imports the native core's per-op aggregates and
takes a memory sample (``perf/memstats.py``, under ``HOROVOD_MEM``).  The native core, when it comes up, gets the
autotune switch and the trace drainer.  ``fusion_threshold``,
``wire_policy``, ``overlap_depth`` and ``zero_ag_prefetch`` follow the
autotuner while it tunes.
"""

from __future__ import annotations

import atexit
import datetime
import threading
from typing import Any, Dict, Optional, Union

import torch
import torch.distributed as dist

from .common.knobs import Knobs, current
from .ops.fusion import BucketPlanCache
from .ops.overlap import validate_overlap_knobs
from .ops.wire import validate_policy_name

_runtime: Optional["Runtime"] = None
_lock = threading.Lock()
_atexit_registered = False
_stores: Dict[tuple, list] = {}  # (host, port, size, rank) -> [store, inits]


def _pick_device(device: Union[str, torch.device, None],
                 local_rank: int) -> torch.device:
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "horovod_tpu_torch: no CUDA device; pass device='cpu' to run on "
            "the CPU")
    return torch.device("cuda", local_rank)


def _coordinator_store(host: str, port: int, size: int, rank: int,
                       timeout_s: float):
    """The rendezvous store of the process group at ``host:port``: the
    TCP store is made once a process (rank 0 serves it) and kept, and
    each ``init`` on it takes a namespace of its own.  An elastic hard
    reset shuts down and initializes again in the same process; a new
    server on the same port would race the peers' reconnects (a peer could
    reach the closing server), and ranks that reset together count their
    inits alike.  The store's timeout bounds the bring-up only; the
    group's collectives keep the backend's own timeout."""
    key = (host, port, size, rank)
    entry = _stores.get(key)
    if entry is None:
        entry = _stores[key] = [dist.TCPStore(
            host, port, size, is_master=rank == 0,
            timeout=datetime.timedelta(seconds=timeout_s)), 0]
    entry[1] += 1
    return dist.PrefixStore(f"hvd.init.{entry[1]}", entry[0])


def validate_kv_knobs(knobs) -> None:
    """The launcher's KV shard knobs, checked at ``init`` as
    ``horovod_tpu/runtime.py`` checks them, so a malformed map fails
    bring-up, not a KV op mid-run (``runner/http_client.py`` reads the env
    lazily, so nothing is installed)."""
    n = knobs["HOROVOD_KV_SHARDS"]
    if n < 1:
        raise ValueError(
            f"HOROVOD_KV_SHARDS={n} invalid; the rendezvous KV needs at "
            "least one shard (docs/control-plane.md)")
    if knobs["HOROVOD_KV_SHARD_ADDRS"]:
        from .runner.kvshard import parse_shard_addrs
        addrs = parse_shard_addrs(knobs["HOROVOD_KV_SHARD_ADDRS"])
        if len(addrs) != n:
            raise ValueError(
                f"HOROVOD_KV_SHARD_ADDRS lists {len(addrs)} shard(s) but "
                f"HOROVOD_KV_SHARDS={n}; the scope->shard map is a modulus "
                "of the count, so the two must agree "
                "(docs/control-plane.md)")


class Runtime:
    """Holds the process group (and, on a two-level layout, this rank's
    host and cross-host groups; under ``HOROVOD_LAYOUT``, its dp, tp and pp
    subgroups), the device, the knobs and the bucket-plan cache of this
    process."""

    def __init__(self, knobs: Knobs,
                 device: Union[str, torch.device, None] = None):
        self.knobs = knobs
        validate_policy_name(knobs["HOROVOD_WIRE_POLICY"])
        validate_overlap_knobs(knobs)
        from .parallel.zero import validate_zero_knobs
        validate_zero_knobs(knobs)
        from .serve.config import validate_serve_knobs
        validate_serve_knobs(knobs)
        from .parallel.layout import (build_layout, resolve_layout,
                                      validate_layout_knobs)
        validate_kv_knobs(knobs)
        from .watch import validate_watch_knobs
        validate_watch_knobs(knobs)
        from .perf import validate_mem_knobs, validate_perf_knobs
        validate_perf_knobs(knobs)
        validate_mem_knobs(knobs)
        self._controller = knobs["HOROVOD_CONTROLLER"].strip().lower()
        if self._controller not in ("auto", "tcp", "none"):
            raise ValueError(
                f"HOROVOD_CONTROLLER={knobs['HOROVOD_CONTROLLER']!r}: use "
                "'auto', 'tcp' or 'none'")
        self.core = None
        self.eager: Any = None  # the eager API's state (torch/mpi_ops.py)
        self.clock_sync = None
        self.timeline = None
        self.timeline_publisher = None
        self._trace_drainer = None
        self.autotuner = None
        self.stall_inspector = None
        self.metrics_publisher = None
        self.perf_publisher = None
        self.heartbeat = None
        self._size = max(knobs["HOROVOD_SIZE"], 1)
        self._rank = max(knobs["HOROVOD_RANK"], 0)
        self._local_rank = max(knobs["HOROVOD_LOCAL_RANK"], 0)
        local_size = knobs["HOROVOD_LOCAL_SIZE"]
        self._local_size = local_size if local_size > 0 else self._size
        if 1 < self._local_size < self._size and \
                self._size % self._local_size:
            raise ValueError(
                f"HOROVOD_LOCAL_SIZE={self._local_size} does not divide "
                f"HOROVOD_SIZE={self._size}: a two-level layout needs as "
                "many ranks on every host")
        validate_layout_knobs(knobs, world=self._size)
        dims = resolve_layout(self._size, knobs)
        self.device = _pick_device(device, self._local_rank)
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        self.plan_cache = BucketPlanCache(knobs["HOROVOD_CACHE_CAPACITY"])

        self._owns_group = not dist.is_initialized()
        if self._owns_group:
            backend = "nccl" if self.device.type == "cuda" else "gloo"
            if self._size > 1:
                coord = knobs["HOROVOD_COORDINATOR_ADDR"]
                if not coord:
                    raise RuntimeError(
                        "HOROVOD_SIZE > 1 needs HOROVOD_COORDINATOR_ADDR "
                        "(host:port) for the rendezvous")
                host, _, port = coord.rpartition(":")
                store = _coordinator_store(
                    host, int(port), self._size, self._rank,
                    knobs["HOROVOD_START_TIMEOUT"])
                dist.init_process_group(backend, store=store,
                                        rank=self._rank,
                                        world_size=self._size)
            else:
                dist.init_process_group(backend, store=dist.HashStore(),
                                        rank=0, world_size=1)
        if dist.get_world_size() != self._size or dist.get_rank() != self._rank:
            raise RuntimeError(
                f"process group is rank {dist.get_rank()} of "
                f"{dist.get_world_size()}, but the knobs say rank "
                f"{self._rank} of {self._size}")
        self.hierarchy = self._build_hierarchy()
        # this rank's coordinate and dp, tp and pp subgroups, or None
        self.layout = build_layout(*dims) if dims is not None else None
        self._start_measurement()
        self._start_forensics()
        if self._controller == "tcp":
            self.ensure_core()

    def _start_measurement(self) -> None:
        """The measurement plane of this rank (``horovod_tpu/runtime.py``
        :129-290): clock sync, timeline and publisher, autotuner, stall
        inspector, metrics publisher."""
        knobs = self.knobs
        rdv_addr = knobs["HOROVOD_RENDEZVOUS_ADDR"]
        rdv_port = knobs["HOROVOD_RENDEZVOUS_PORT"]
        path = knobs["HOROVOD_TIMELINE"]
        if rdv_addr and rdv_port and (path or knobs["HOROVOD_HEARTBEAT"]):
            # heartbeats ride the trace's aligned fleet clock: the
            # postmortem orders the ranks' last events by it
            from .utils.clocksync import ClockSync
            self.clock_sync = ClockSync(rdv_addr, rdv_port)
        if path and path != "DYNAMIC":
            from .utils.timeline import Timeline
            self.timeline = Timeline(
                path, mark_cycles=knobs["HOROVOD_TIMELINE_MARK_CYCLES"],
                clock=self.clock_sync, rank=self._rank)
            self._start_timeline_publisher()
        if knobs["HOROVOD_AUTOTUNE"]:
            from .utils.autotune import Autotuner
            policy_arms = None
            if knobs["HOROVOD_WIRE_POLICY"] == "auto":
                policy_arms = ["auto", "none", "bf16", "int8_ring"]
                if self.hierarchy is not None:
                    policy_arms.append("dcn_int8")
            depth_arms = None
            if knobs["HOROVOD_OVERLAP"]:
                depth_arms = sorted({1, 2, 4,
                                     int(knobs["HOROVOD_OVERLAP_DEPTH"])})
            self.autotuner = Autotuner(knobs, process_rank=self._rank,
                                       process_size=self._size,
                                       policy_arms=policy_arms,
                                       depth_arms=depth_arms,
                                       device=self.device)
        if not knobs["HOROVOD_STALL_CHECK_DISABLE"]:
            from .utils.stall import StallInspector
            self.stall_inspector = StallInspector(
                warn_seconds=knobs["HOROVOD_STALL_CHECK_TIME_SECONDS"],
                shutdown_seconds=knobs["HOROVOD_STALL_SHUTDOWN_TIME_SECONDS"])
        if knobs["HOROVOD_METRICS"]:
            from .utils.metrics import MetricsPublisher
            self.metrics_publisher = MetricsPublisher(
                addr=rdv_addr, port=rdv_port, rank=self._rank,
                snapshot_fn=self.metrics_snapshot,
                interval=knobs["HOROVOD_METRICS_INTERVAL"])
        if knobs["HOROVOD_PERF"]:
            # the ledger records whether or not this is on; the knob starts
            # the publisher behind GET /perf
            from .perf import resolve_link
            from .perf.ledger import GLOBAL as ledger
            from .perf.ledger import PerfPublisher, resolve_chip
            ledger.configure(chip=resolve_chip(self.device),
                             link=resolve_link(knobs, self))
            self.perf_publisher = PerfPublisher(
                addr=rdv_addr, port=rdv_port, rank=self._rank,
                interval=knobs["HOROVOD_PERF_INTERVAL"])

    def _start_forensics(self) -> None:
        """The postmortem and chaos planes of this rank
        (``horovod_tpu/runtime.py`` :308-328): the heartbeat publisher
        under ``HOROVOD_HEARTBEAT`` (KV scope ``health``: step progress,
        the native core's liveness, the stall inspector's pending count
        and the memory sampler's last row), and this rank's chaos
        injector from the spec ``launch --chaos`` published (or
        ``HOROVOD_CHAOS_SPEC``), installed before the native core comes up
        because its transport reads the ``HOROVOD_CHAOS_TCP_*`` faults at
        construction."""
        knobs = self.knobs
        if knobs["HOROVOD_HEARTBEAT"]:
            from .utils.health import HeartbeatPublisher
            self.heartbeat = HeartbeatPublisher(
                addr=knobs["HOROVOD_RENDEZVOUS_ADDR"],
                port=knobs["HOROVOD_RENDEZVOUS_PORT"], rank=self._rank,
                payload_fn=self._heartbeat_payload,
                interval=knobs["HOROVOD_HEARTBEAT_INTERVAL"])
        from . import chaos
        chaos.ensure_installed(knobs, rank=self._rank)

    def _heartbeat_payload(self) -> Dict[str, Any]:
        """One heartbeat (``utils/health.py``): step progress, the native
        core's liveness and the pending-collective count that fleet-stall
        attribution keys on."""
        from .utils.health import heartbeat_payload
        pending = None
        if self.stall_inspector is not None:
            pending = self.stall_inspector.pending_count()
        core = self.core
        if core is not None and not getattr(core, "_h", None):
            core = None  # a closing core: the heartbeat must not touch it
        return heartbeat_payload(self._rank, clock=self.clock_sync,
                                 core=core, pending_collectives=pending)

    def _build_hierarchy(self):
        """``(cross_group, local_group)`` of this rank on a two-level layout
        (``1 < local_size < size``), else None.  Every rank creates every
        group, in the same order, as ``dist.new_group`` requires: the
        groups of each host, then the groups of each local index."""
        size, local = self._size, self._local_size
        if not 1 < local < size:
            return None
        hosts = [dist.new_group(list(range(h * local, (h + 1) * local)))
                 for h in range(size // local)]
        crosses = [dist.new_group(list(range(j, size, local)))
                   for j in range(local)]
        return crosses[self._rank % local], hosts[self._rank // local]

    def ensure_core(self):
        """The native controller of this rank, brought up on first use
        (idempotent); None when the eager API runs without negotiation."""
        if self.core is not None:
            return self.core
        if self._controller == "none" or (self._controller == "auto"
                                          and self._size <= 1):
            return None
        from .common.basics import CoordinationCore
        coord = self.knobs["HOROVOD_COORDINATOR_ADDR"]
        self.core = CoordinationCore.tcp(
            rank=self._rank, size=self._size,
            addr=coord.rsplit(":", 1)[0] if coord else "127.0.0.1",
            port=self.knobs["HOROVOD_CONTROLLER_PORT"],
            cycle_ms=self.knobs["HOROVOD_CYCLE_TIME"],
            fusion_bytes=self.fusion_threshold(),
            cache_capacity=self.knobs["HOROVOD_CACHE_CAPACITY"],
            stall_warn_seconds=self.knobs["HOROVOD_STALL_CHECK_TIME_SECONDS"])
        if self.knobs["HOROVOD_AUTOTUNE"]:
            self.core.enable_autotune(
                warmup_samples=self.knobs["HOROVOD_AUTOTUNE_WARMUP_SAMPLES"],
                steps_per_sample=self.knobs[
                    "HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE"],
                max_samples=self.knobs[
                    "HOROVOD_AUTOTUNE_BAYES_OPT_MAX_SAMPLES"],
                gp_noise=self.knobs[
                    "HOROVOD_AUTOTUNE_GAUSSIAN_PROCESS_NOISE"])
        if self.knobs["HOROVOD_FLIGHT_RECORD"]:
            # the crash-time flight recorder, armed as soon as there is a
            # core to record (launch --postmortem sets a per-rank path)
            self.core.flight_enable(self.knobs["HOROVOD_FLIGHT_RECORD"])
        self._attach_native_trace()
        return self.core

    def rank(self) -> int:
        return self._rank

    def size(self) -> int:
        return self._size

    def local_rank(self) -> int:
        return self._local_rank

    def local_size(self) -> int:
        return self._local_size

    def cross_rank(self) -> int:
        """Host index: ranks are laid out host-major, local_size per host."""
        return self._rank // self._local_size

    def cross_size(self) -> int:
        return -(-self._size // self._local_size)

    def fusion_threshold(self) -> int:
        """Live fusion threshold: autotuned when enabled, knob otherwise."""
        if self.autotuner is not None:
            return self.autotuner.fusion_threshold
        return self.knobs["HOROVOD_FUSION_THRESHOLD"]

    def wire_policy(self) -> str:
        """Live wire-policy name of the fused gradient sync (ops/wire.py):
        the knob, read through ``current`` (env wins), and under tuning
        'auto' refined to the bandit's current policy arm, which every
        rank holds alike (``utils/autotune.py``)."""
        name = validate_policy_name(current("HOROVOD_WIRE_POLICY"))
        if name == "auto" and self.autotuner is not None:
            arm = self.autotuner.wire_policy
            if arm is not None:
                return arm
        return name

    def overlap_depth(self) -> int:
        """Live microbatch-pipeline depth (ops/overlap.py): the knob, read
        through ``current``, refined to the bandit's depth arm when tuning
        is on."""
        validate_overlap_knobs({
            name: current(name) for name in ("HOROVOD_OVERLAP_DEPTH",
                                             "HOROVOD_PREFETCH_DEPTH")})
        depth = int(current("HOROVOD_OVERLAP_DEPTH"))
        if self.autotuner is not None:
            arm = self.autotuner.overlap_depth
            if arm is not None:
                return arm
        return depth

    def zero_ag_prefetch(self) -> int:
        """Live ZeRO-3 parameter all-gather prefetch depth: the knob, read
        through ``current``, refined to the bandit's depth arm when tuning
        is on (the same arm dimension the microbatch pipeline tunes)."""
        depth = int(current("HOROVOD_ZERO_AG_PREFETCH"))
        if self.autotuner is not None:
            arm = self.autotuner.overlap_depth
            if arm is not None:
                return arm
        return depth

    # -------------------------------------------------------------- metrics
    def metrics_snapshot(self) -> Dict[str, Any]:
        """Point-in-time view of every metric family this process holds
        (the public ``hvd.metrics_snapshot()``): registry values refreshed
        from their live sources (native controller counters, histograms
        and windowed rates, the bucket-plan cache, the stall inspector) in
        one JSON-able dict."""
        from .utils import metrics as M
        M.RUNTIME_SIZE.set(self.size())
        M.RUNTIME_LOCAL_SIZE.set(self.local_size())
        M.PLAN_CACHE_HITS.set_total(self.plan_cache.hits)
        M.PLAN_CACHE_MISSES.set_total(self.plan_cache.misses)
        if self.stall_inspector is not None:
            M.STALL_PENDING.set(self.stall_inspector.pending_count())
        core = self.core
        if core is not None and getattr(core, "_h", None):
            M.import_core_metrics(M.core_totals(core.metrics()))
            M.import_window_rates(core.metrics_window())
            from .perf.ledger import import_op_stats
            import_op_stats(core)
        else:
            core = None
        # the memory plane samples on the snapshot's cadence
        from .perf import memstats
        memstats.sample(core=core, device=self.device)
        return M.REGISTRY.snapshot()

    # ------------------------------------------------------------- timeline
    def _start_timeline_publisher(self) -> None:
        """Chunk publishing to the rendezvous 'timeline' scope, when a
        server is known: what GET /timeline and --timeline-merge read."""
        addr = self.knobs["HOROVOD_RENDEZVOUS_ADDR"]
        port = self.knobs["HOROVOD_RENDEZVOUS_PORT"]
        if not (addr and port) or self.timeline is None:
            return
        from .utils.timeline import TimelinePublisher
        self.timeline_publisher = TimelinePublisher(
            addr=addr, port=port, rank=self._rank, timeline=self.timeline,
            interval=self.knobs["HOROVOD_TIMELINE_MERGE_INTERVAL"],
            clock=self.clock_sync,
            replica=int(self.knobs["HOROVOD_SERVE_REPLICA_ID"]))

    def _attach_native_trace(self) -> None:
        """Pump the native core's span ring into the timeline (idempotent;
        called whenever either side comes up after the other)."""
        if self.core is None or self.timeline is None \
                or self._trace_drainer is not None:
            return
        from .utils.timeline import NativeTraceDrainer
        self._trace_drainer = NativeTraceDrainer(self.core, self.timeline)

    def start_timeline(self, path: str, mark_cycles: bool = False) -> None:
        """Runtime-activated timeline (reference: operations.cc:740-769)."""
        from .utils.timeline import Timeline
        self.stop_timeline()
        if self.clock_sync is None:
            addr = self.knobs["HOROVOD_RENDEZVOUS_ADDR"]
            port = self.knobs["HOROVOD_RENDEZVOUS_PORT"]
            if addr and port:
                from .utils.clocksync import ClockSync
                self.clock_sync = ClockSync(addr, port)
        self.timeline = Timeline(path, mark_cycles=mark_cycles,
                                 clock=self.clock_sync, rank=self._rank)
        self._start_timeline_publisher()
        self._attach_native_trace()

    def stop_timeline(self) -> None:
        if self._trace_drainer is not None:
            self._trace_drainer.close()
            self._trace_drainer = None
        if self.timeline_publisher is not None:
            self.timeline_publisher.close()
            self.timeline_publisher = None
        if self.timeline is not None:
            self.timeline.close()
            self.timeline = None

    def shutdown(self) -> None:
        # the sentinel's last steps recorded, then the final heartbeat
        # while the core is alive (the postmortem's last known state of
        # this rank); the final metrics publish while the native core is
        # alive, so the straggler report sees complete histograms; then the
        # final native drain, the final chunk publish and the local file
        from .watch import sentinel
        sentinel.drain()
        if self.heartbeat is not None:
            self.heartbeat.close()
        if self.perf_publisher is not None:
            self.perf_publisher.close()
        if self.metrics_publisher is not None:
            self.metrics_publisher.close()
        self.stop_timeline()
        if self.autotuner is not None:
            self.autotuner.close()
        if self.stall_inspector is not None:
            self.stall_inspector.close()
        if self.core is not None:
            from .utils import metrics as M
            try:
                M.retire_core_metrics(self.core.metrics())
            except Exception:  # a failed core: nothing to fold in
                pass
            self.core.shutdown()
            self.core.close()
            self.core = None
        if self._owns_group and dist.is_initialized():
            # every group of this runtime (the world, the two-level and
            # layout subgroups) and its communicators; a stale NCCL
            # communicator holds device memory into the next runtime
            dist.destroy_process_group()


def init(device: Union[str, torch.device, None] = None,
         **overrides: Any) -> Runtime:
    """Initialize the process-global runtime (idempotent).  ``overrides``
    set knobs that the environment does not."""
    global _runtime, _atexit_registered
    with _lock:
        if _runtime is None:
            _runtime = Runtime(Knobs(overrides or None), device=device)
            if not _atexit_registered:
                # once a process: an elastic hard reset shuts down and
                # initializes again in the same process
                atexit.register(shutdown)
                _atexit_registered = True
        return _runtime


def is_initialized() -> bool:
    return _runtime is not None


def get() -> Runtime:
    if _runtime is None:
        raise RuntimeError(
            "horovod_tpu_torch has not been initialized; call hvd.init() "
            "first")
    return _runtime


def shutdown() -> None:
    global _runtime
    with _lock:
        if _runtime is not None:
            _runtime.shutdown()
            _runtime = None


def resolve_device(device: Union[str, torch.device, None] = None
                   ) -> torch.device:
    """``device`` if given, else the runtime's device, else the current CUDA
    device.  Raises when none of them exists."""
    if device is not None:
        return torch.device(device)
    if _runtime is not None:
        return _runtime.device
    return _pick_device(None, torch.cuda.current_device()
                        if torch.cuda.is_available() else 0)
