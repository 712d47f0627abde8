"""Process-global runtime: the port of ``horovod_tpu/runtime.py``'s
``Runtime``/``init``/``shutdown`` over ``torch.distributed``.

One process drives one device.  The process group is NCCL on a CUDA device
and gloo on the CPU.  With ``HOROVOD_SIZE > 1`` (what the launcher,
``python -m horovod_tpu_torch.runner.launch``, stamps) the group
rendezvouses at ``HOROVOD_COORDINATOR_ADDR`` with rank ``HOROVOD_RANK``,
waiting at most ``HOROVOD_START_TIMEOUT`` seconds for its peers; a single
process uses an in-process store and opens no port.  The device is
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
"""

from __future__ import annotations

import atexit
import datetime
import threading
from typing import Any, Optional, Union

import torch
import torch.distributed as dist

from .common.knobs import Knobs, current
from .ops.fusion import BucketPlanCache
from .ops.overlap import validate_overlap_knobs
from .ops.wire import validate_policy_name

_runtime: Optional["Runtime"] = None
_lock = threading.Lock()


def _pick_device(device: Union[str, torch.device, None],
                 local_rank: int) -> torch.device:
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "horovod_tpu_torch: no CUDA device; pass device='cpu' to run on "
            "the CPU")
    return torch.device("cuda", local_rank)


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
        for name in ("HOROVOD_AUTOTUNE", "HOROVOD_TIMELINE",
                     "HOROVOD_FLIGHT_RECORD"):
            if knobs[name]:
                raise NotImplementedError(
                    f"{name}: the controller's autotuning, timeline and "
                    "flight recorder come with the measurement-planes slice "
                    "(ROADMAP queue 1 item 8)")
        validate_kv_knobs(knobs)
        self._controller = knobs["HOROVOD_CONTROLLER"].strip().lower()
        if self._controller not in ("auto", "tcp", "none"):
            raise ValueError(
                f"HOROVOD_CONTROLLER={knobs['HOROVOD_CONTROLLER']!r}: use "
                "'auto', 'tcp' or 'none'")
        self.core = None
        self.eager: Any = None  # the eager API's state (torch/mpi_ops.py)
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
                # the store's timeout bounds the bring-up only; the
                # group's collectives keep the backend's own timeout
                host, _, port = coord.rpartition(":")
                store = dist.TCPStore(
                    host, int(port), self._size, is_master=self._rank == 0,
                    timeout=datetime.timedelta(
                        seconds=knobs["HOROVOD_START_TIMEOUT"]))
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
        if self._controller == "tcp":
            self.ensure_core()

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
        return self.knobs["HOROVOD_FUSION_THRESHOLD"]

    def wire_policy(self) -> str:
        """Live wire-policy name of the fused gradient sync (ops/wire.py):
        the knob, read through ``current`` (env wins)."""
        return validate_policy_name(current("HOROVOD_WIRE_POLICY"))

    def overlap_depth(self) -> int:
        """Live microbatch-pipeline depth (ops/overlap.py): the knob, read
        through ``current``."""
        validate_overlap_knobs({
            name: current(name) for name in ("HOROVOD_OVERLAP_DEPTH",
                                             "HOROVOD_PREFETCH_DEPTH")})
        return int(current("HOROVOD_OVERLAP_DEPTH"))

    def shutdown(self) -> None:
        if self.core is not None:
            self.core.shutdown()
            self.core.close()
            self.core = None
        if self._owns_group and dist.is_initialized():
            dist.destroy_process_group()


def init(device: Union[str, torch.device, None] = None,
         **overrides: Any) -> Runtime:
    """Initialize the process-global runtime (idempotent).  ``overrides``
    set knobs that the environment does not."""
    global _runtime
    with _lock:
        if _runtime is None:
            _runtime = Runtime(Knobs(overrides or None), device=device)
            atexit.register(shutdown)
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
