"""ctypes binding of the port's native coordination core: the port of the
controller part of ``horovod_tpu/common/basics.py`` (``CoreResponse``,
``LoopbackHub``, ``CoordinationCore`` and the op codes).

The library is the port's own copy of the core, built from
``horovod_tpu_torch/csrc/core/`` at first use (``ops/_native.py``).  Each
rank's ``CoordinationCore`` runs the controller's cycle loop on a native
thread: ``submit`` declares a named collective ready on this rank, and the
controller hands every rank the same sequence of responses, each a batch of
names fused under the fusion threshold, through ``poll``/``wait``.

The measurement plane's surfaces are bound too: the core's metrics
(``metrics``, ``metrics_window``), its span ring (``trace_enable``,
``trace_drain``) and its autotuning (``enable_autotune``,
``autotune_state``), and the standalone optimizers the Python autotuner
drives (``GaussianProcess``, ``BayesianOptimizer``,
``NativeParameterManager``, ``NativeArmBandit``, ``NativeProductBandit``,
over ``csrc/core/optim.cc``).  The perf plane reads the per-op
aggregates (``op_stats``) and the core's memory footprint (``mem``).  The
postmortem plane reads the core's liveness (``health``) and arms and
triggers its flight recorder (``flight_enable``, ``flight_dump``;
``csrc/core/postmortem.cc``).
"""

from __future__ import annotations

import ctypes
import threading
from typing import List, Optional, Tuple

from .exceptions import DuplicateTensorNameError

# RequestType values (must match csrc/core/common.h)
OP_ALLREDUCE = 0
OP_ALLGATHER = 1
OP_BROADCAST = 2
OP_ALLTOALL = 3
OP_REDUCESCATTER = 4
OP_BARRIER = 5
OP_JOIN = 6

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def load_library() -> ctypes.CDLL:
    """The core library, built on first use, with its C signatures."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        from ..ops import _native
        lib = ctypes.CDLL(_native.build())
        vp, i32, f64, i64 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_double,
                             ctypes.c_long)
        lib.hvd_loopback_hub_create.restype = vp
        lib.hvd_loopback_hub_create.argtypes = [i32]
        lib.hvd_loopback_hub_destroy.argtypes = [vp]
        lib.hvd_core_create_loopback.restype = vp
        lib.hvd_core_create_loopback.argtypes = [vp, i32, f64, i64, i32, f64]
        lib.hvd_core_create_tcp.restype = vp
        lib.hvd_core_create_tcp.argtypes = [i32, i32, ctypes.c_char_p, i32,
                                            i32, f64, i64, i32, f64]
        lib.hvd_core_destroy.argtypes = [vp]
        lib.hvd_core_rank.argtypes = [vp]
        lib.hvd_core_size.argtypes = [vp]
        lib.hvd_core_healthy.argtypes = [vp]
        lib.hvd_core_submit.argtypes = [vp, ctypes.c_char_p, ctypes.c_char_p,
                                        i32, i64]
        lib.hvd_core_join.argtypes = [vp]
        lib.hvd_core_poll.argtypes = [vp, ctypes.c_char_p, i32]
        lib.hvd_core_wait.argtypes = [vp, f64, ctypes.c_char_p, i32]
        lib.hvd_core_shutdown.argtypes = [vp]
        lib.hvd_core_trace_enable.argtypes = [vp]
        lib.hvd_core_trace.argtypes = [vp, ctypes.c_char_p, i32]
        # the measurement plane: metrics, autotune and the optimizers
        dptr = ctypes.POINTER(f64)
        lib.hvd_core_metrics.argtypes = [vp, ctypes.c_char_p, i32]
        lib.hvd_core_op_stats.argtypes = [vp, ctypes.c_char_p, i32]
        lib.hvd_core_mem.argtypes = [vp, ctypes.c_char_p, i32]
        lib.hvd_core_metrics_window.argtypes = [vp, f64, ctypes.c_char_p,
                                                i32]
        # the postmortem plane: liveness and the flight recorder
        lib.hvd_core_health.argtypes = [vp, ctypes.c_char_p, i32]
        lib.hvd_core_flight_enable.argtypes = [vp, ctypes.c_char_p]
        lib.hvd_core_flight_dump.argtypes = [vp, ctypes.c_char_p,
                                             ctypes.c_char_p]
        lib.hvd_core_enable_autotune.argtypes = [vp, i32, i32, i32, f64]
        lib.hvd_core_autotune_state.argtypes = [vp, dptr]
        lib.hvd_gp_create.restype = vp
        lib.hvd_gp_create.argtypes = [f64, f64, f64]
        lib.hvd_gp_destroy.argtypes = [vp]
        lib.hvd_gp_fit.argtypes = [vp, dptr, dptr, i32, i32]
        lib.hvd_gp_predict.argtypes = [vp, dptr, i32, dptr, dptr]
        lib.hvd_bo_create.restype = vp
        lib.hvd_bo_create.argtypes = [i32, f64, ctypes.c_uint, f64]
        lib.hvd_bo_destroy.argtypes = [vp]
        lib.hvd_bo_add_sample.argtypes = [vp, dptr, i32, f64]
        lib.hvd_bo_next_sample.argtypes = [vp, dptr, i32]
        lib.hvd_bo_best_y.restype = f64
        lib.hvd_bo_best_y.argtypes = [vp]
        lib.hvd_bo_best_x.argtypes = [vp, dptr, i32]
        lib.hvd_pm_create.restype = vp
        lib.hvd_pm_create.argtypes = [ctypes.c_longlong, f64, i32, i32, i32,
                                      f64]
        lib.hvd_pm_destroy.argtypes = [vp]
        lib.hvd_pm_update.argtypes = [vp, ctypes.c_longlong, f64, dptr]
        lib.hvd_pm_best_score.restype = f64
        lib.hvd_pm_best_score.argtypes = [vp]
        lib.hvd_bandit_create.restype = vp
        lib.hvd_bandit_create.argtypes = [i32, i32, i32, f64]
        lib.hvd_bandit_destroy.argtypes = [vp]
        lib.hvd_bandit_update.argtypes = [vp, f64, dptr]
        lib.hvd_bandit_best_arm.argtypes = [vp]
        lib.hvd_bandit_best_mean.restype = f64
        lib.hvd_bandit_best_mean.argtypes = [vp]
        lib.hvd_bandit2_create.restype = vp
        lib.hvd_bandit2_create.argtypes = [i32, i32, i32, i32, f64]
        lib.hvd_bandit2_destroy.argtypes = [vp]
        lib.hvd_bandit2_update.argtypes = [vp, f64, dptr]
        lib.hvd_bandit2_best_a.argtypes = [vp]
        lib.hvd_bandit2_best_b.argtypes = [vp]
        _lib = lib
        return lib


def _dbuf(vals):
    return (ctypes.c_double * len(vals))(*vals)


class GaussianProcess:
    """Native RBF-kernel GP regressor (``csrc/core/optim.cc``; reference:
    optim/gaussian_process.{h,cc})."""

    def __init__(self, length: float = 1.0, sigma_f: float = 1.0,
                 noise: float = 1e-4):
        self._lib = load_library()
        self._h = self._lib.hvd_gp_create(length, sigma_f, noise)

    def fit(self, X, y) -> None:
        import numpy as np
        X = np.asarray(X, np.float64)
        y = np.asarray(y, np.float64)
        n, d = X.shape
        self._lib.hvd_gp_fit(self._h, _dbuf(X.ravel().tolist()),
                             _dbuf(y.tolist()), n, d)

    def predict(self, x) -> Tuple[float, float]:
        mean = ctypes.c_double()
        var = ctypes.c_double()
        x = list(map(float, x))
        self._lib.hvd_gp_predict(self._h, _dbuf(x), len(x),
                                 ctypes.byref(mean), ctypes.byref(var))
        return mean.value, var.value

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.hvd_gp_destroy(self._h)
            self._h = None


class BayesianOptimizer:
    """Native expected-improvement BO over [0,1]^d (``csrc/core/optim.cc``;
    reference: optim/bayesian_optimization.{h,cc})."""

    def __init__(self, dims: int, xi: float = 0.01, seed: int = 42,
                 gp_noise: float = 1e-4):
        self._lib = load_library()
        self.dims = dims
        self._h = self._lib.hvd_bo_create(dims, xi, seed, gp_noise)

    def add_sample(self, x, y: float) -> None:
        x = list(map(float, x))
        self._lib.hvd_bo_add_sample(self._h, _dbuf(x), len(x), float(y))

    def next_sample(self) -> List[float]:
        out = (ctypes.c_double * self.dims)()
        self._lib.hvd_bo_next_sample(self._h, out, self.dims)
        return list(out)

    @property
    def best_y(self) -> float:
        return self._lib.hvd_bo_best_y(self._h)

    @property
    def best_x(self) -> List[float]:
        out = (ctypes.c_double * self.dims)()
        self._lib.hvd_bo_best_x(self._h, out, self.dims)
        return list(out)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.hvd_bo_destroy(self._h)
            self._h = None


class NativeParameterManager:
    """Native autotuner of (fusion threshold bytes, cycle ms) scored by
    bytes/sec (``csrc/core/optim.cc`` ParameterManager; reference:
    parameter_manager.{h,cc})."""

    def __init__(self, initial_threshold: int, initial_cycle_ms: float,
                 warmup_samples: int = 3, steps_per_sample: int = 10,
                 max_samples: int = 20, gp_noise: float = 0.8):
        self._lib = load_library()
        self._h = self._lib.hvd_pm_create(
            initial_threshold, initial_cycle_ms, warmup_samples,
            steps_per_sample, max_samples, gp_noise)
        self.threshold = initial_threshold
        self.cycle_ms = initial_cycle_ms
        self.done = False

    def update(self, nbytes: int, seconds: float) -> bool:
        out = (ctypes.c_double * 3)()
        changed = self._lib.hvd_pm_update(self._h, nbytes, seconds, out)
        self.threshold = int(out[0])
        self.cycle_ms = out[1]
        self.done = bool(out[2])
        return bool(changed)

    @property
    def best_score(self) -> float:
        return self._lib.hvd_pm_best_score(self._h)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.hvd_pm_destroy(self._h)
            self._h = None


class NativeArmBandit:
    """Deterministic UCB1 bandit over K discrete arms
    (``csrc/core/optim.cc`` ArmBandit): the wire-policy or overlap-depth
    dimension of autotune, scored in effective bytes/sec.  No RNG; ties
    break toward the lower arm index, so every process that replays the
    same score stream lands on the same arm."""

    def __init__(self, arms: int, steps_per_sample: int = 10,
                 max_pulls: int = 0, explore: float = 0.5):
        self._lib = load_library()
        self._h = self._lib.hvd_bandit_create(arms, steps_per_sample,
                                              max_pulls, explore)
        self.arms = arms
        self.arm = 0
        self.done = arms <= 1
        self.pulls = 0

    def update(self, score: float) -> bool:
        """Record one step's score; True when the active arm changed."""
        out = (ctypes.c_double * 3)()
        changed = self._lib.hvd_bandit_update(self._h, float(score), out)
        self.arm = int(out[0])
        self.done = bool(out[1])
        self.pulls = int(out[2])
        return bool(changed)

    @property
    def best_arm(self) -> int:
        return self._lib.hvd_bandit_best_arm(self._h)

    @property
    def best_mean(self) -> float:
        return self._lib.hvd_bandit_best_mean(self._h)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.hvd_bandit_destroy(self._h)
            self._h = None


class NativeProductBandit:
    """Deterministic UCB1 over a factored (arms_a x arms_b) space
    (``csrc/core/optim.cc`` ProductBandit): autotune's joint (wire policy,
    overlap depth) search, one flat bandit over the product decoded to
    per-dimension arm indices, with NativeArmBandit's replay
    determinism."""

    def __init__(self, arms_a: int, arms_b: int,
                 steps_per_sample: int = 10, max_pulls: int = 0,
                 explore: float = 0.5):
        self._lib = load_library()
        self._h = self._lib.hvd_bandit2_create(arms_a, arms_b,
                                               steps_per_sample,
                                               max_pulls, explore)
        self.arm_a = 0
        self.arm_b = 0
        self.done = arms_a * arms_b <= 1
        self.pulls = 0

    def update(self, score: float) -> bool:
        """Record one step's score; True when the active pair changed."""
        out = (ctypes.c_double * 4)()
        changed = self._lib.hvd_bandit2_update(self._h, float(score), out)
        self.arm_a = int(out[0])
        self.arm_b = int(out[1])
        self.done = bool(out[2])
        self.pulls = int(out[3])
        return bool(changed)

    @property
    def best_a(self) -> int:
        return self._lib.hvd_bandit2_best_a(self._h)

    @property
    def best_b(self) -> int:
        return self._lib.hvd_bandit2_best_b(self._h)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.hvd_bandit2_destroy(self._h)
            self._h = None


class CoreResponse:
    """One controller verdict (``csrc/core/c_api.cc`` ``Deliver``): ``type``
    (OK, ERROR, JOIN_DONE, SHUTDOWN), the op code, the batch's payload
    bytes (for JOIN_DONE: the last rank to join), an error message, and the
    fused batch's names with their signatures, in execution order."""

    __slots__ = ("type", "op", "total_bytes", "error", "names", "sigs")

    def __init__(self, raw: str):
        t, op, total, err, names, sigs = raw.split("|", 5)
        self.type = t
        self.op = int(op)
        self.total_bytes = int(total)
        self.error = err
        self.names = names.split(",") if names else []
        self.sigs = sigs.split(",") if sigs else []

    def __repr__(self) -> str:
        return (f"CoreResponse({self.type}, op={self.op}, "
                f"names={self.names}, err={self.error!r})")


class LoopbackHub:
    """In-process hub joining ``size`` loopback cores (tests)."""

    def __init__(self, size: int):
        self._lib = load_library()
        self.size = size
        self._h = self._lib.hvd_loopback_hub_create(size)

    def close(self) -> None:
        if self._h:
            self._lib.hvd_loopback_hub_destroy(self._h)
            self._h = None


class CoordinationCore:
    """One rank's handle to the native controller."""

    def __init__(self, handle, lib: ctypes.CDLL):
        if not handle:
            raise RuntimeError("native core failed to initialize "
                               "(transport bring-up failure?)")
        self._h = handle
        self._lib = lib
        self._tls = threading.local()  # one response buffer per thread

    def _buf(self, min_size: int = 1 << 16):
        buf = getattr(self._tls, "buf", None)
        if buf is None or len(buf) < min_size:
            buf = ctypes.create_string_buffer(max(min_size, 1 << 16))
            self._tls.buf = buf
        return buf

    @classmethod
    def loopback(cls, hub: LoopbackHub, rank: int, cycle_ms: float = 1.0,
                 fusion_bytes: int = 128 << 20, cache_capacity: int = 1024,
                 stall_warn_seconds: float = 60.0) -> "CoordinationCore":
        lib = load_library()
        return cls(lib.hvd_core_create_loopback(
            hub._h, rank, cycle_ms, fusion_bytes, cache_capacity,
            stall_warn_seconds), lib)

    @classmethod
    def tcp(cls, rank: int, size: int, addr: str = "127.0.0.1",
            port: int = 29499, timeout_ms: int = 30000,
            cycle_ms: float = 1.0, fusion_bytes: int = 128 << 20,
            cache_capacity: int = 1024,
            stall_warn_seconds: float = 60.0) -> "CoordinationCore":
        """Rank 0 listens on ``port``; the others connect to ``addr``."""
        lib = load_library()
        return cls(lib.hvd_core_create_tcp(
            rank, size, addr.encode(), port, timeout_ms, cycle_ms,
            fusion_bytes, cache_capacity, stall_warn_seconds), lib)

    def rank(self) -> int:
        return self._lib.hvd_core_rank(self._h)

    def size(self) -> int:
        return self._lib.hvd_core_size(self._h)

    def healthy(self) -> bool:
        return bool(self._lib.hvd_core_healthy(self._h))

    def submit(self, name: str, signature: str, op: int = OP_ALLREDUCE,
               nbytes: int = 0) -> None:
        rc = self._lib.hvd_core_submit(self._h, name.encode(),
                                       signature.encode(), op, nbytes)
        if rc == -1:
            raise DuplicateTensorNameError(
                f"tensor name {name!r} already submitted and not completed")
        if rc == -3:
            raise ValueError(f"tensor name {name!r} contains reserved "
                             "delimiter '|' or ','")
        if rc != 0:
            raise RuntimeError(f"core submit failed rc={rc}")

    def join(self) -> None:
        """No more collectives from this rank: the controller counts it
        ready for every tensor until all ranks have joined."""
        self._lib.hvd_core_join(self._h)

    def _take(self, call) -> Optional[CoreResponse]:
        buf = self._buf()
        n = call(buf)
        if n < 0:  # -(needed + 1): the response waits in the stash
            buf = self._buf(-n + 1)
            n = call(buf)
        if n <= 0:
            return None
        return CoreResponse(buf.value.decode())

    def poll(self) -> Optional[CoreResponse]:
        """The next response, or None without waiting."""
        return self._take(lambda b: self._lib.hvd_core_poll(self._h, b,
                                                            len(b)))

    def wait(self, timeout_s: float = 30.0) -> Optional[CoreResponse]:
        """The next response, or None after ``timeout_s``."""
        return self._take(lambda b: self._lib.hvd_core_wait(
            self._h, timeout_s, b, len(b)))

    def enable_autotune(self, warmup_samples: int = 3,
                        steps_per_sample: int = 10,
                        max_samples: int = 20,
                        gp_noise: float = 0.8) -> None:
        """Rank-0 autotuning of the controller's fusion threshold and cycle
        time (reference: HOROVOD_AUTOTUNE, parameter_manager.{h,cc})."""
        self._lib.hvd_core_enable_autotune(self._h, warmup_samples,
                                           steps_per_sample, max_samples,
                                           gp_noise)

    def autotune_state(self) -> Optional[dict]:
        """``{"threshold", "cycle_ms", "done", "best_score"}`` of the
        core's tuner, or None when autotune is not active on this rank."""
        out = (ctypes.c_double * 4)()
        if not self._lib.hvd_core_autotune_state(self._h, out):
            return None
        return {"threshold": int(out[0]), "cycle_ms": out[1],
                "done": bool(out[2]), "best_score": out[3]}

    def _text(self, call) -> str:
        """The text a length-returning native writer produces (it returns
        the full length; a short buffer is retried at that length)."""
        buf = self._buf()
        n = call(buf)
        if n >= len(buf):
            buf = self._buf(n + 1)
            call(buf)
        return buf.value.decode()

    def metrics(self) -> dict:
        """Versioned native metrics (``csrc/core/c_api.cc``
        ``hvd_core_metrics``): ``{"version": 1, "counters": {...},
        "histograms": {name: {"count", "sum" (us), "buckets": [28
        power-of-2-us bins]}}}``.  Unknown lines are ignored: the
        versioning contract is name-keyed lines."""
        lines = self._text(lambda b: self._lib.hvd_core_metrics(
            self._h, b, len(b))).splitlines()
        if not lines or not lines[0].startswith("hvd_metrics_v"):
            raise RuntimeError(f"unrecognized native metrics header: "
                               f"{lines[:1]!r}")
        out = {"version": int(lines[0].split("hvd_metrics_v", 1)[1]),
               "counters": {}, "histograms": {}}
        for line in lines[1:]:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "hist" and len(parts) >= 4:
                out["histograms"][parts[1]] = {
                    "count": int(parts[2]), "sum": int(parts[3]),
                    "buckets": [int(p) for p in parts[4:]]}
            elif len(parts) == 2:
                out["counters"][parts[0]] = int(parts[1])
        return out

    def metrics_window(self, window_s: float = 60.0) -> dict:
        """Windowed native rates (``hvd_core_metrics_window``):
        ``{"version", "span_us", "cycle_rate", "bytes_reduced_rate",
        "reconnect_rate" (per minute), "bypass_fraction"}``, differentiated
        inside the core against its snapshot ring; ``span_us`` 0 means no
        history yet."""
        lines = self._text(lambda b: self._lib.hvd_core_metrics_window(
            self._h, float(window_s), b, len(b))).splitlines()
        if not lines or not lines[0].startswith("hvd_metrics_window_v"):
            raise RuntimeError(f"unrecognized native window header: "
                               f"{lines[:1]!r}")
        out = {"version": int(lines[0].split("hvd_metrics_window_v",
                                             1)[1])}
        for line in lines[1:]:
            parts = line.split()
            if len(parts) == 2:
                try:
                    out[parts[0]] = (int(parts[1]) if parts[0] == "span_us"
                                     else float(parts[1]))
                except ValueError:
                    continue
        return out

    def op_stats(self) -> dict:
        """Per-op-name enqueue->done aggregates (``hvd_core_op_stats``):
        ``{name: {"count", "bytes", "sum_us", "max_us"}}``, names collapsed
        as the timeline collapses them and bounded in cardinality (the
        overflow under ``__other__``); the native leg of the perf plane
        (``perf/ledger.py``).  Extra fields on a line are ignored."""
        lines = self._text(lambda b: self._lib.hvd_core_op_stats(
            self._h, b, len(b))).splitlines()
        if not lines or not lines[0].startswith("hvd_op_stats_v"):
            raise RuntimeError(f"unrecognized native op-stats header: "
                               f"{lines[:1]!r}")
        out = {}
        for line in lines[1:]:
            parts = line.split()
            if len(parts) < 5:
                continue
            out[parts[0]] = {"count": int(parts[1]),
                             "bytes": int(parts[2]),
                             "sum_us": int(parts[3]),
                             "max_us": int(parts[4])}
        return out

    def mem(self) -> dict:
        """The native core's memory footprint (``hvd_core_mem``):
        ``rss_bytes``, ``peak_rss_bytes``, ``trace_ring_bytes``,
        ``window_ring_bytes``, ``response_cache_bytes`` and ``stamps``
        (the cycle loop's refreshes), stamped by the cycle loop and read
        without its lock; the memory plane's native leg
        (``perf/memstats.py``).  Unknown lines are ignored."""
        lines = self._text(lambda b: self._lib.hvd_core_mem(
            self._h, b, len(b))).splitlines()
        if not lines or not lines[0].startswith("hvd_mem_v"):
            raise RuntimeError(f"unrecognized native mem header: "
                               f"{lines[:1]!r}")
        out = {"version": int(lines[0].split("hvd_mem_v", 1)[1])}
        for line in lines[1:]:
            parts = line.split()
            if len(parts) == 2:
                try:
                    out[parts[0]] = int(parts[1])
                except ValueError:
                    continue
        return out

    def health(self) -> dict:
        """Liveness snapshot (``hvd_core_health``): name-keyed integer
        fields, ``now_us`` (the ring's steady clock), ``cycles``,
        ``last_progress_age_us``, ``queue_depth``, ``responses_pending``,
        ``transport_healthy``, ``shutdown``.  Built without the cycle
        loop's lock, so it answers while the loop is wedged, which is
        when the postmortem plane asks.  Unknown lines are ignored."""
        lines = self._text(lambda b: self._lib.hvd_core_health(
            self._h, b, len(b))).splitlines()
        if not lines or not lines[0].startswith("hvd_health_v"):
            raise RuntimeError(f"unrecognized native health header: "
                               f"{lines[:1]!r}")
        out = {"version": int(lines[0].split("hvd_health_v", 1)[1])}
        for line in lines[1:]:
            parts = line.split()
            if len(parts) == 2:
                try:
                    out[parts[0]] = int(parts[1])
                except ValueError:
                    continue
        return out

    def flight_enable(self, path: str) -> None:
        """Arm the crash-time flight recorder: fatal signals and
        std::terminate dump this core's flight record to ``path``
        (``csrc/core/postmortem.cc``), chaining to the handler installed
        before; implies span-ring recording, so the tail is populated.
        ``postmortem.parse_flight_record`` reads the record."""
        self._lib.hvd_core_flight_enable(self._h, path.encode())

    def flight_dump(self, path: str, reason: str = "") -> bool:
        """Write the flight record to ``path`` now
        (``hvd_core_flight_dump``); True when the file was written."""
        return self._lib.hvd_core_flight_dump(
            self._h, path.encode(), reason.encode()) == 0

    def trace_enable(self) -> None:
        """Turn on the native span ring (``csrc/core/trace.h``): each
        cycle that took submissions or made responses records its phases."""
        self._lib.hvd_core_trace_enable(self._h)

    def trace_drain(self) -> dict:
        """Consume the pending native trace events (``hvd_core_trace``):
        ``{"version", "now_us", "dropped", "events": [(ts_us, phase, cat,
        name, arg), ...]}``, timestamps in microseconds of the ring's
        clock.  A ``cycle.negotiate`` begin event carries the number of
        submissions that cycle took."""
        events = []
        header = {"version": 0, "now_us": 0, "dropped": 0}
        buf = self._buf(1 << 20)
        while True:
            n = self._lib.hvd_core_trace(self._h, buf, len(buf))
            if n <= 0:
                break
            lines = buf.value.decode().splitlines()
            if not lines or not lines[0].startswith("hvd_trace_v"):
                raise RuntimeError("unrecognized native trace header: "
                                   f"{lines[:1]!r}")
            head = lines[0].split()
            header = {"version": int(head[0].split("hvd_trace_v", 1)[1]),
                      "now_us": int(head[1]), "dropped": int(head[2])}
            for line in lines[1:]:
                parts = line.split()
                if len(parts) >= 5:
                    events.append((int(parts[0]), parts[1], parts[2],
                                   parts[3], int(parts[4])))
            if len(lines) == 1:  # the header alone: the ring is empty
                break
        header["events"] = events
        return header

    def shutdown(self) -> None:
        """Ask the cycle loop to exit.  With several cores in one process
        (a loopback hub), call it on every core before the first
        ``close``."""
        if self._h:
            self._lib.hvd_core_shutdown(self._h)

    def close(self) -> None:
        if self._h:
            self._lib.hvd_core_destroy(self._h)
            self._h = None
