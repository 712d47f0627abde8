"""ctypes binding of the port's native coordination core: the port of the
controller part of ``horovod_tpu/common/basics.py`` (``CoreResponse``,
``LoopbackHub``, ``CoordinationCore`` and the op codes).

The library is the port's own copy of the core, built from
``horovod_tpu_torch/csrc/core/`` at first use (``ops/_native.py``).  Each
rank's ``CoordinationCore`` runs the controller's cycle loop on a native
thread: ``submit`` declares a named collective ready on this rank, and the
controller hands every rank the same sequence of responses, each a batch of
names fused under the fusion threshold, through ``poll``/``wait``.  The
autotune, trace, metrics and flight-record surfaces of the JAX binding are
not bound here.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

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
        _lib = lib
        return lib


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
