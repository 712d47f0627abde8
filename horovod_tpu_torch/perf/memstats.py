"""The memory plane: the port of ``horovod_tpu/perf/memstats.py``, the
measured memory ledger of each rank.

  * :class:`MemSampler` measures the device (:func:`measure_device`):
      - on a CUDA device, ``torch.cuda.memory_stats``: ``bytes_in_use`` is
        ``allocated_bytes.all.current``, ``peak_bytes_in_use``
        ``allocated_bytes.all.peak``, and ``cap_bytes`` the card's total
        from ``torch.cuda.mem_get_info``; source ``"device"``;
      - on the CPU, the live tensors' bytes, each storage counted once
        (torch has no ``jax.live_arrays()``; the garbage collector's
        tensors stand in), beside ``/proc/self/status`` VmRSS; source
        ``"live_buffers"``, with no cap.
    A CUDA device whose ``memory_stats`` fails raises: the CPU figure is
    never reported for a card (the JAX function falls back silently).
    Bytes are attributed to planes from geometry the repo knows: the
    training state from the ledger's ZeRO model (``zero_memory_bytes``),
    the serving KV pool from the engine's ``kv_pool()`` (the provider
    ``serve/engine.py`` registers), the fusion/overlap working set from
    threshold x depth, and the native core's own footprint
    (``CoordinationCore.mem``).
  * Reconciliation: ``model_drift_ratio`` is the measured bytes in use
    over the ``zero_memory_bytes`` total; :func:`report_section` is the
    perf report's ``memory`` section.
  * The OOM-proximity sentinel: crossing ``HOROVOD_MEM_HIGH_WATERMARK``
    fires once per transition (``hvd_mem_pressure_events_total``, a
    ``mem.pressure`` timeline instant, a warning) and writes a native
    flight dump (reason ``mem``) beside the rank's flight record path
    when ``HOROVOD_FLIGHT_RECORD`` and the native core are up.

Knobs: ``HOROVOD_MEM`` (kill switch), ``HOROVOD_MEM_INTERVAL`` (rate
limit), ``HOROVOD_MEM_HIGH_WATERMARK``; checked at ``init``
(:func:`validate_mem_knobs`).
"""

from __future__ import annotations

import gc
import math
import sys
import threading
import time
from typing import Any, Callable, Dict, Optional

def _knob(name: str):
    from ..common.knobs import current
    return current(name)


def enabled() -> bool:
    return bool(_knob("HOROVOD_MEM"))


def validate_mem_knobs(knobs) -> None:
    """The HOROVOD_MEM_* knobs, checked at ``init``."""
    interval = float(knobs["HOROVOD_MEM_INTERVAL"])
    if interval < 0:
        raise ValueError(
            f"HOROVOD_MEM_INTERVAL={interval} invalid; the memory "
            "sampler rate limit must be >= 0 seconds")
    wm = float(knobs["HOROVOD_MEM_HIGH_WATERMARK"])
    if not 0.0 < wm <= 1.0:
        raise ValueError(
            f"HOROVOD_MEM_HIGH_WATERMARK={wm} invalid; the OOM-"
            "proximity threshold is a fraction of the device cap in "
            "(0, 1]")


# ------------------------------------------------------------ measurement
def read_host_rss_bytes() -> int:
    """Host resident set from /proc/self/status VmRSS; 0 where procfs is
    unavailable."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
    except (OSError, ValueError, IndexError):
        pass
    return 0


def live_tensor_bytes() -> int:
    """Bytes of the CPU storages the process's live tensors hold, each
    storage counted once (views share one)."""
    import torch
    # The collector's list holds a reference to every tracked object,
    # tuples another thread is still building included; CPython raises
    # SystemError in that thread if it resumes while the reference is
    # held (_PyTuple_Resize wants a refcount of 1).  So the list is cut
    # down to the tensors and dropped without letting another thread run.
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e3)
    try:
        objs = gc.get_objects()
        # type(), not isinstance(): some objects warn on __class__
        tensors = [o for o in objs if issubclass(type(o), torch.Tensor)]
        del objs
    finally:
        sys.setswitchinterval(switch)
    seen = set()
    total = 0
    for obj in tensors:
        try:
            if obj.device.type != "cpu":
                continue
            st = obj.untyped_storage()
            key = st.data_ptr()
            if key in seen or not key:
                continue
            seen.add(key)
            total += st.nbytes()
        except Exception:
            continue  # a tensor without storage (meta, sparse, ...)
    return total


def _device(device: Any = None):
    import torch
    if device is not None:
        return torch.device(device)
    from .. import runtime as _rt
    if _rt.is_initialized():
        return _rt.get().device
    return torch.device("cpu")


def measure_device(device: Any = None) -> Dict[str, Any]:
    """One device-side measurement: ``{"source", "bytes_in_use",
    "peak_bytes_in_use", "cap_bytes"}`` of ``device`` (default: the
    runtime's, else the CPU).  On a CUDA device a failing
    ``memory_stats`` raises (module docstring)."""
    import torch
    dev = _device(device)
    if dev.type == "cuda":
        stats = torch.cuda.memory_stats(dev)
        _, total = torch.cuda.mem_get_info(dev)
        return {
            "source": "device",
            "bytes_in_use": int(stats["allocated_bytes.all.current"]),
            "peak_bytes_in_use": int(stats["allocated_bytes.all.peak"]),
            "cap_bytes": int(total),
        }
    if dev.type != "cpu":
        raise ValueError(f"memstats: no measurement for {dev}")
    return {"source": "live_buffers", "bytes_in_use": live_tensor_bytes(),
            "peak_bytes_in_use": None, "cap_bytes": 0}


def native_mem(core: Any = None) -> Optional[Dict[str, int]]:
    """The native core's footprint (``CoordinationCore.mem``), or None
    when no core is up."""
    if core is None:
        from .. import runtime as _rt
        if _rt.is_initialized():
            core = _rt.get().core
    if core is None or not getattr(core, "_h", None):
        return None
    return core.mem()


# ------------------------------------------------------- kv-pool provider
_kv_pool_fn: Optional[Callable[[], Dict[str, Any]]] = None


def set_kv_pool_provider(fn: Optional[Callable[[], Dict[str, Any]]]
                         ) -> None:
    """Register the serving engine's pool occupancy source
    (``serve/engine.py`` registers ``ServeEngine.kv_pool``; None
    unregisters)."""
    global _kv_pool_fn
    _kv_pool_fn = fn


def kv_pool_stats() -> Optional[Dict[str, Any]]:
    """The registered pool's occupancy; None without a provider, and, as
    in the JAX module, when the provider raises (an engine closing under
    the sampler's thread)."""
    fn = _kv_pool_fn
    if fn is None:
        return None
    try:
        return fn()
    except Exception:
        return None


# ---------------------------------------------------------------- sampler
class MemSampler:
    """Per-rank measured memory ledger and OOM-proximity sentinel.
    ``sample()`` runs on the runtime's metrics snapshot, rate-limited by
    HOROVOD_MEM_INTERVAL."""

    def __init__(self):
        self.lock = threading.Lock()
        self.last: Optional[Dict[str, Any]] = None
        self.peak_seen = 0        # running max under the CPU source
        self.pressure_above = False   # fire-once transition latch
        self.pressure_events = 0
        self.dump_paths: list = []    # the flight dumps written
        self._last_t: Optional[float] = None

    # ------------------------------------------------------------ geometry
    def _predicted(self) -> Optional[Dict[str, int]]:
        """``zero_memory_bytes`` of the ledger's ZeRO model, or None."""
        from .ledger import GLOBAL
        zero = GLOBAL.zero_model()
        if not zero:
            return None
        from .costmodel import zero_memory_bytes
        try:
            return zero_memory_bytes(
                int(zero.get("level", 1) or 0), zero["n_params"],
                zero["world"], opt_slots=int(zero.get("opt_slots", 2)),
                ef=bool(zero.get("ef", False)))
        except (ValueError, KeyError):
            return None

    def _planes(self, pred, kv, nm) -> Dict[str, int]:
        """Bytes by plane: params, grads, opt_state and ef_residual from the
        ZeRO model; kv_pool and kv_spill (host bytes) from the engine's
        pool; fusion_overlap from threshold x depth; native_core from the
        core's rings and cache."""
        planes: Dict[str, int] = {}
        if pred:
            for key in ("params", "grads", "opt_state", "ef_residual"):
                planes[key] = int(pred[f"{key}_bytes"])
        if kv:
            planes["kv_pool"] = int(kv.get("pool_bytes", 0))
            sp = kv.get("spill")
            if isinstance(sp, dict):
                planes["kv_spill"] = int(sp.get("held_bytes_est", 0))
        threshold = int(_knob("HOROVOD_FUSION_THRESHOLD"))
        depth = max(1, int(_knob("HOROVOD_OVERLAP_DEPTH")))
        planes["fusion_overlap"] = threshold * depth
        if nm:
            planes["native_core"] = int(
                nm.get("trace_ring_bytes", 0)
                + nm.get("window_ring_bytes", 0)
                + nm.get("response_cache_bytes", 0))
        return planes

    # -------------------------------------------------------------- sample
    def sample(self, core: Any = None, device: Any = None,
               now: Optional[float] = None,
               cap_bytes: Optional[int] = None,
               force: bool = False) -> Optional[Dict[str, Any]]:
        """Take (or rate-limit-skip) one measurement: update the hvd_mem_*
        families, the transition latch and ``self.last``.  ``cap_bytes``
        overrides the measured cap (tests; the CPU source has none).
        Returns the sample row, or None when disabled or rate-limited."""
        if not enabled():
            return None
        now = time.time() if now is None else float(now)
        interval = float(_knob("HOROVOD_MEM_INTERVAL"))
        with self.lock:
            if (not force and interval > 0 and self._last_t is not None
                    and now - self._last_t < interval):
                return None
            self._last_t = now
        measured = measure_device(device)
        host_rss = read_host_rss_bytes()
        if cap_bytes is not None:
            measured["cap_bytes"] = int(cap_bytes)
        with self.lock:
            self.peak_seen = max(self.peak_seen, measured["bytes_in_use"])
            if measured["peak_bytes_in_use"] is None:
                measured["peak_bytes_in_use"] = self.peak_seen
        cap = int(measured["cap_bytes"] or 0)
        watermark = (measured["bytes_in_use"] / cap) if cap > 0 else 0.0
        pred = self._predicted()
        nm = native_mem(core)
        kv = kv_pool_stats()
        planes = self._planes(pred, kv, nm)
        drift = None
        if pred and pred.get("total_bytes", 0) > 0 \
                and measured["bytes_in_use"] > 0:
            drift = measured["bytes_in_use"] / pred["total_bytes"]
        row: Dict[str, Any] = {
            "time": now,
            "source": measured["source"],
            "bytes_in_use": measured["bytes_in_use"],
            "peak_bytes_in_use": measured["peak_bytes_in_use"],
            "cap_bytes": cap,
            "host_rss_bytes": host_rss,
            "watermark": watermark,
            "headroom_bytes": (cap - measured["bytes_in_use"]) if cap > 0
            else None,
            "planes": planes,
            "predicted": pred,
            "model_drift_ratio": drift,
            "native": nm,
            "kv_pool": kv,
        }
        self._update_gauges(row)
        self._check_pressure(row, core=core)
        with self.lock:
            self.last = row
        return row

    def _update_gauges(self, row: Dict[str, Any]) -> None:
        from ..utils import metrics as M
        M.MEM_BYTES_IN_USE.set(row["bytes_in_use"])
        M.MEM_PEAK_BYTES.set(row["peak_bytes_in_use"] or 0)
        M.MEM_CAP_BYTES.set(row["cap_bytes"])
        M.MEM_HOST_RSS.set(row["host_rss_bytes"])
        M.MEM_WATERMARK.set(row["watermark"])
        if row["model_drift_ratio"] is not None and \
                math.isfinite(row["model_drift_ratio"]):
            M.MEM_MODEL_DRIFT.set(row["model_drift_ratio"])
        for plane, b in row["planes"].items():
            M.MEM_PLANE_BYTES.set(b, plane=plane)
        nm = row.get("native")
        if nm:
            for key, kind in (("rss_bytes", "rss"),
                              ("peak_rss_bytes", "peak_rss"),
                              ("trace_ring_bytes", "trace_ring"),
                              ("window_ring_bytes", "window_ring"),
                              ("response_cache_bytes", "response_cache")):
                if key in nm:
                    M.MEM_NATIVE_BYTES.set(nm[key], kind=kind)
        kv = row.get("kv_pool")
        if kv:
            used = int(kv.get("used_blocks", 0))
            free = int(kv.get("free_blocks", 0))
            M.MEM_KV_BLOCKS_USED.set(used)
            M.MEM_KV_BLOCKS_FREE.set(free)
            M.MEM_KV_BLOCKS_SHARED.set(kv.get("shared_blocks", 0))
            if used + free > 0:
                M.MEM_KV_UTIL.set(used / (used + free))

    # ------------------------------------------------------------ sentinel
    def _check_pressure(self, row: Dict[str, Any], core: Any = None
                        ) -> None:
        """Fire once per below->above crossing of the watermark; dropping
        below re-arms.  Quiet without a cap."""
        if row["cap_bytes"] <= 0:
            return
        high = float(_knob("HOROVOD_MEM_HIGH_WATERMARK"))
        above = row["watermark"] >= high
        with self.lock:
            fire = above and not self.pressure_above
            self.pressure_above = above
            if fire:
                self.pressure_events += 1
        if not fire:
            return
        from ..utils import metrics as M
        M.MEM_PRESSURE_EVENTS.inc()
        dump = self._flight_dump(row, core=core)
        from ..utils.timeline import trace_instant
        trace_instant("alerts", "mem.pressure",
                      args={"watermark": round(row["watermark"], 4),
                            "bytes_in_use": row["bytes_in_use"],
                            "cap_bytes": row["cap_bytes"]})
        from ..common import hvdlogging as log
        log.warning(
            "memstats: device memory watermark %.1f%% crossed the high "
            "watermark %.1f%% (%d / %d bytes)%s", row["watermark"] * 100,
            high * 100, row["bytes_in_use"], row["cap_bytes"],
            f"; flight dump: {dump}" if dump else "")

    def _flight_dump(self, row: Dict[str, Any], core: Any = None
                     ) -> Optional[str]:
        """Explicit native flight dump, reason ``mem``: the black box
        taken before the process dies of memory.  The path is
        HOROVOD_FLIGHT_RECORD's with a ``.mem`` suffix, so a later crash
        record never overwrites the pressure evidence.  Uses the caller's
        core, else the runtime's; None without either or without a
        path."""
        path = str(_knob("HOROVOD_FLIGHT_RECORD") or "")
        if core is None:
            try:
                from .. import runtime as _rt
                if _rt.is_initialized():
                    core = _rt.get().core
            except Exception:
                core = None
        if core is None or not getattr(core, "_h", True) or not path:
            return None
        path = f"{path}.mem"
        try:
            if core.flight_dump(
                    path, reason=f"mem watermark={row['watermark']:.4f}"):
                with self.lock:
                    self.dump_paths.append(path)
                return path
        except Exception:
            pass  # forensics must never take the training loop down
        return None

    # -------------------------------------------------------------- report
    def report_section(self) -> Optional[Dict[str, Any]]:
        """The ``memory`` section of the perf report: the last sample's
        residency beside the per-plane prediction, the drift ratio and the
        cap headroom.  None before the first sample."""
        with self.lock:
            row = dict(self.last) if self.last else None
            events = self.pressure_events
        if row is None:
            return None
        pred = row.get("predicted") or {}
        table = {}
        for key in ("params", "grads", "opt_state", "ef_residual"):
            if f"{key}_bytes" in pred or key in row["planes"]:
                table[key] = {
                    "predicted_bytes": int(pred.get(f"{key}_bytes", 0)),
                    "attributed_bytes": int(row["planes"].get(key, 0)),
                }
        for key in ("kv_pool", "fusion_overlap", "native_core"):
            if key in row["planes"]:
                table[key] = {"predicted_bytes": None,
                              "attributed_bytes": row["planes"][key]}
        return {
            "source": row["source"],
            "measured": {
                "bytes_in_use": row["bytes_in_use"],
                "peak_bytes_in_use": row["peak_bytes_in_use"],
                "cap_bytes": row["cap_bytes"],
                "host_rss_bytes": row["host_rss_bytes"],
                "watermark": row["watermark"],
                "headroom_bytes": row["headroom_bytes"],
            },
            "predicted_total_bytes": int(pred["total_bytes"])
            if pred else None,
            "model_drift_ratio": row["model_drift_ratio"],
            "planes": table,
            "native": row.get("native"),
            "kv_pool": row.get("kv_pool"),
            "pressure_events": events,
            "time": row["time"],
        }


# ---------------------------------------------------------- module global
GLOBAL = MemSampler()


def reset() -> None:
    """Forget samples, peaks and the pressure latch, and unregister the
    KV-pool provider."""
    global GLOBAL
    GLOBAL = MemSampler()
    set_kv_pool_provider(None)


def sample(**kw) -> Optional[Dict[str, Any]]:
    return GLOBAL.sample(**kw)


def report_section() -> Optional[Dict[str, Any]]:
    return GLOBAL.report_section()


def last_sample() -> Optional[Dict[str, Any]]:
    with GLOBAL.lock:
        return dict(GLOBAL.last) if GLOBAL.last else None
