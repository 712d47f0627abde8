"""The performance-attribution plane: the port of ``horovod_tpu/perf/``.

  * ``costmodel``: FLOP and byte accounting and the roofline predicted
    step;
  * ``ledger``: the measured step decomposition (compute, exposed comm,
    host input, stall, summing exactly to the measured step),
    ``hvd.perf_report()``, the ``hvd_perf_*`` families and the publisher
    behind ``GET /perf``; the native core's per-op aggregates
    (``ledger.native_op_stats``);
  * ``memstats``: the measured memory ledger and its sentinel;
  * ``gate``: the median +/- MAD regression gate
    (``python -m horovod_tpu_torch.perf.gate``).

A training loop opts in with two calls:

    hvd.perf.configure(flops_per_step=..., comm_bytes_per_step=...)
    with hvd.perf.timed_step():
        loss = step(batch)
    print(hvd.perf_report()["verdict"])
"""

from __future__ import annotations

from . import memstats  # noqa: F401  (hvd.perf.memstats)
from .ledger import (GLOBAL, PerfLedger, PerfPublisher, add_input_wait,
                     configure, merge_perf_reports, native_op_stats,
                     record_step, report, reset, resolve_chip, timed_step)
from .memstats import MemSampler, validate_mem_knobs

# hvd.perf_report() is the root package's spelling of report()
perf_report = report


def configure_from_overlap_gauges() -> bool:
    return GLOBAL.configure_from_overlap_gauges()


def validate_perf_knobs(knobs) -> None:
    """The HOROVOD_PERF_* knobs, checked at ``init``: a known link class
    or ``auto``, and a positive publish period."""
    from .costmodel import LINK_CLASSES
    link = str(knobs["HOROVOD_PERF_LINK"])
    if link != "auto" and link not in LINK_CLASSES:
        raise ValueError(
            f"HOROVOD_PERF_LINK={link!r} invalid; use 'auto' or one of "
            f"{', '.join(LINK_CLASSES)}")
    if knobs["HOROVOD_PERF_INTERVAL"] <= 0:
        raise ValueError(
            f"HOROVOD_PERF_INTERVAL={knobs['HOROVOD_PERF_INTERVAL']} "
            "invalid; the perf-report publish period must be positive "
            "seconds")


def resolve_link(knobs, runtime=None) -> str:
    """The link class the roofline prices comm with: the knob when it
    names one, else by topology.  The JAX function reads a mesh (a
    ``dcn.*`` axis, a TPU mesh, a CPU one); the port reads the runtime
    (``runtime``, default the initialized one): ranks on more than one
    host -> ``"dcn"``, CUDA ranks on one host -> ``"nvlink"``, the CPU or
    no runtime -> ``"loopback"``."""
    link = str(knobs["HOROVOD_PERF_LINK"])
    if link != "auto":
        return link
    if runtime is None:
        from .. import runtime as _rt
        if not _rt.is_initialized():
            return "loopback"
        runtime = _rt.get()
    if runtime.cross_size() > 1:
        return "dcn"
    if runtime.device.type == "cuda":
        return "nvlink"
    return "loopback"


__all__ = [
    "GLOBAL", "MemSampler", "PerfLedger", "PerfPublisher",
    "add_input_wait", "configure", "configure_from_overlap_gauges",
    "memstats", "merge_perf_reports", "native_op_stats", "perf_report",
    "record_step", "report", "reset", "resolve_chip", "resolve_link",
    "timed_step", "validate_mem_knobs", "validate_perf_knobs",
]
