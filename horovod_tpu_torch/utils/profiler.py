"""The deep-dive profiler: the port of ``horovod_tpu/utils/profiler.py``
over ``torch.profiler`` and NVTX, the counterpart of the reference
Horovod's NVTX op ranges (``horovod/common/nvtx_op_range.h``: every
user-facing op opens a range, so a device trace attributes time to the op
that launched it).

``start(logdir)``/``stop()`` (or ``with trace(logdir):``) capture one
session with ``torch.profiler``, the CPU activity always and the CUDA
activity when the runtime's device is a card, and write it as a Chrome
trace, ``trace.<pid>.json`` in ``logdir``.  A capture on a CUDA runtime
that holds no CUDA activity raises at ``stop``: it is not kept as a
CPU-only trace.  ``annotate(name)`` opens a named range,
``record_function`` in the capture and, on a CUDA runtime, an NVTX range
for external tools; the eager collectives open ``HOROVOD_<KIND>`` ranges
(``ops/collectives.py``), as the JAX ones do.  Outside a session a range
costs a ``record_function`` and, on a card, an NVTX push and pop.  The
timeline (``utils/timeline.py``) stays the always-on view; this is the
deep-dive tool.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import time
from typing import Callable, Iterator, Optional, Tuple

_active = None          # the running torch.profiler.profile
_active_logdir: Optional[str] = None
_active_cuda = False
last_trace_path: Optional[str] = None


def _cuda_runtime() -> bool:
    """True when the initialized runtime drives a CUDA device."""
    from .. import runtime as _rt
    return _rt.is_initialized() and _rt.get().device.type == "cuda"


def start(logdir: str) -> None:
    """Begin a capture that :func:`stop` writes into ``logdir``."""
    global _active, _active_logdir, _active_cuda
    if _active is not None:
        raise RuntimeError(f"profiler: a session is already writing to "
                           f"{_active_logdir}")
    from torch.profiler import ProfilerActivity, profile
    cuda = _cuda_runtime()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.__enter__()
    _active, _active_logdir, _active_cuda = prof, logdir, cuda


def stop() -> str:
    """End the capture and write its Chrome trace; returns the file's
    path.  On a CUDA runtime the device is synchronized first, and a
    trace without CUDA activity raises."""
    global _active, _active_logdir, _active_cuda, last_trace_path
    prof, logdir, cuda = _active, _active_logdir, _active_cuda
    if prof is None:
        raise RuntimeError("profiler: no session to stop")
    # cleared first: a failing stop must not block every later session
    _active, _active_logdir, _active_cuda = None, None, False
    if cuda:
        import torch
        torch.cuda.synchronize()
    prof.__exit__(None, None, None)
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, f"trace.{os.getpid()}.json")
    prof.export_chrome_trace(path)
    last_trace_path = path
    if cuda and not trace_kernels(path):
        raise RuntimeError(
            f"profiler: the capture in {path} holds no CUDA activity on a "
            "CUDA runtime")
    return path


def is_active() -> bool:
    return _active is not None


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[None]:
    """``with hvd.profiler.trace(dir): step()``: one session."""
    start(logdir)
    try:
        yield
    finally:
        stop()


def trace_kernels(path: str) -> list:
    """The CUDA kernel events (``cat`` ``kernel``) of a Chrome trace
    written by :func:`stop`."""
    with open(path) as f:
        doc = json.load(f)
    events = doc.get("traceEvents", doc) if isinstance(doc, dict) else doc
    return [e for e in events
            if isinstance(e, dict) and e.get("cat") == "kernel"]


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named range: ``record_function`` in a capture and, on a CUDA
    runtime, an NVTX range."""
    import torch
    nvtx = _cuda_runtime()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


def annotate_function(fn=None, name: Optional[str] = None):
    """Decorator form of :func:`annotate` (the function's qualified name
    by default); usable bare or as ``annotate_function(name=...)``."""
    if fn is None:
        return functools.partial(annotate_function, name=name)
    label = name or getattr(fn, "__qualname__", repr(fn))

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with annotate(label):
            return fn(*args, **kwargs)
    return wrapper


def timed(fn: Callable[[], object],
          name: str = "HOROVOD_EXEC") -> Tuple[object, float]:
    """Run ``fn`` inside a named range and return ``(result,
    duration_us)`` on the host's clock (on a card: the enqueue)."""
    t0 = time.perf_counter_ns()
    with annotate(name):
        result = fn()
    return result, (time.perf_counter_ns() - t0) / 1e3


__all__ = ["start", "stop", "trace", "annotate", "annotate_function",
           "is_active", "timed", "trace_kernels"]
