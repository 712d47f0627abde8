"""Stall inspector: the deadlock watchdog, the port of
``horovod_tpu/utils/stall.py``.

The reference's coordinator warns when some ranks submitted a tensor and
others haven't for >60 s, and can shut the job down after a second threshold
(reference: horovod/common/stall_inspector.{h,cc}; knobs
HOROVOD_STALL_CHECK_TIME_SECONDS / HOROVOD_STALL_SHUTDOWN_TIME_SECONDS,
stall_inspector.h:70-82; wired into the controller at controller.cc:126-135).

A negotiated collective can stall: a submitted-but-never-completed op
means a peer process died or diverged.  This inspector tracks the
negotiated path's submit/complete pairs (``ops/negotiated.py``) and
raises/warns on the same thresholds.
"""

from __future__ import annotations

import time
from typing import Dict

from ..common import hvdlogging as log
from ..common.exceptions import StallError
from . import metrics as _metrics


class StallInspector:
    """Runs its periodic check on a daemon thread — the submitting thread is
    blocked inside the hung collective when a stall actually happens, so it
    cannot run the check itself (the reference's check runs on the C++
    background coordination thread for the same reason).

    The watcher thread can't raise into the blocked thread; past the
    shutdown threshold it logs FATAL and hard-exits the process, matching
    the reference's stall-shutdown behavior."""

    def __init__(self, warn_seconds: int = 60, shutdown_seconds: int = 0,
                 poll_interval: float = 1.0, hard_exit: bool = True):
        import threading
        self.warn_seconds = warn_seconds
        self.shutdown_seconds = shutdown_seconds
        self.hard_exit = hard_exit
        self._pending: Dict[str, float] = {}
        self._warned: Dict[str, bool] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._watch_loop, args=(poll_interval,), daemon=True)
        self._thread.start()

    def _watch_loop(self, interval: float) -> None:
        import os
        while not self._stop.wait(interval):
            try:
                self.check()
            except StallError as e:
                log.error("stall shutdown: %s", e)
                if self.hard_exit:
                    os._exit(42)

    def close(self) -> None:
        self._stop.set()

    def record_submit(self, name: str) -> None:
        with self._lock:
            self._pending.setdefault(name, time.monotonic())

    def record_complete(self, name: str) -> None:
        # Chaos straggler hook: a stall event at point "complete" slows
        # this rank between the collective's completion and its record,
        # the slow-host straggler mode.  Peers are not dragged along (the
        # collective already finished), so the inflated ages are this
        # rank's own, which is what the straggler report must name.
        from .. import chaos
        chaos.maybe_stall("complete")
        with self._lock:
            submitted = self._pending.pop(name, None)
            self._warned.pop(name, None)
        if submitted is not None:
            # Completion age feeds the per-rank negotiation-age histogram
            # that the rank-0 straggler report quantizes (docs/metrics.md).
            _metrics.NEGOTIATION_AGE.observe(time.monotonic() - submitted)

    def pending_count(self) -> int:
        with self._lock:
            return len(self._pending)

    def check(self) -> None:
        """Warn/abort on overdue tensors (reference:
        StallInspector::CheckForStalledTensors)."""
        now = time.monotonic()
        with self._lock:
            stalled = [(n, now - t) for n, t in self._pending.items()
                       if now - t > self.warn_seconds]
        for name, age in stalled:
            if not self._warned.get(name):
                _metrics.STALL_WARNINGS.inc()
                log.warning(
                    "One or more tensors were submitted to be reduced/"
                    "gathered but were not completed for %.0f seconds: %s. "
                    "This may indicate a dead or diverged peer process.",
                    age, name)
                self._warned[name] = True
            if self.shutdown_seconds and age > self.shutdown_seconds:
                raise StallError(
                    f"tensor {name} stalled for {age:.0f}s > "
                    f"HOROVOD_STALL_SHUTDOWN_TIME_SECONDS="
                    f"{self.shutdown_seconds}")
