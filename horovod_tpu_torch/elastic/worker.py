"""Worker-side elastic plumbing: host-update notifications and the run()
wrapper; the port of ``horovod_tpu/elastic/worker.py``.

Reference: the WorkerNotificationManager listens for HostsUpdatedRequest
(reference: horovod/runner/elastic/worker.py:32-119) and the
``@hvd.elastic.run`` decorator implements the reset loop (reference:
horovod/common/elastic.py:151-175):

  loop:
    state.sync() after (re)init
    try: user train fn
    except HorovodInternalError: hard reset: shutdown, re-init,
        state.restore()
    except HostsUpdatedInterrupt: soft reset: keep live state, re-sync.

Host updates arrive via the rendezvous KV store (the driver bumps a
counter key) instead of a per-worker socket service.

The in-process hard reset serves a ``HorovodInternalError`` from the
negotiated engine (the native controller's transport failed); a rank
lost under NCCL leaves its peers blocked in a collective rather than
raising, so on the card the driver restarts the round's processes and the
new round restores the last durable commit (``TreeState.load_from_disk``).
"""

from __future__ import annotations

import functools
import threading
from typing import Any, Callable, Optional

from ..common import hvdlogging as log
from ..common.exceptions import HorovodInternalError, HostsUpdatedInterrupt
from ..common.knobs import Knobs
from ..runner.http_client import get_kv

HOST_UPDATE_SCOPE = "elastic"
HOST_UPDATE_KEY = "host_update_counter"


class WorkerNotificationManager:
    """Polls the rendezvous KV for membership-change bumps (reference:
    worker.py:46-118, transport swapped for the KV store)."""

    def __init__(self, addr: Optional[str] = None,
                 port: Optional[int] = None,
                 poll_interval: float = 1.0):
        knobs = Knobs()
        self.addr = addr if addr is not None else \
            knobs["HOROVOD_RENDEZVOUS_ADDR"]
        self.port = port if port is not None else \
            knobs["HOROVOD_RENDEZVOUS_PORT"]
        self.poll_interval = poll_interval
        self._last_seen = self._read()
        self._updated = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if self.addr and self.port:
            self._thread = threading.Thread(target=self._loop, daemon=True)
            self._thread.start()

    def _read(self) -> int:
        if not (self.addr and self.port):
            return 0
        try:
            v = get_kv(self.addr, self.port, HOST_UPDATE_SCOPE,
                       HOST_UPDATE_KEY, timeout=0)  # poll, never block
            return int(v) if v else 0
        except Exception:
            return 0

    def _loop(self) -> None:
        while not self._stop.wait(self.poll_interval):
            if self._read() > self._last_seen:
                self._updated.set()

    def host_updated(self) -> bool:
        return self._updated.is_set()

    def acknowledge(self) -> None:
        self._last_seen = self._read()
        self._updated.clear()

    def stop(self) -> None:
        self._stop.set()


def run(func: Callable) -> Callable:
    """``@hvd.elastic.run`` (reference: common/elastic.py:151-175).

    The wrapped function takes the elastic ``state`` as its first
    argument.  A ``HorovodInternalError`` gets the shutdown, re-init and
    restore treatment in this process; a ``HostsUpdatedInterrupt`` keeps
    the live state and re-syncs.  ``HOROVOD_ELASTIC_RESET_LIMIT`` bounds
    the resets."""
    @functools.wraps(func)
    def wrapper(state, *args: Any, **kwargs: Any):
        from .. import chaos as _chaos
        from .. import runtime as _rt
        # the chaos plane: this rank's injector exists even when the
        # wrapped fn runs before hvd.init() (the spec rides the elastic
        # driver's rendezvous); loops call hvd.chaos.step(i) to clock
        # kill and stall events
        _chaos.ensure_installed()
        notifier = WorkerNotificationManager()
        state.register_host_update_check(notifier.host_updated)
        reset_limit = Knobs()["HOROVOD_ELASTIC_RESET_LIMIT"]
        resets = 0
        state.sync()
        while True:
            try:
                return func(state, *args, **kwargs)
            except HorovodInternalError as e:
                log.warning("elastic: hard reset after internal error: %s",
                            e)
                device = _rt.get().device if _rt.is_initialized() else None
                _rt.shutdown()
                _rt.init(device=device)
                state.restore()
            except HostsUpdatedInterrupt:
                log.info("elastic: soft reset (hosts updated)")
                notifier.acknowledge()
            resets += 1
            if reset_limit and resets > reset_limit:
                raise RuntimeError(
                    f"elastic reset limit {reset_limit} exceeded "
                    "(reference: --reset-limit semantics)")
            if hasattr(state, "on_reset"):
                state.on_reset()  # user hooks, e.g. LR rescale
            state.sync()
    return wrapper
