"""Cross-rank clock alignment for the distributed tracing plane: the port
of ``horovod_tpu/utils/clocksync.py``.

Two ranks' trace events can only be laid side by side if their timestamps
share an epoch; host wall clocks can disagree by milliseconds to seconds,
the same order as the events being traced.  This module runs an NTP-style
offset/RTT handshake against the rendezvous KV server's ``GET /clock``
route (``runner/http_server.py``) at ``hvd.init``, and again on every
trace-chunk publish (``utils/timeline.py`` ``TimelinePublisher``), so drift
over a long job stays bounded.

The estimator is the classic minimum-RTT filter: each probe yields

    offset_i      = server_time_i - (t0_i + t1_i) / 2
    uncertainty_i = (t1_i - t0_i) / 2          # the RTT half-window

and the probe with the smallest RTT wins: queueing delay only ever adds to
RTT, so the fastest exchange is the most symmetric one.  The measured
offset and its uncertainty ride the trace chunks as metadata, and the
merged timeline (``GET /timeline``) reports them per rank.

Ranks that cannot reach the server fall back to offset 0 with infinite
uncertainty: local tracing keeps working, only the cross-rank alignment
claim is withdrawn.
"""

from __future__ import annotations

import math
import time
import urllib.request
from typing import List, Optional, Tuple

# (local send time, server time, local receive time) of one probe.
Sample = Tuple[float, float, float]


def best_offset(samples: List[Sample]) -> Tuple[float, float]:
    """(offset, uncertainty) seconds from probe samples: the minimum-RTT
    sample's midpoint offset, uncertainty = that sample's RTT/2.  Pure
    function so the rebase math is unit-testable with synthetic skew."""
    best: Optional[Tuple[float, float]] = None
    for t0, server, t1 in samples:
        rtt = t1 - t0
        if rtt < 0:
            continue  # clock stepped mid-probe; unusable
        offset = server - (t0 + t1) / 2.0
        if best is None or rtt / 2.0 < best[1]:
            best = (offset, rtt / 2.0)
    if best is None:
        return 0.0, math.inf
    return best


class ClockSync:
    """One rank's live clock-offset estimate against the rendezvous
    server (offset is SERVER minus LOCAL wall seconds: aligned time =
    local + offset)."""

    def __init__(self, addr: str, port: int, samples: int = 5,
                 timeout: float = 2.0, measure_now: bool = True):
        self.addr = addr
        self.port = int(port)
        self.samples = int(samples)
        self.timeout = float(timeout)
        self.offset = 0.0
        self.uncertainty = math.inf
        self.synced = False
        if measure_now:
            self.measure()

    def _probe(self) -> Sample:
        url = f"http://{self.addr}:{self.port}/clock"
        t0 = time.time()
        with urllib.request.urlopen(url, timeout=self.timeout) as resp:
            server = float(resp.read().decode())
        t1 = time.time()
        return (t0, server, t1)

    def measure(self) -> bool:
        """Re-estimate the offset; False (estimate unchanged) when the
        server is unreachable — alignment is tooling, never a job
        failure."""
        if not (self.addr and self.port):
            return False
        probes: List[Sample] = []
        for _ in range(self.samples):
            try:
                probes.append(self._probe())
            except Exception:
                continue
        if not probes:
            return False
        self.offset, self.uncertainty = best_offset(probes)
        self.synced = True
        return True

    def meta(self) -> dict:
        """JSON-able alignment metadata for trace chunks / merge output."""
        return {"offset": self.offset,
                "uncertainty": (None if math.isinf(self.uncertainty)
                                else self.uncertainty),
                "synced": self.synced}
