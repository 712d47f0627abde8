"""Small shared utilities: the port's copy of the jax-free part of
``horovod_tpu/common/util.py`` that its planes need."""

from __future__ import annotations

import random
from typing import List


def backoff_delays(retries: int, base_ms: float, cap_ms: float = 2000.0,
                   rng=None) -> List[float]:
    """Exponential-backoff schedule in SECONDS with jitter: attempt i
    sleeps U[step/2, step] where step = min(cap, base * 2**i).

    One implementation shared by every retry loop that talks to a peer:
    the rendezvous KV client (``runner/http_client.py``) and the serving
    fleet's KV legs (``serve/worker.py``).  ``rng`` (a ``random.Random``)
    makes the jitter deterministic for tests; the module-global stream is
    used otherwise."""
    rng = rng or random
    out: List[float] = []
    step = float(base_ms)
    for _ in range(max(0, retries)):
        step_c = min(step, float(cap_ms))
        out.append(rng.uniform(step_c / 2.0, step_c) / 1000.0)
        step *= 2.0
    return out
