"""Small cross-frontend utilities: the port of
``horovod_tpu/common/util.py`` (reference: horovod/common/util.py):
extension and device probes against this stack (the port's native core
instead of per-framework C extensions, torch's view of the cards), the
Adasum rank check, the retry schedule and the list helper."""

from __future__ import annotations

import os
import random
from typing import List, Sequence


def check_extension(ext_name: str = "horovod_tpu_torch.csrc") -> None:
    """Verify the native coordination core builds and loads (reference:
    util.py check_extension, which raises ImportError with install
    guidance when the framework's C extension is absent).  Raises
    ImportError with the build error when the core cannot load."""
    try:
        from .basics import load_library
        load_library()
    except Exception as e:
        raise ImportError(
            f"native core unavailable for {ext_name}: {e}\n"
            "It builds from horovod_tpu_torch/csrc/core with g++ at first "
            "use (ops/_native.py); install g++ or fix the build error") \
            from e


def gpu_available(ext_base_name: str = "torch",
                  verbose: bool = False) -> bool:
    """Is a CUDA device attached? (reference: util.py gpu_available.)
    Torch's view, asked without creating a CUDA context; a CPU-pinned
    process (``utils/platform.py`` ``force_cpu``, or
    ``CUDA_VISIBLE_DEVICES=""``) answers False without asking."""
    from ..utils import platform
    if platform.cpu_forced() or os.environ.get(
            "CUDA_VISIBLE_DEVICES") == "":
        return False
    import torch
    try:
        return torch.cuda.is_available()
    except Exception as e:  # a driver that fails to answer
        if verbose:
            print(f"gpu_available: {ext_base_name} CUDA probe failed: {e}")
        return False


def check_num_rank_power_of_2(num_rank: int) -> bool:
    """True when ``num_rank`` is a power of two (reference:
    mpi_ops.check_num_rank_power_of_2 — the Adasum recursive-halving
    precondition; parallel/adasum.py enforces the same rule)."""
    return num_rank > 0 and (num_rank & (num_rank - 1)) == 0


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


def split_list(items: Sequence, num_parts: int) -> List[list]:
    """Split into ``num_parts`` nearly-equal contiguous chunks
    (reference: util.py split_list, used by grouped allreduce)."""
    n = len(items)
    base, extra = divmod(n, num_parts)
    out, start = [], 0
    for i in range(num_parts):
        size = base + (1 if i < extra else 0)
        out.append(list(items[start:start + size]))
        start += size
    return out
