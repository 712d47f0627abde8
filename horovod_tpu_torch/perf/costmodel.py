"""The ZeRO cost model: the port's copy of ``zero_comm_bytes`` and
``zero_memory_bytes`` (with the helpers they need) from
``horovod_tpu/perf/costmodel.py``.  Plain arithmetic, no framework: the
per-rank wire bytes of one step of the ZeRO chain (``parallel/zero.py``)
and the per-rank resident bytes of the training state under a level.
The rest of the JAX package's cost model (roofline step time, layout
solver, FLOP counts) is not ported yet."""

from __future__ import annotations

import math
from typing import Dict

# Wire itemsize per reduce-scatter-leg format (bytes per element on the
# wire), the ops/wire.py formats' table.
WIRE_ITEMSIZE: Dict[str, float] = {
    "none": 4.0, "bf16": 2.0, "fp16": 2.0,
    "int8_ring": 1.0, "dcn_int8": 1.0,
}
ZERO_LEVELS = (0, 1, 2, 3)


def _ring_half_leg(n: int, nelems: float, itemsize: float) -> float:
    """One reduce_scatter OR all_gather leg of the ring, per rank: (n-1)
    chunks of ceil(nelems/n) elements (half of a ring allreduce)."""
    if n <= 1:
        return 0.0
    return (n - 1) * math.ceil(nelems / n) * itemsize


def zero_comm_bytes(nelems: float, world: int, level: int, *,
                    k: int = 1, wire_format: str = "none",
                    itemsize: float = 4.0) -> Dict[str, float]:
    """Per-rank modeled wire bytes of ONE optimizer step of the ZeRO chain,
    the reduce-scatter (RS) and all-gather (AG) legs priced separately:

      level 0  plain data parallelism: accumulate k microbatches locally,
               one allreduce (both ring phases at the wire itemsize);
      level 1  k per-microbatch syncs; at k > 1 each shard is gathered
               back to keep the full gradient accumulator, plus the update
               all-gather;
      level 2  k reduce-scatters onto the resident shard + one update
               all-gather;
      level 3  k reduce-scatters + one parameter all-gather at step start
               (the same bytes as level 2).

    The RS leg carries ``wire_format``'s itemsize; AG legs are exact
    (``itemsize``)."""
    if level not in ZERO_LEVELS:
        raise ValueError(f"zero level {level} invalid; must be one of "
                         f"{ZERO_LEVELS}")
    n = int(world)
    enc = WIRE_ITEMSIZE.get(wire_format, itemsize)
    rs = _ring_half_leg(n, nelems, enc)
    ag = _ring_half_leg(n, nelems, itemsize)
    if level == 0:
        rs_total, ag_total = rs, _ring_half_leg(n, nelems, enc)
    elif level == 1:
        rs_total = k * rs
        ag_total = (k + 1) * ag if k > 1 else ag
    else:
        rs_total, ag_total = k * rs, ag
    return {"rs_bytes": rs_total, "ag_bytes": ag_total,
            "total_bytes": rs_total + ag_total}


def zero_memory_bytes(level: int, n_params: float, world: int, *,
                      opt_slots: int = 2, ef: bool = False,
                      itemsize: float = 4.0) -> Dict[str, int]:
    """Per-rank resident bytes of the training state under a ZeRO level:
    parameters, the gradient accumulator, the optimizer state
    (``opt_slots`` parameter-sized buffers, 2 for Adam's moments) and the
    error-feedback residual (full size per rank when on).  Level 0 is plain
    data parallelism."""
    if level not in ZERO_LEVELS:
        raise ValueError(f"zero level {level} invalid; must be one of "
                         f"{ZERO_LEVELS}")
    n = max(int(world), 1)
    p = float(n_params) * itemsize
    out = {
        "params_bytes": p / n if level >= 3 else p,
        "grads_bytes": p / n if level >= 2 else p,
        "opt_state_bytes": (p * opt_slots / n if level >= 1
                            else p * opt_slots),
        "ef_residual_bytes": p if ef else 0.0,
    }
    out = {key: int(v) for key, v in out.items()}
    out["total_bytes"] = sum(out.values())
    return out
