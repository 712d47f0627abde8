"""Serving plane: the port of ``horovod_tpu/serve`` (docs/serving.md).

  * the engine (:mod:`.engine`): continuous batching over the paged KV
    pool, mixed or disaggregated prefill/decode roles, ``Llama`` and
    ``MoeLlama``, servable directories;
  * the pool sharded over a fleet's ranks (:mod:`.pool`):
    ``cache_shardings``, the plan a rank's engine takes, and the partial
    attention and its merge;
  * the fleet: the router (:mod:`.router`, ``POST /generate`` and ``GET
    /serve/stats`` on the launcher's rendezvous server), the workers
    (:mod:`.worker`, one engine per rank in lockstep over the plan
    stream), the direct token stream (:mod:`.stream`), the request
    journal and redrive (:mod:`.journal`), the replica tier
    (:mod:`.replica`) and request traces (:mod:`.trace`).
    ``python -m horovod_tpu_torch.runner.launch --serve DIR`` launches it.

The fleet's modules load lazily, as in the JAX package.
"""

from __future__ import annotations

from .config import ServeConfig, from_knobs, validate_serve_knobs
from .engine import (BlockAllocator, HostSpillPool, PrefixCache, Request,
                     Scheduler, ServeEngine)
from .pool import PoolMesh, PoolPlan, cache_shardings, fleet_pool_plan

_LAZY = {
    "save_servable": ("engine", "save_servable"),
    "load_servable": ("engine", "load_servable"),
    "FleetFrontend": ("worker", "FleetFrontend"),
    "JOURNAL_SCOPE": ("journal", "JOURNAL_SCOPE"),
    "redrive_plan": ("journal", "redrive_plan"),
    "emitted_prefix": ("journal", "emitted_prefix"),
}


def __getattr__(name: str):
    if name in _LAZY:
        import importlib
        mod, attr = _LAZY[name]
        return getattr(importlib.import_module(f".{mod}", __name__), attr)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["ServeConfig", "from_knobs", "validate_serve_knobs",
           "BlockAllocator", "HostSpillPool", "PrefixCache", "Request",
           "Scheduler", "ServeEngine", "PoolMesh", "PoolPlan",
           "cache_shardings", "fleet_pool_plan", *_LAZY.keys()]
