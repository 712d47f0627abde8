"""Serving plane: the port of ``horovod_tpu/serve`` (the continuous-
batching engine over the paged KV pool, mixed role, one device)."""

from .config import ServeConfig, from_knobs
from .engine import (BlockAllocator, HostSpillPool, PrefixCache, Request,
                     Scheduler, ServeEngine)

__all__ = ["ServeConfig", "from_knobs", "BlockAllocator", "HostSpillPool",
           "PrefixCache", "Request", "Scheduler", "ServeEngine"]
