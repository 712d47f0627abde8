"""Ray integration (reference: horovod/ray/runner.py:128 RayExecutor,
strategy.py placement, elastic.py ElasticRayExecutor); the port of
``horovod_tpu/ray/``."""

from .runner import (BaseHorovodWorker, BaseWorkerPool, LocalWorkerPool,
                     RayExecutor, RayWorkerPool)
from .elastic import ElasticRayExecutor, RayHostDiscovery

__all__ = ["RayExecutor", "BaseHorovodWorker", "BaseWorkerPool",
           "LocalWorkerPool", "RayWorkerPool", "ElasticRayExecutor",
           "RayHostDiscovery"]
