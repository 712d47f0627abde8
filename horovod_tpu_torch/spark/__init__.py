"""Cluster placement on Spark (reference: horovod/spark/); the port of
``horovod_tpu/spark/``'s placement layer.

``horovod_tpu_torch.spark.run(fn, num_proc)`` runs a training function on
cluster tasks and returns one result per task; ``run_elastic`` places it
again at one task fewer after a failure.  pyspark is needed only for
``SparkTaskExecutor``; local placement works without it.  The Store,
``prepare_data`` and the estimators are not ported yet (ROADMAP queue 1
item 5), so they are not exported.
"""

from .runner import (LocalTaskExecutor, SparkTaskExecutor, TaskExecutor,
                     run, run_elastic)

__all__ = ["run", "run_elastic", "TaskExecutor", "LocalTaskExecutor",
           "SparkTaskExecutor"]
