"""Spark integration (reference: horovod/spark/); the port of
``horovod_tpu/spark/``'s placement layer, Store, ``prepare_data`` and the
Linear and Torch estimators.

``horovod_tpu_torch.spark.run(fn, num_proc)`` runs a training function on
cluster tasks and returns one result per task; ``run_elastic`` places it
again at one task fewer after a failure.  An estimator persists a dataset
as parquet in a ``Store`` (``prepare_data``), trains on ``num_proc`` tasks
that stream their shards, checkpoints every epoch and returns an
``EstimatorModel`` whose ``transform`` predicts.  pyspark is needed only
for ``SparkTaskExecutor``; local placement works without it.  The Keras
and Lightning estimators are not ported yet.
"""

from .runner import (LocalTaskExecutor, SparkTaskExecutor, TaskExecutor,
                     run, run_elastic)
from .store import DBFSLocalStore, FilesystemStore, LocalStore, Store
from .prepare import prepare_data
from .estimator import (Estimator, EstimatorModel, LinearEstimator,
                        TorchEstimator)

__all__ = ["run", "run_elastic", "TaskExecutor", "LocalTaskExecutor",
           "SparkTaskExecutor", "Store", "FilesystemStore", "LocalStore",
           "DBFSLocalStore", "prepare_data", "Estimator", "EstimatorModel",
           "LinearEstimator", "TorchEstimator"]
