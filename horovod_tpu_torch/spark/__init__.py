"""Spark integration (reference: horovod/spark/); the port of
``horovod_tpu/spark/``: the placement layer, the Store, ``prepare_data``
and the Linear, Torch, Keras and Lightning estimators.

``horovod_tpu_torch.spark.run(fn, num_proc)`` runs a training function on
cluster tasks and returns one result per task; ``run_elastic`` places it
again at one task fewer after a failure.  An estimator persists a dataset
as parquet in a ``Store`` (``prepare_data``), trains on ``num_proc`` tasks
that stream their shards, checkpoints every epoch and returns an
``EstimatorModel`` whose ``transform`` predicts.  pyspark is needed only
for ``SparkTaskExecutor``; local placement works without it.

Where the estimators depart from the JAX package's: every task calls
``hvd.init()`` and trains on its card (the CPU only when asked for);
``LightningEstimator`` builds its module under ``torch.device`` of the
task's device, so a protocol object with no ``.to`` lands there too
(``spark/lightning.py``); ``KerasEstimator`` trains on keras's torch
backend, its tasks' env setting ``KERAS_BACKEND=torch`` and
``JAX_PLATFORMS=cpu``, and imports keras only inside its task and its
driver-side loader (``spark/estimator.py``).
"""

from .runner import (LocalTaskExecutor, SparkTaskExecutor, TaskExecutor,
                     run, run_elastic)
from .store import DBFSLocalStore, FilesystemStore, LocalStore, Store
from .prepare import prepare_data
from .estimator import (Estimator, EstimatorModel, KerasEstimator,
                        LinearEstimator, TorchEstimator)
from .lightning import LightningEstimator

__all__ = ["run", "run_elastic", "TaskExecutor", "LocalTaskExecutor",
           "SparkTaskExecutor", "Store", "FilesystemStore", "LocalStore",
           "DBFSLocalStore", "prepare_data", "Estimator", "EstimatorModel",
           "LinearEstimator", "KerasEstimator", "TorchEstimator",
           "LightningEstimator"]
