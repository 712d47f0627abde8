"""Elastic training: fault-tolerant, resizable jobs; the port of
``horovod_tpu/elastic/``.

Public surface mirrors ``horovod.elastic`` (reference:
horovod/common/elastic.py, horovod/runner/elastic/*):

    import horovod_tpu_torch as hvd

    state = hvd.elastic.TreeState(params=model, opt_state=opt,
                                  sharded_commit_dir=DIR, epoch=0)
    state.load_from_disk()      # a restarted round resumes the last commit

    @hvd.elastic.run
    def train(state):
        ...
        state.commit()

Start such a job with ``python -m horovod_tpu_torch.runner.launch
--min-np N --max-np M --host-discovery-script S python3 train.py``; the
elastic driver (``driver.py``) restarts the round's workers after a
failure or a membership change.  ``TreeState`` is the JAX package's
``JaxState``; the eager frontend's ``TorchState`` and ``ElasticSampler``
are in ``horovod_tpu_torch.torch.elastic``.
"""

from .state import State, ObjectState, TreeState
from .worker import run, WorkerNotificationManager
from .discovery import (HostDiscovery, HostDiscoveryScript, FixedHosts,
                        HostManager)
from .driver import ElasticDriver, WorkerStateRegistry, run_elastic

__all__ = [
    "State", "ObjectState", "TreeState", "run", "WorkerNotificationManager",
    "HostDiscovery", "HostDiscoveryScript", "FixedHosts", "HostManager",
    "ElasticDriver", "WorkerStateRegistry", "run_elastic",
]
