"""Elastic state and sampler of the eager torch API: the port of
``horovod_tpu/torch/elastic.py``.

Mirrors the reference's torch elastic machinery (reference:
horovod/torch/elastic/state.py:27-140 TorchState with per-type handlers;
horovod/torch/elastic/sampler.py:24-131 ElasticSampler).  Sync runs
through the eager API's negotiated broadcasts (``torch/functions.py``);
``run`` is ``horovod_tpu_torch.elastic.run``.
"""

from __future__ import annotations

import copy
import math
from typing import Any, Dict, Optional

import torch

from ..elastic.state import State, ObjectState  # noqa: F401
from ..elastic.worker import run  # noqa: F401  (hvd.elastic.run decorator)
from . import functions as _fn


class TorchState(State):
    """Elastic snapshot of torch model(s)/optimizer(s) + scalar attributes
    (reference: torch/elastic/state.py:27-96).

    Usage: ``state = TorchState(model=model, optimizer=opt, epoch=0)``;
    ``state.sync()`` broadcasts from the new rank 0 after a reset;
    ``state.commit()`` snapshots; ``state.restore()`` rolls back.
    """

    def __init__(self, model: Optional[torch.nn.Module] = None,
                 optimizer: Optional[torch.optim.Optimizer] = None,
                 **kwargs: Any):
        self._models: Dict[str, torch.nn.Module] = {}
        self._optimizers: Dict[str, torch.optim.Optimizer] = {}
        self._samplers: Dict[str, "ElasticSampler"] = {}
        scalars = {}
        named = dict(kwargs)
        if model is not None:
            named.setdefault("model", model)
        if optimizer is not None:
            named.setdefault("optimizer", optimizer)
        for k, v in named.items():
            if isinstance(v, torch.nn.Module):
                self._models[k] = v
            elif isinstance(v, torch.optim.Optimizer):
                self._optimizers[k] = v
            elif isinstance(v, ElasticSampler):
                self._samplers[k] = v
            else:
                scalars[k] = v
        self._snapshots: Dict[str, Any] = {}
        super().__init__(**scalars)
        for k, v in {**self._models, **self._optimizers,
                     **self._samplers}.items():
            setattr(self, k, v)

    # -- handlers (reference: ModelStateHandler/OptimizerStateHandler) ------
    def save(self) -> None:
        super().save()
        for k, m in self._models.items():
            self._snapshots[k] = copy.deepcopy(m.state_dict())
        for k, o in self._optimizers.items():
            self._snapshots[k] = copy.deepcopy(o.state_dict())
        for k, s in self._samplers.items():
            self._snapshots[k] = s.state_dict()

    def restore(self) -> None:
        super().restore()
        for k, m in self._models.items():
            if k in self._snapshots:
                m.load_state_dict(self._snapshots[k])
        for k, o in self._optimizers.items():
            if k in self._snapshots:
                o.load_state_dict(self._snapshots[k])
        for k, s in self._samplers.items():
            if k in self._snapshots:
                s.load_state_dict(self._snapshots[k])

    def sync(self) -> None:
        for m in self._models.values():
            _fn.broadcast_parameters(m.state_dict(), root_rank=0)
        for o in self._optimizers.values():
            _fn.broadcast_optimizer_state(o, root_rank=0)
        for s in self._samplers.values():
            synced = _fn.broadcast_object(s.state_dict(), root_rank=0)
            s.load_state_dict(synced)
        scalars = {f: getattr(self, f) for f in self._fields}
        if scalars:
            synced = _fn.broadcast_object(scalars, root_rank=0)
            for k, v in synced.items():
                setattr(self, k, v)
        self.save()


class ElasticSampler(torch.utils.data.Sampler):
    """Distributed sampler that reshards the *remaining* indices when the
    worker set changes mid-epoch (reference: torch/elastic/sampler.py
    :24-131).

    ``record_batch`` marks samples processed; on ``set_epoch`` or a reset
    the unprocessed remainder is reshuffled over the new world size.
    """

    def __init__(self, dataset, shuffle: bool = True, seed: int = 0):
        self.dataset = dataset
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.processed_indices: set = set()
        self.num_replicas = 0
        self.rank = 0
        self.remaining_indices: list = []
        self.num_samples = 0
        self.total_size = 0
        self.reset()

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        self.processed_indices = set()
        self.reset()

    def record_batch(self, batch_idx: int, batch_size: int) -> None:
        """Mark ``batch_size`` samples starting at local batch
        ``batch_idx`` as processed (reference: sampler.py:61-73)."""
        start = self.rank + batch_idx * batch_size * self.num_replicas
        for i in range(batch_size):
            offset = start + i * self.num_replicas
            if offset < len(self.indices):
                self.processed_indices.add(self.indices[offset])

    def record_indices(self, indices) -> None:
        self.processed_indices.update(indices)

    def reset(self) -> None:
        """Recompute this worker's shard from the unprocessed samples
        (reference: sampler.py:75-105)."""
        from .. import rank as _rank, size as _size
        try:
            self.num_replicas = _size()
            self.rank = _rank()
        except RuntimeError:
            self.num_replicas = 1
            self.rank = 0
        remaining = [i for i in range(len(self.dataset))
                     if i not in self.processed_indices]
        if self.shuffle:
            g = torch.Generator()
            g.manual_seed(self.seed + self.epoch)
            perm = torch.randperm(len(remaining), generator=g).tolist()
            remaining = [remaining[i] for i in perm]
        self.num_samples = int(
            math.ceil(len(remaining) / self.num_replicas))
        self.total_size = self.num_samples * self.num_replicas
        remaining += remaining[:self.total_size - len(remaining)]
        self.remaining_indices = remaining
        self.indices = remaining

    def state_dict(self) -> Dict[str, Any]:
        return {"epoch": self.epoch,
                "processed_indices": sorted(self.processed_indices)}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.epoch = state["epoch"]
        self.processed_indices = set(state["processed_indices"])
        self.reset()

    def __iter__(self):
        return iter(self.indices[self.rank:self.total_size:
                                 self.num_replicas])

    def __len__(self) -> int:
        return self.num_samples
