"""DistributedOptimizer: the port of ``horovod_tpu/optimizer.py``
(``sync_gradients``, ``distributed_optimizer``) in the Horovod torch idiom.

``DistributedOptimizer(torch_optimizer, named_parameters=...)`` returns an
optimizer of the same class whose ``step()`` first allreduces the gradients:
packed into the fusion plan's buckets, one collective per bucket, unpacked
back into each ``.grad``.  With ``backward_passes_per_step = n > 1`` it
follows the JAX wrapper: every ``step()`` adds the current gradients into an
accumulator, and every n-th ``step()`` syncs their mean and applies the
update; the other calls leave the parameters alone.

The sync runs at ``step()``.  The eager API's ``DistributedOptimizer``
(``horovod_tpu_torch.torch``) starts it during the backward through
gradient hooks instead.  Wire formats other than 'none' and compression
come in later slices and raise here.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence

import torch

from . import runtime as _rt
from .common.knobs import KNOBS
from .common.reduce_op import Average, ReduceOp
from .ops import spmd
from .ops.fusion import fused_apply, make_plan


def _plan_for(tensors: Sequence[torch.Tensor], threshold: int):
    shapes = [tuple(t.shape) for t in tensors]
    dtypes = [t.dtype for t in tensors]
    if _rt.is_initialized():
        return _rt.get().plan_cache.get(shapes, dtypes, threshold)
    return make_plan(shapes, dtypes, threshold)


def sync_gradients(params_or_grads: Iterable[torch.Tensor],
                   op: ReduceOp = Average,
                   prescale_factor: float = 1.0,
                   postscale_factor: float = 1.0,
                   fusion_threshold_bytes: Optional[int] = None
                   ) -> List[torch.Tensor]:
    """Allreduce gradients in place with bucket fusion and return them.

    Takes parameters (their ``.grad`` is synced; parameters without one are
    skipped) or the gradient tensors themselves."""
    grads = []
    for t in params_or_grads:
        if isinstance(t, torch.nn.Parameter):
            if t.grad is not None:
                grads.append(t.grad)
        else:
            grads.append(t)
    if not grads:
        return grads
    if not all(g.is_contiguous() for g in grads):
        raise ValueError("sync_gradients needs contiguous gradients")
    threshold = fusion_threshold_bytes
    if threshold is None:
        threshold = (_rt.get().fusion_threshold() if _rt.is_initialized()
                     else KNOBS["HOROVOD_FUSION_THRESHOLD"].default)

    def reduce(buf: torch.Tensor) -> torch.Tensor:
        return spmd.allreduce(buf, op=op, prescale_factor=prescale_factor,
                              postscale_factor=postscale_factor)

    synced = fused_apply(grads, _plan_for(grads, threshold), reduce)
    with torch.no_grad():
        for g, s in zip(grads, synced):
            if s.data_ptr() != g.data_ptr():  # one-leaf buckets reduced in place
                g.copy_(s)
    return grads


class _DistributedOptimizer(torch.optim.Optimizer):
    """Methods merged into a subclass of the wrapped optimizer's class."""

    _hvd_wrapper = True

    def __init__(self, params, op, backward_passes_per_step,
                 fusion_threshold_bytes):
        super(self.__class__, self).__init__(params)
        self._hvd_op = op
        self._hvd_passes = backward_passes_per_step
        self._hvd_threshold = fusion_threshold_bytes
        self._hvd_count = 0
        self._hvd_acc = None

    def _hvd_params(self) -> List[torch.Tensor]:
        return [p for group in self.param_groups for p in group["params"]
                if p.grad is not None]

    def synchronize(self) -> None:
        """Allreduce every parameter's gradient (what ``step`` runs)."""
        sync_gradients(self._hvd_params(), op=self._hvd_op,
                       fusion_threshold_bytes=self._hvd_threshold)

    def step(self, closure=None):
        if self._hvd_passes == 1:
            self.synchronize()
            return super(self.__class__, self).step(closure)
        params = self._hvd_params()
        with torch.no_grad():
            if self._hvd_acc is None:
                self._hvd_acc = {p: torch.zeros_like(p.grad) for p in params}
            for p in params:
                self._hvd_acc[p].add_(p.grad)
        self._hvd_count += 1
        if self._hvd_count % self._hvd_passes:
            return None
        with torch.no_grad():
            for p in params:
                p.grad.copy_(self._hvd_acc[p]).div_(self._hvd_passes)
                self._hvd_acc[p].zero_()
        self.synchronize()
        return super(self.__class__, self).step(closure)


def DistributedOptimizer(optimizer: torch.optim.Optimizer,
                         named_parameters=None,
                         op: ReduceOp = Average,
                         backward_passes_per_step: int = 1,
                         fusion_threshold_bytes: Optional[int] = None,
                         compression=None,
                         wire_policy: Optional[str] = None,
                         overlap: bool = False) -> torch.optim.Optimizer:
    """Wrap ``optimizer`` so that ``step()`` sees gradients synced across
    ranks (Horovod: ``hvd.DistributedOptimizer``).  The result is an
    instance of a subclass of ``optimizer``'s class, built on its
    ``param_groups`` (hyperparameters kept, state fresh)."""
    if backward_passes_per_step < 1:
        raise ValueError("backward_passes_per_step must be >= 1")
    if compression is not None:
        raise NotImplementedError(
            "gradient compression comes with the wire-plane slice")
    if wire_policy not in (None, "none"):
        raise NotImplementedError(
            f"wire_policy={wire_policy!r}: the port implements 'none' only; "
            "wire formats come with the wire-plane slice")
    if overlap:
        raise NotImplementedError(
            "overlap comes with the overlap-and-prefetch slice")
    if named_parameters is not None:
        named = {id(p) for _, p in named_parameters}
        if any(id(p) not in named for group in optimizer.param_groups
               for p in group["params"]):
            raise ValueError("named_parameters does not name every "
                             "parameter of the optimizer")
    cls = type(optimizer.__class__.__name__, (optimizer.__class__,),
               dict(_DistributedOptimizer.__dict__))
    return cls(optimizer.param_groups, op, backward_passes_per_step,
               fusion_threshold_bytes)
