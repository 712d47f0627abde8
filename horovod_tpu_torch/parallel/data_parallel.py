"""Data-parallel training steps: the port of
``horovod_tpu/parallel/data_parallel.py`` (``cast_params``,
``make_train_step``, ``make_microbatched_train_step``,
``make_scanned_train_step``).

Every rank holds the whole model.  ``step(*batch)`` takes the global batch,
runs ``loss_fn`` on this rank's rows of it, backpropagates, and calls the
optimizer, which (wrapped in ``DistributedOptimizer``) allreduces the
gradients before its update, so parameters stay identical on every rank.
The loss it returns is the mean over ranks, as the JAX step's ``pmean``.

Mixed precision the JAX package's way (``compute_dtype``): the parameters
and the optimizer state stay in their storage dtype (fp32 master weights),
and the loss runs on a copy cast to ``compute_dtype`` (bf16), substituted
for the module's parameters by ``torch.func.functional_call``; autograd
differentiates through the cast, so the gradients arrive in fp32.  The
JAX package's device loops (``lax.scan``) are Python loops here.
"""

from __future__ import annotations

from typing import Any, Callable, Mapping, Optional, Sequence

import torch
import torch.distributed as dist

from .. import runtime as _rt
from ..common.reduce_op import Average
from ..ops import spmd


def local_shard(x: torch.Tensor, rank: int, size: int) -> torch.Tensor:
    """Rows ``[rank*n, (rank+1)*n)`` of ``x``, n = rows / size."""
    if x.shape[0] % size:
        raise ValueError(f"batch of {x.shape[0]} rows does not split over "
                         f"{size} ranks")
    n = x.shape[0] // size
    return x[rank * n:(rank + 1) * n]


def cast_params(tree: Any, dtype: torch.dtype) -> Any:
    """Cast the floating tensors of a mapping, list or tuple of tensors
    (nested) to ``dtype``; other leaves pass through.  Differentiable."""
    if torch.is_tensor(tree):
        return tree.to(dtype) if tree.is_floating_point() else tree
    if isinstance(tree, Mapping):
        return {k: cast_params(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_params(v, dtype) for v in tree)
    return tree


class _LossOf(torch.nn.Module):
    """``loss_fn(model, *batch)`` as a module holding ``model``, so
    ``functional_call`` can run it on substituted parameters."""

    def __init__(self, model: torch.nn.Module, loss_fn: Callable):
        super().__init__()
        self.model = model
        self.loss_fn = loss_fn

    def forward(self, *batch):
        return self.loss_fn(self.model, *batch)


def _compute_cast(model: Any, loss_fn: Callable,
                  compute_dtype: Optional[torch.dtype]) -> Callable:
    """``batch -> loss`` with ``model``'s parameters cast to
    ``compute_dtype`` for the forward (None: as they are)."""
    if compute_dtype is None:
        return lambda *batch: loss_fn(model, *batch)
    if not isinstance(model, torch.nn.Module):
        return lambda *batch: loss_fn(cast_params(model, compute_dtype),
                                      *batch)
    wrapper = _LossOf(model, loss_fn)

    def fn(*batch):
        params = {f"model.{n}": p for n, p in model.named_parameters()}
        return torch.func.functional_call(
            wrapper, cast_params(params, compute_dtype), batch)
    return fn


def _rank_size():
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _rank_mean(loss: torch.Tensor, size: int) -> torch.Tensor:
    mean = loss.detach().float().clone()
    if size > 1:
        spmd.allreduce(mean, op=Average)
    return mean


def make_train_step(model_or_params: Any,
                    loss_fn: Callable[..., torch.Tensor],
                    optimizer: torch.optim.Optimizer) -> Callable:
    """Build ``step(*batch) -> loss``.

    ``loss_fn(model_or_params, *local_batch)`` returns this rank's scalar
    loss; ``optimizer`` holds the parameters and, to sync them, is a
    ``DistributedOptimizer``.  Batch tensors are moved to the runtime's
    device; the returned loss stays there (no host sync)."""
    rank, size = _rank_size()
    device = _rt.resolve_device()

    def step(*batch: torch.Tensor) -> torch.Tensor:
        local = [local_shard(b, rank, size).to(device, non_blocking=True)
                 for b in batch]
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(model_or_params, *local)
        loss.backward()
        optimizer.step()
        return _rank_mean(loss, size)

    return step


def make_microbatched_train_step(model: Any, loss_fn: Callable[..., torch.Tensor],
                                 optimizer: torch.optim.Optimizer,
                                 backward_passes_per_step: int,
                                 compute_dtype: Optional[torch.dtype] = None,
                                 overlap: Optional[bool] = None,
                                 overlap_depth: Optional[int] = None
                                 ) -> Callable:
    """Build ``step(batch) -> loss``: ONE optimizer update over ``k =
    backward_passes_per_step`` microbatches.  ``batch`` is ``[k,
    global_batch, ...]``; each microbatch's rows are split over the ranks,
    run forward and backward, and handed to ``optimizer.step()``, which must
    be the port's ``DistributedOptimizer`` made with the same
    ``backward_passes_per_step``: it accumulates the k gradients and
    applies their synced mean on the k-th call, or, with the overlap plane
    on, syncs each microbatch's gradients on the side stream while the
    next microbatch computes (``ops/overlap.py``).  ``overlap`` and
    ``overlap_depth``, when given, set the optimizer's pipeline
    (``set_overlap``); else it keeps its own.  Returns the mean over the
    microbatches of the rank-mean loss."""
    k = backward_passes_per_step
    if k < 1:
        raise ValueError("backward_passes_per_step must be >= 1")
    if overlap is not None or overlap_depth is not None:
        if not hasattr(optimizer, "set_overlap"):
            raise ValueError("overlap needs the port's DistributedOptimizer")
        optimizer.set_overlap(overlap, overlap_depth)
    rank, size = _rank_size()
    device = _rt.resolve_device()
    fn = _compute_cast(model, loss_fn, compute_dtype)

    def step(batch: torch.Tensor) -> torch.Tensor:
        if batch.shape[0] != k:
            raise ValueError(f"batch has {batch.shape[0]} microbatches, "
                             f"backward_passes_per_step is {k}")
        losses = []
        for mb in batch:
            optimizer.zero_grad(set_to_none=True)
            loss = fn(local_shard(mb, rank, size).to(device,
                                                     non_blocking=True))
            loss.backward()
            optimizer.step()
            losses.append(loss.detach().float())
        # one reduction after the last microbatch: a collective on the
        # caller's stream between microbatches would queue behind the
        # pipeline's gradient sync in flight (a process group runs its
        # collectives on one NCCL stream, in issue order) and hold the
        # next microbatch's compute until that sync finished
        return _rank_mean(torch.stack(losses), size).mean()

    return step


def make_scanned_train_step(model: Any, loss_fn: Callable[..., torch.Tensor],
                            optimizer: torch.optim.Optimizer) -> Callable:
    """Build ``run(batches) -> losses``: ``batches.shape[0]`` optimizer
    steps, one per ``[global_batch, ...]`` slice, as a loop over
    ``make_train_step``'s step; ``losses`` has one rank-mean loss per
    step."""
    step = make_train_step(model, loss_fn, optimizer)

    def run(batches: Sequence[torch.Tensor]) -> torch.Tensor:
        return torch.stack([step(b) for b in batches])

    return run
