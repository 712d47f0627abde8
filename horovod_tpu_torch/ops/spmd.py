"""Allreduce and allgather over the process group: the port of
``horovod_tpu/ops/spmd.py``'s ``allreduce`` and ``allgather``.

Average follows the reference's convert-to-postscale trick: SUM followed by
a 1/size postscale.  Adasum runs the XOR-partner recursion of
``parallel/adasum.py`` over every rank, taking ``x`` as one vector.  The
reduction is in place on ``x``.  On a two-level host layout
(``parallel/hierarchical.py``) the HOROVOD_HIERARCHICAL_* knobs, read live,
route both through their two-level algorithms.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..common.knobs import current
from ..common.reduce_op import ReduceOp

_TORCH_OPS = {
    ReduceOp.SUM: dist.ReduceOp.SUM,
    ReduceOp.AVERAGE: dist.ReduceOp.SUM,
    ReduceOp.MIN: dist.ReduceOp.MIN,
    ReduceOp.MAX: dist.ReduceOp.MAX,
    ReduceOp.PRODUCT: dist.ReduceOp.PRODUCT,
}


def torch_op(op: ReduceOp) -> dist.ReduceOp:
    """The process group's reduction for ``op`` (Average reduces by SUM and
    is scaled by 1/size afterwards).  Adasum has none: it is a recursion of
    pairwise exchanges, which only :func:`allreduce` runs."""
    if op not in _TORCH_OPS:
        raise ValueError(
            f"{ReduceOp(op).name} is not a process-group reduction: only "
            "allreduce takes it")
    return _TORCH_OPS[op]


def scale_(x: torch.Tensor, factor: float, divisor: int = 1) -> torch.Tensor:
    """``x *= factor / divisor`` in ``x``'s dtype; an integer tensor
    truncates, as the JAX frontend's cast back from a float result does."""
    if factor == 1.0 and divisor == 1:
        return x
    if x.is_floating_point():
        return x.mul_(factor / divisor)
    return x.copy_(torch.trunc(x.double() * factor / divisor))


def _two_level(knob: str):
    """This rank's ``(cross_group, local_group)`` when ``knob`` is on and
    the layout is two-level, else None."""
    if not current(knob):
        return None
    from ..parallel.hierarchical import split_hierarchy
    return split_hierarchy()


def allreduce(x: torch.Tensor, op: ReduceOp = ReduceOp.AVERAGE,
              prescale_factor: float = 1.0,
              postscale_factor: float = 1.0) -> torch.Tensor:
    """Reduce ``x`` in place across every rank and return it."""
    pair = _two_level("HOROVOD_HIERARCHICAL_ALLREDUCE")
    if pair is not None:
        from ..parallel.hierarchical import hierarchical_allreduce
        return hierarchical_allreduce(x, *pair, op=op,
                                      prescale_factor=prescale_factor,
                                      postscale_factor=postscale_factor)
    scale_(x, prescale_factor)
    if op == ReduceOp.ADASUM:
        from ..parallel.adasum import adasum_allreduce
        out = adasum_allreduce(x)
        if out is not x:
            x.copy_(out)
        return scale_(x, postscale_factor)
    dist.all_reduce(x, op=torch_op(op))
    return scale_(x, postscale_factor, dist.get_world_size()
                  if op == ReduceOp.AVERAGE else 1)


def allgather(x: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Every rank's ``x`` (the same shape on every rank) concatenated along
    ``axis``, in rank order."""
    pair = _two_level("HOROVOD_HIERARCHICAL_ALLGATHER")
    if pair is not None:
        from ..parallel.hierarchical import hierarchical_allgather
        return hierarchical_allgather(x, *pair, axis=axis)
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, x)
    return torch.cat(parts, dim=axis)
