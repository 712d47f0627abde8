"""Allreduce over the process group: the port of
``horovod_tpu/ops/spmd.py``'s ``allreduce``.

Average follows the reference's convert-to-postscale trick: SUM followed by
a 1/size postscale.  The reduction is in place on ``x``.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

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
    is scaled by 1/size afterwards)."""
    if op not in _TORCH_OPS:
        raise NotImplementedError(
            f"{ReduceOp(op).name} allreduce is not ported yet: Adasum comes "
            "with the 3D/sequence/expert-parallel slice (ROADMAP queue 1 "
            "item 6)")
    return _TORCH_OPS[op]


def scale_(x: torch.Tensor, factor: float, divisor: int = 1) -> torch.Tensor:
    """``x *= factor / divisor`` in ``x``'s dtype; an integer tensor
    truncates, as the JAX frontend's cast back from a float result does."""
    if factor == 1.0 and divisor == 1:
        return x
    if x.is_floating_point():
        return x.mul_(factor / divisor)
    return x.copy_(torch.trunc(x.double() * factor / divisor))


def allreduce(x: torch.Tensor, op: ReduceOp = ReduceOp.AVERAGE,
              prescale_factor: float = 1.0,
              postscale_factor: float = 1.0) -> torch.Tensor:
    """Reduce ``x`` in place across every rank and return it."""
    red = torch_op(op)
    scale_(x, prescale_factor)
    dist.all_reduce(x, op=red)
    return scale_(x, postscale_factor, dist.get_world_size()
                  if op == ReduceOp.AVERAGE else 1)
