"""Batch normalization over the global batch: the port of
``horovod_tpu/torch/sync_batch_norm.py`` (the reference's
``horovod.torch.SyncBatchNorm``).

Each rank sums its samples' values and squares per channel in fp32; one
differentiable Sum-allreduce of ``[sum, sum of squares, count]`` gives the
global mean and variance, and autograd carries the backward through the
same allreduce.  The count rides in the reduced vector, so uneven batches
divide by the true global count.  Nothing is read back to the host.
"""

from __future__ import annotations

import itertools

import torch
from torch.nn.modules.batchnorm import _BatchNorm

from .. import runtime as _rt
from ..common.reduce_op import Sum
from . import mpi_ops

_instances = itertools.count()


class SyncBatchNorm(_BatchNorm):
    """Drop-in for ``torch.nn.BatchNorm1d/2d/3d`` whose training-mode
    statistics span every rank's batch."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.1, affine: bool = True,
                 track_running_stats: bool = True):
        super().__init__(num_features, eps, momentum, affine,
                         track_running_stats)
        # negotiation names must agree across ranks, so they come from the
        # order modules are made in, not from id()
        self._hvd_name = f"sync_bn.{next(_instances)}"
        self._hvd_calls = 0

    def _check_input_dim(self, input: torch.Tensor) -> None:
        if input.dim() < 2:
            raise ValueError(
                f"expected at least 2D input (got {input.dim()}D)")

    def forward(self, input: torch.Tensor) -> torch.Tensor:
        self._check_input_dim(input)
        if not self.training or _rt.get().size() == 1:
            return super().forward(input)
        dims = [0] + list(range(2, input.dim()))
        x32 = input.float()
        count = torch.full((1,), float(input.numel() // input.size(1)),
                           device=input.device)
        stats = torch.cat([x32.sum(dim=dims), (x32 * x32).sum(dim=dims),
                           count])
        self._hvd_calls += 1
        stats = mpi_ops.allreduce(
            stats, op=Sum, name=f"{self._hvd_name}.{self._hvd_calls}")
        c = self.num_features
        total = stats[-1]
        mean = stats[:c] / total
        var = stats[c:2 * c] / total - mean * mean

        if self.track_running_stats:
            with torch.no_grad():
                m = self.momentum if self.momentum is not None else 0.1
                unbiased = var * total / (total - 1).clamp_min(1)
                self.running_mean.mul_(1 - m).add_(mean.detach(), alpha=m)
                self.running_var.mul_(1 - m).add_(unbiased.detach(), alpha=m)
                self.num_batches_tracked += 1

        shape = [1, -1] + [1] * (input.dim() - 2)
        mean = mean.to(input.dtype).view(shape)
        var = var.to(input.dtype).view(shape)
        out = (input - mean) / torch.sqrt(var + self.eps)
        if self.affine:
            out = out * self.weight.view(shape) + self.bias.view(shape)
        return out
