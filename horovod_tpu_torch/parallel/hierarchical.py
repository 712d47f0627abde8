"""Two-level collectives: the port of ``horovod_tpu/parallel/hierarchical.py``
(the reference Horovod's hierarchical allreduce and allgather).

The JAX package runs them on a two-level ``(dcn.X, ici.X)`` mesh: ICI inside
a slice, DCN across slices.  The port's counterpart is the runtime's host
layout: ranks are laid out host-major, ``local_size`` per host, so the
"ici" level is the ranks of one host (NVLink) and the "dcn" level the
ranks with the same local index on every host (the network).  The layout
is two-level when ``1 < local_size < size``; the runtime then builds
both groups of every rank at ``init`` (``Runtime.hierarchy``).

The two-level allreduce sends ``bytes / local_size`` across hosts:

    reduce_scatter inside the host  ->  allreduce across hosts
        ->  all_gather inside the host

``resolve_axis`` has no counterpart: the port names no mesh axes, and
which groups a rank belongs to follows from the layout alone.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from ..common.reduce_op import ReduceOp
from ..ops import spmd
from ..ops.quantized import quantized_ring_allreduce, reciprocal

Groups = Tuple[dist.ProcessGroup, dist.ProcessGroup]


def split_hierarchy() -> Optional[Groups]:
    """``(cross_group, local_group)`` of this rank on a two-level layout
    (the JAX package's ``(dcn_axis, ici_axis)``), else None."""
    from .. import runtime as _rt
    if not _rt.is_initialized():
        return None
    return _rt.get().hierarchy


def _scatter_sum(flat: torch.Tensor, local: dist.ProcessGroup
                 ) -> torch.Tensor:
    """Reduce-scatter ``flat`` (its length a multiple of the group's size)
    over ``local``: this rank's share of the sum."""
    shard = flat.new_empty(flat.numel() // dist.get_world_size(local))
    dist.reduce_scatter_tensor(shard, flat, op=dist.ReduceOp.SUM,
                               group=local)
    return shard


def _gather(shard: torch.Tensor, local: dist.ProcessGroup) -> torch.Tensor:
    full = shard.new_empty(shard.numel() * dist.get_world_size(local))
    dist.all_gather_into_tensor(full, shard, group=local)
    return full


def _padded(x: torch.Tensor, ici: int) -> torch.Tensor:
    flat = x.reshape(-1)
    pad = (-flat.numel()) % ici
    return torch.cat([flat, flat.new_zeros(pad)]) if pad else flat


def hierarchical_allreduce(x: torch.Tensor, cross_group: dist.ProcessGroup,
                           local_group: dist.ProcessGroup,
                           op: ReduceOp = ReduceOp.SUM,
                           prescale_factor: float = 1.0,
                           postscale_factor: float = 1.0) -> torch.Tensor:
    """Two-level allreduce of ``x`` in place (returns ``x``).

    Sum and Average ride the reduce_scatter -> cross allreduce ->
    all_gather pipeline; Min, Max, Product and Adasum have no
    scatter-reduce and fall back to the flat reduction over every rank
    (Adasum's recursion over the host-major ranks is the JAX package's over
    the combined ``(dcn, ici)`` axes)."""
    if op not in (ReduceOp.SUM, ReduceOp.AVERAGE):
        # flat fallback through the process group directly: spmd.allreduce
        # would route back here while the knob is on
        spmd.scale_(x, prescale_factor)
        if op == ReduceOp.ADASUM:
            from .adasum import adasum_allreduce
            x.copy_(adasum_allreduce(x))
        else:
            dist.all_reduce(x, op=spmd.torch_op(op))
        return spmd.scale_(x, postscale_factor)

    spmd.scale_(x, prescale_factor)
    ici = dist.get_world_size(local_group)
    n = ici * dist.get_world_size(cross_group)
    shard = _scatter_sum(_padded(x, ici), local_group)
    dist.all_reduce(shard, op=dist.ReduceOp.SUM, group=cross_group)
    full = _gather(shard, local_group)[:x.numel()]
    if op == ReduceOp.AVERAGE:
        full = spmd.scale_(full, 1.0, n)
    full = spmd.scale_(full, postscale_factor)
    return x.copy_(full.view(x.shape))


def dcn_selective_int8_allreduce(x: torch.Tensor,
                                 cross_group: dist.ProcessGroup,
                                 local_group: dist.ProcessGroup,
                                 average: bool = True) -> torch.Tensor:
    """Two-level allreduce that quantizes only the cross-host leg (the
    ``dcn_int8`` wire format of ops/wire.py; EQuARX's selective
    composition): an exact fp32 reduce_scatter inside the host, the int8
    ring across hosts on this rank's shard, an exact all_gather inside the
    host.  Returns a new tensor in ``x``'s dtype."""
    ici = dist.get_world_size(local_group)
    n = ici * dist.get_world_size(cross_group)
    shard = _scatter_sum(_padded(x.to(torch.float32), ici), local_group)
    shard = quantized_ring_allreduce(shard, cross_group, average=False)
    out = _gather(shard, local_group)[:x.numel()].view(x.shape)
    if average:
        out = out * reciprocal(n)
    return out.to(x.dtype)


def hierarchical_allgather(x: torch.Tensor, cross_group: dist.ProcessGroup,
                           local_group: dist.ProcessGroup,
                           axis: int = 0) -> torch.Tensor:
    """Two-level allgather: gather inside the host, then across hosts.
    The concatenation is host-major, the same as a flat allgather over
    every rank of a host-major layout."""
    def gather(t: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
        parts = [torch.empty_like(t)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, t.contiguous(), group=group)
        return torch.cat(parts, dim=axis)
    return gather(gather(x, local_group), cross_group)
