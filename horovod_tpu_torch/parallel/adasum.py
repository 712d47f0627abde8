"""Adasum: the scale-adaptive gradient combiner, the port of
``horovod_tpu/parallel/adasum.py`` (the reference Horovod's
``ReduceOp::ADASUM``, ``adasum.h``).

A pair of vectors ``a``, ``b`` combines into
``(1 - a.b / 2|a|^2) a + (1 - a.b / 2|b|^2) b``: parallel vectors average,
orthogonal ones add.  Over a power-of-two group the combine runs as
log2(n) rounds of an XOR-partner exchange (round k pairs rank i with rank
``i ^ 2^k``), each one ``batch_isend_irecv`` pair; after every round both
partners hold the same vector bitwise (the combine is symmetric in its two
arguments), so the recursion needs no scatter or gather phase.  Dot
products and squared norms are taken in fp32 whatever the vector's dtype.

The JAX package names mesh axes; here a process group stands for each
(``None``: the world), and the two-level variant takes the runtime's host
layout (``parallel/hierarchical.split_hierarchy``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .pipeline import _exchange

Tensor = torch.Tensor


def _adasum_combine(a: Tensor, b: Tensor, dot_group=None) -> Tensor:
    """One Adasum pair combine (``adasum.h:124-137``).  ``dot_group``: the
    vectors are sharded over this group (FSDP-style), so the partial dot
    products and norms are summed over it first."""
    af, bf = a.float(), b.float()
    stats = torch.stack([(af * bf).sum(), (af * af).sum(), (bf * bf).sum()])
    if dot_group is not None:
        dist.all_reduce(stats, group=dot_group)
    dot, na, nb = stats.unbind()
    # orthogonal or zero vectors degrade to plain summation (the
    # reference's epsilon handling)
    ca = torch.where(na > 0, 1.0 - dot / (2.0 * na.clamp_min(1e-30)), 1.0)
    cb = torch.where(nb > 0, 1.0 - dot / (2.0 * nb.clamp_min(1e-30)), 1.0)
    return (ca * af + cb * bf).to(a.dtype)


def adasum_allreduce(x: Tensor, group=None, dot_group=None) -> Tensor:
    """Adasum-allreduce ``x`` across ``group`` (the world when None), whose
    size must be a power of two, like the reference's reduction comms.
    Returns a new tensor (``x`` itself at size 1)."""
    g = dist.group.WORLD if group is None else group
    n = dist.get_world_size(g)
    if n == 1:
        return x
    if n & (n - 1):
        raise ValueError(
            f"Adasum requires a power-of-two axis size, got {n} "
            "(reference restriction: power-of-two reduction comms)")
    idx = dist.get_rank(g)
    y = x.contiguous()
    for k in range(n.bit_length() - 1):
        peer = dist.get_global_rank(g, idx ^ (1 << k))
        y = _adasum_combine(y, _exchange(y, peer, peer, g),
                            dot_group=dot_group)
    return y


def adasum_hierarchical(x: Tensor, intra_group, cross_group) -> Tensor:
    """Two-level Adasum: the mean inside each host (``intra_group``; the
    reference averages within a node), then Adasum across hosts
    (``cross_group``).  Returns a new tensor."""
    local = x.clone()
    dist.all_reduce(local, group=intra_group)
    local.div_(dist.get_world_size(intra_group))
    return adasum_allreduce(local, cross_group)


__all__ = ["adasum_allreduce", "adasum_hierarchical"]
