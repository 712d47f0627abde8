"""Tensor fusion: bucket plans and the bucket-plan cache, the port of
``horovod_tpu/ops/fusion.py``.

Gradients are grouped greedily into few large same-dtype buckets (the
reference Horovod's 128 MiB fusion buffer), each bucket is packed into one
flat tensor, reduced by one collective, and unpacked.  Plans are cached by
the exact (shapes, dtypes, threshold) signature, so steady-state training
hits the cache every step.  Planning counts into the metrics registry as
the JAX module does: each closed bucket's bytes
(``hvd_fusion_bucket_bytes``) and why it closed
(``hvd_fusion_bucket_flush_total``: threshold, filled or tail); the
runtime's snapshot imports the cache's hits and misses.
"""

from __future__ import annotations

import collections
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..utils import metrics as _metrics


class Bucket:
    """One fused collective: a list of leaf indices sharing a dtype."""

    __slots__ = ("dtype", "indices", "sizes", "shapes", "nbytes")

    def __init__(self, dtype: torch.dtype):
        self.dtype = dtype
        self.indices: List[int] = []
        self.sizes: List[int] = []
        self.shapes: List[Tuple[int, ...]] = []
        self.nbytes = 0

    def add(self, idx: int, shape: Tuple[int, ...], nbytes: int) -> None:
        self.indices.append(idx)
        self.shapes.append(tuple(shape))
        self.sizes.append(math.prod(shape))
        self.nbytes += nbytes


class BucketPlan:
    """A fusion plan for a flat list of tensors."""

    def __init__(self, buckets: List[Bucket], num_leaves: int):
        self.buckets = buckets
        self.num_leaves = num_leaves


def make_plan(shapes: Sequence[Tuple[int, ...]],
              dtypes: Sequence[torch.dtype],
              threshold_bytes: int) -> BucketPlan:
    """Greedy same-dtype bucketing up to ``threshold_bytes`` per bucket.

    Tensors are taken in order, one open bucket per dtype; a bucket closes
    when the next same-dtype tensor would overflow it, or when it reaches
    the threshold.  A tensor larger than the threshold gets its own bucket.
    """
    open_buckets: Dict[torch.dtype, Bucket] = {}
    done: List[Bucket] = []

    def close(b: Bucket, reason: str) -> None:
        done.append(b)
        _metrics.FUSION_FLUSHES.inc(reason=reason)
        _metrics.FUSION_BUCKET_BYTES.observe(b.nbytes)

    for i, (shape, dtype) in enumerate(zip(shapes, dtypes)):
        nbytes = math.prod(shape) * dtype.itemsize
        b = open_buckets.get(dtype)
        if b is not None and b.nbytes + nbytes > threshold_bytes and b.indices:
            close(b, "threshold")  # next tensor would overflow the bucket
            b = None
        if b is None:
            b = Bucket(dtype)
            open_buckets[dtype] = b
        b.add(i, shape, nbytes)
        if b.nbytes >= threshold_bytes:
            close(b, "filled")
            del open_buckets[dtype]
    for b in open_buckets.values():
        if b.indices:
            close(b, "tail")  # end-of-step leftover
    return BucketPlan(done, len(shapes))


class BucketPlanCache:
    """LRU cache of bucket plans; ``capacity`` follows
    HOROVOD_CACHE_CAPACITY, and 0 disables caching."""

    def __init__(self, capacity: int = 1024):
        self.capacity = capacity
        self._cache: "collections.OrderedDict[Any, BucketPlan]" = \
            collections.OrderedDict()
        self.hits = 0
        self.misses = 0

    def get(self, shapes: Sequence[Tuple[int, ...]],
            dtypes: Sequence[torch.dtype], threshold_bytes: int) -> BucketPlan:
        key = (tuple(map(tuple, shapes)), tuple(str(d) for d in dtypes),
               int(threshold_bytes))
        if self.capacity > 0 and key in self._cache:
            self._cache.move_to_end(key)
            self.hits += 1
            return self._cache[key]
        self.misses += 1
        plan = make_plan(shapes, dtypes, threshold_bytes)
        if self.capacity > 0:
            self._cache[key] = plan
            while len(self._cache) > self.capacity:
                self._cache.popitem(last=False)
        return plan


def pack_bucket(leaves: Sequence[torch.Tensor], bucket: Bucket) -> torch.Tensor:
    """The bucket's leaves as one flat tensor; a one-leaf bucket is a view
    of that leaf, so a collective on it works in place."""
    parts = [leaves[i].reshape(-1) for i in bucket.indices]
    if len(parts) == 1:
        return parts[0]
    return torch.cat(parts)


def pack_bucket_padded(leaves: Sequence[torch.Tensor], bucket: Bucket,
                       multiple: int,
                       dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """:func:`pack_bucket` padded with zeros to a multiple of ``multiple``:
    the shard geometry the ZeRO chain reduce-scatters
    (``parallel/zero.py``), a bucket split 1/n per rank.  With ``dtype``
    the leaves are cast into one new buffer of that dtype (no per-leaf
    copies); without it a bucket that needs no pad is
    :func:`pack_bucket`'s result."""
    m = max(multiple, 1)
    total = sum(bucket.sizes)
    padded = -(-total // m) * m
    first = leaves[bucket.indices[0]]
    if dtype is None:
        if padded == total:
            return pack_bucket(leaves, bucket)
        dtype = first.dtype
    out = torch.empty(padded, dtype=dtype, device=first.device)
    off = 0
    for i, size in zip(bucket.indices, bucket.sizes):
        out[off:off + size].copy_(leaves[i].reshape(-1))
        off += size
    out[total:].zero_()
    return out


def unpack_bucket(buffer: torch.Tensor, bucket: Bucket,
                  out: List[Optional[torch.Tensor]]) -> None:
    """Split a fused buffer back into its leaves (views), into ``out``."""
    for idx, piece, shape in zip(bucket.indices,
                                 buffer.split(bucket.sizes), bucket.shapes):
        out[idx] = piece.view(shape)


def fused_apply(leaves: Sequence[torch.Tensor], plan: BucketPlan,
                fn: Callable[[torch.Tensor], torch.Tensor]
                ) -> List[torch.Tensor]:
    """Apply ``fn`` (a collective on a flat buffer, returning a buffer of the
    same shape) to each fused bucket and un-fuse."""
    out: List[Optional[torch.Tensor]] = [None] * plan.num_leaves
    for bucket in plan.buckets:
        unpack_bucket(fn(pack_bucket(leaves, bucket)), bucket, out)
    return out  # type: ignore[return-value]
