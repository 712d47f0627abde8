"""The wire-policy plane: per-bucket wire formats for the fused gradient
sync, the port of ``horovod_tpu/ops/wire.py``.

A policy is a function

    policy(bucket_nbytes, dtype, layout) -> wire format name

evaluated per fusion bucket, so a sync can send its few big fp32 buckets
as int8 ring hops while the small latency-bound tail rides exact.  Where
the JAX package passes a mesh axis name, the port passes ``layout``: the
ring sizes by fabric, ``{"flat": n}`` or, on a two-level host layout,
``{"dcn": hosts, "ici": ranks per host}`` (``_axis_sizes``; "dcn" is the
network between hosts and "ici" the link inside one, the JAX package's
names kept so the byte model's keys match).

Formats:

  none       exact allreduce in the bucket's dtype (two-level under
             HOROVOD_HIERARCHICAL_ALLREDUCE)
  bf16/fp16  cast compression around the allreduce (ops/compression.py)
  int8_ring  int8 quantized ring allreduce with fp32 accumulation
             (ops/quantized.py); on a two-level layout one ring across
             hosts, then one inside each host
  dcn_int8   reduce_scatter inside the host -> int8 ring across hosts ->
             all_gather inside the host (parallel/hierarchical.py)

Policies are named by the same strings plus ``auto`` (the per-bucket
heuristic).  Error feedback keeps each rank's one-shot encode error ``x -
C(x)`` and adds it into the next step's gradient before compression
(EF-SGD); the residuals are the optimizer's (optimizer.py).  Every format
decodes to the same values on every rank.

The measurement plane's hooks, as in the JAX module: :func:`plan_formats`
counts each bucket's format into ``hvd_wire_buckets_total`` and its
modeled bottleneck bytes saved into ``hvd_wire_bytes_saved_total``, and
emits a ``wire.encode.<fmt>`` instant per bucket on the runtime's
timeline.  The JAX package does that once per traced program; the port
has no trace, so a caller that plans at every sync (the optimizer) passes
``once=True`` and the registry counts once per distinct bucket plan and
policy, the port's counterpart of a trace: after N steps it reads what
the JAX registry reads after N steps of one compiled step.  This module's
``stats()`` keeps counting at every call (a departure ROADMAP keeps).
"""

from __future__ import annotations

import collections
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import torch

from ..common.reduce_op import ReduceOp
from ..parallel import hierarchical
from . import spmd
from .compression import Compression
from .fusion import BucketPlan, pack_bucket, unpack_bucket
from .quantized import int8_error, int8_roundtrip, quantized_ring_allreduce

Layout = Dict[str, int]
# policy(bucket_nbytes, dtype, layout) -> format name
Policy = Callable[[int, torch.dtype, Layout], str]

FORMAT_NAMES = ("none", "bf16", "fp16", "int8_ring", "dcn_int8")
POLICY_NAMES = FORMAT_NAMES + ("auto",)
LOSSY_FORMATS = ("bf16", "fp16", "int8_ring", "dcn_int8")

# auto-policy thresholds: below SMALL the collective is latency-bound and
# compression buys nothing; above INT8_MIN the 4x byte saving dominates.
SMALL_BUCKET_BYTES = 64 * 1024
INT8_MIN_BYTES = 4 * 1024 * 1024

_BUCKETS: "collections.Counter[str]" = collections.Counter()
_BYTES_SAVED: "collections.Counter[str]" = collections.Counter()
# plans already counted into the registry by ``plan_formats(once=True)``
_RECORDED: set = set()


def stats() -> Dict[str, Dict[str, float]]:
    """Buckets synced per format and modeled bottleneck bytes saved per
    format, since the process started (the JAX package's
    ``hvd_wire_buckets_total`` and ``hvd_wire_bytes_saved_total``)."""
    return {"buckets": dict(_BUCKETS), "bytes_saved": dict(_BYTES_SAVED)}


def validate_policy_name(name: str) -> str:
    """Fail loudly on an unknown policy name (``init`` checks the
    HOROVOD_WIRE_POLICY knob with it)."""
    if name not in POLICY_NAMES:
        raise ValueError(
            f"unknown wire policy {name!r}; valid policies: "
            f"{', '.join(POLICY_NAMES)} (HOROVOD_WIRE_POLICY)")
    return name


def _is_hierarchical(layout: Layout) -> bool:
    return "dcn" in layout


def auto_policy(nbytes: int, dtype: torch.dtype, layout: Layout) -> str:
    """The per-bucket heuristic of ``auto``: big floating buckets take the
    int8 wire (across hosts only, on a two-level layout), mid-size fp32
    buckets cast to bf16, the small tail stays exact."""
    if not dtype.is_floating_point:
        return "none"
    if nbytes < SMALL_BUCKET_BYTES:
        return "none"
    if nbytes >= INT8_MIN_BYTES:
        return "dcn_int8" if _is_hierarchical(layout) else "int8_ring"
    return "bf16" if dtype.itemsize >= 4 else "none"


def _fixed_policy(fmt: str) -> Policy:
    def policy(nbytes: int, dtype: torch.dtype, layout: Layout) -> str:
        return fmt
    return policy


# one function a name, so a policy keeps its identity across syncs (the
# registry counts once per plan and policy: ``plan_formats``)
_FIXED: Dict[str, Policy] = {name: _fixed_policy(name)
                             for name in FORMAT_NAMES}


def get_policy(policy: Union[str, Policy]) -> Policy:
    """A policy name (or a callable, passed through) as the per-bucket
    decision function; a name gives the same function every time."""
    if callable(policy):
        return policy
    validate_policy_name(policy)
    if policy == "auto":
        return auto_policy
    return _FIXED[policy]


def is_lossy(fmt: str) -> bool:
    return fmt in LOSSY_FORMATS


def resolve_format(fmt: str, dtype: torch.dtype, layout: Layout,
                   op: ReduceOp) -> str:
    """Degrade a requested format to what the bucket can carry: non-float
    buckets and non-linear reductions stay exact, no-op casts collapse to
    none, and ``dcn_int8`` on a flat layout becomes the flat int8 ring."""
    if fmt not in FORMAT_NAMES:
        raise ValueError(f"unknown wire format {fmt!r}; valid formats: "
                         f"{', '.join(FORMAT_NAMES)}")
    if fmt == "none" or not dtype.is_floating_point:
        return "none"
    if fmt in ("int8_ring", "dcn_int8"):
        if op not in (ReduceOp.AVERAGE, ReduceOp.SUM):
            return "none"
        if fmt == "dcn_int8" and not _is_hierarchical(layout):
            return "int8_ring"
        return fmt
    wire_dt = {"bf16": torch.bfloat16, "fp16": torch.float16}[fmt]
    return "none" if wire_dt == dtype else fmt


def reduce_bucket(buf: torch.Tensor, fmt: str, op: ReduceOp,
                  prescale_factor: float = 1.0,
                  postscale_factor: float = 1.0) -> torch.Tensor:
    """Allreduce one flat bucket buffer in its wire format over every
    rank.  ``none`` reduces ``buf`` in place; the other formats return a
    new tensor."""
    if fmt in ("none", "bf16", "fp16"):
        comp = Compression.by_name(fmt)
        buf, ctx = comp.compress(buf)
        buf = spmd.allreduce(buf, op=op, prescale_factor=prescale_factor,
                             postscale_factor=postscale_factor)
        return comp.decompress(buf, ctx)

    average = op == ReduceOp.AVERAGE
    if prescale_factor != 1.0:
        buf = buf * prescale_factor
    pair = hierarchical.split_hierarchy()
    if fmt == "int8_ring":
        out = quantized_ring_allreduce(buf, pair, average=average)
    elif fmt == "dcn_int8":
        if pair is None:
            raise ValueError("dcn_int8 needs a two-level layout "
                             "(resolve_format degrades this case)")
        out = hierarchical.dcn_selective_int8_allreduce(
            buf, *pair, average=average)
    else:
        raise ValueError(f"unknown wire format {fmt!r}")
    if postscale_factor != 1.0:
        out = out * postscale_factor
    return out


def wire_roundtrip(buf: torch.Tensor, fmt: str) -> torch.Tensor:
    """``C(buf)``: the decoded value of putting ``buf`` on the wire in
    ``fmt`` under the one-shot codec model (encode once, decode once)."""
    if fmt in ("bf16", "fp16"):
        comp = Compression.by_name(fmt)
        c, ctx = comp.compress(buf)
        return comp.decompress(c, ctx)
    if fmt in ("int8_ring", "dcn_int8"):
        return int8_roundtrip(buf)
    return buf


def local_error(buf: torch.Tensor, fmt: str) -> torch.Tensor:
    """The rank-local compensable encode error ``x - C(x)`` of putting
    ``buf`` on the wire in ``fmt``: the EF-SGD residual.  For an fp32
    buffer on the int8 wire it is exact (``quantized.int8_error``), as
    XLA's fused multiply-add makes it in the JAX function."""
    if fmt in ("int8_ring", "dcn_int8") and buf.dtype == torch.float32:
        return int8_error(buf)
    if is_lossy(fmt):
        return buf - wire_roundtrip(buf, fmt)
    return torch.zeros_like(buf)


# ------------------------------------------------------------ wire model
def _axis_sizes() -> Layout:
    """The ring sizes of the runtime's layout: ``{"flat": size}``, or
    ``{"dcn": cross_size, "ici": local_size}`` on a two-level layout;
    ``{"flat": 1}`` without a runtime."""
    from .. import runtime as _rt
    if not _rt.is_initialized():
        return {"flat": 1}
    rt = _rt.get()
    if rt.hierarchy is not None:
        return {"dcn": rt.cross_size(), "ici": rt.local_size()}
    return {"flat": rt.size()}


def modeled_wire_bytes(nelems: int, itemsize: int, fmt: str,
                       axis_sizes: Layout) -> Dict[str, Any]:
    """Per-rank wire bytes for one allreduce of an ``nelems``-element
    bucket, by fabric, under the ring model (each rank sends 2(n-1) chunks
    of nelems/n elements; the int8 scales are left out).  ``bottleneck``
    is the slow fabric's total: across hosts on a two-level layout, the
    one fabric otherwise.  A model, not a measurement."""
    def ring(n: int, elems: int, wire_itemsize: float) -> float:
        if n <= 1:
            return 0.0
        return 2.0 * (n - 1) * math.ceil(elems / n) * wire_itemsize

    two_level = "dcn" in axis_sizes
    if fmt == "dcn_int8" and two_level:
        ici, dcn = axis_sizes["ici"], axis_sizes["dcn"]
        shard = math.ceil(nelems / max(ici, 1))
        per_fabric = {"ici": 2.0 * (ici - 1) * shard * 4.0,
                      "dcn": ring(dcn, shard, 1.0)}
        return {"per_fabric": per_fabric, "bottleneck": per_fabric["dcn"]}

    wire_itemsize = {"none": float(itemsize), "bf16": 2.0, "fp16": 2.0,
                     "int8_ring": 1.0, "dcn_int8": 1.0}[fmt]
    if two_level:
        # a flat format's ring may cross hosts at every hop: charge the
        # whole ring to the slow fabric
        n = axis_sizes["ici"] * axis_sizes["dcn"]
        total = ring(n, nelems, wire_itemsize)
        return {"per_fabric": {"dcn": total}, "bottleneck": total}
    n = axis_sizes.get("flat", 1)
    total = ring(n, nelems, wire_itemsize)
    return {"per_fabric": {"flat": total}, "bottleneck": total}


def plan_formats(plan: BucketPlan, policy: Policy, op: ReduceOp,
                 axis_sizes: Optional[Layout] = None,
                 once: bool = False) -> List[str]:
    """The wire format of every bucket of a fusion plan, counted into
    ``stats()`` and into the registry with one ``wire.encode.<fmt>``
    instant a bucket (with ``once``, the registry and the instants only
    the first time this plan and this policy are seen; module
    docstring).  ``axis_sizes`` defaults to the runtime's layout; at one
    rank every bucket is ``none`` (no bytes move, and error feedback would
    compensate an error the wire never made)."""
    from ..utils import metrics as _metrics
    from ..utils.timeline import trace_instant
    sizes = _axis_sizes() if axis_sizes is None else axis_sizes
    total_ranks = math.prod(sizes.values())
    fmts: List[str] = []
    saved_by_bucket: List[float] = []
    for bucket in plan.buckets:
        fmt = resolve_format(policy(bucket.nbytes, bucket.dtype, sizes),
                             bucket.dtype, sizes, op)
        if total_ranks <= 1:
            fmt = "none"
        fmts.append(fmt)
        _BUCKETS[fmt] += 1
        saved = 0.0
        if fmt != "none":
            nelems = sum(bucket.sizes)
            itemsize = bucket.dtype.itemsize
            saved = (modeled_wire_bytes(nelems, itemsize, "none",
                                        sizes)["bottleneck"]
                     - modeled_wire_bytes(nelems, itemsize, fmt,
                                          sizes)["bottleneck"])
            if saved > 0:
                _BYTES_SAVED[fmt] += saved
        saved_by_bucket.append(saved)
    if once:
        key = (tuple((str(b.dtype), tuple(b.indices), tuple(b.sizes))
                     for b in plan.buckets), policy,
               tuple(sorted(sizes.items())), str(op))
        if key in _RECORDED:
            return fmts
        _RECORDED.add(key)
    for i, (bucket, fmt, saved) in enumerate(zip(plan.buckets, fmts,
                                                 saved_by_bucket)):
        _metrics.WIRE_BUCKETS.inc(format=fmt)
        trace_instant("wire", f"wire.encode.{fmt}",
                      args={"bucket": i, "nbytes": int(bucket.nbytes)})
        if saved > 0:
            _metrics.WIRE_BYTES_SAVED.inc(saved, format=fmt)
    return fmts


# ------------------------------------------------------------- sync engine
def wire_sync(leaves: Sequence[torch.Tensor], plan: BucketPlan,
              formats: Sequence[str], op: ReduceOp,
              prescale_factor: float = 1.0, postscale_factor: float = 1.0,
              residuals: Optional[Sequence[torch.Tensor]] = None):
    """Reduce every bucket in its wire format; returns ``(synced,
    new_residuals)``, ``synced`` one tensor per leaf (a view of a bucket
    buffer, or, for a one-leaf ``none`` bucket without residuals, the leaf
    itself, reduced in place).

    With ``residuals`` (error feedback) each residual is added into its
    gradient before packing, and each lossy bucket's one-shot encode error
    comes back as the new residual (zeros for exact buckets); without
    them ``new_residuals`` is None."""
    ef = residuals is not None
    if ef:
        leaves = [l + r.to(l.dtype) for l, r in zip(leaves, residuals)]
        new_res: List[Optional[torch.Tensor]] = [torch.zeros_like(l)
                                                 for l in leaves]
    out: List[Optional[torch.Tensor]] = [None] * plan.num_leaves
    for bucket, fmt in zip(plan.buckets, formats):
        buf = pack_bucket(leaves, bucket)
        if ef and is_lossy(fmt):
            unpack_bucket(local_error(buf, fmt), bucket, new_res)
        buf = reduce_bucket(buf, fmt, op, prescale_factor=prescale_factor,
                            postscale_factor=postscale_factor)
        unpack_bucket(buf, bucket, out)
    return out, (new_res if ef else None)
