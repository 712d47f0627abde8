"""ZeRO weight-update sharding for the data-parallel path, levels 1-3: the
port of ``horovod_tpu/parallel/zero.py``.

In plain data parallelism every rank holds the full parameters, gradients
and optimizer state and applies the same update.  Sharding along the
fusion-bucket plan removes the redundancy one entity at a time
(``zero_level``):

  level 1   optimizer state sharded 1/n: per bucket the gradients are
            reduce-scattered to 1/n, the update runs on the shard, and the
            updated shard is all-gathered onto the replicated parameters;
  level 2   + gradient shards: with ``backward_passes_per_step = k > 1``
            the microbatches accumulate on the 1/n shard (level 1 gathers
            each microbatch's shard back into a full accumulator);
  level 3   + parameter shards: between steps the parameters live only as
            per-bucket fp32 shards (1/n per rank); the step all-gathers
            them bucket by bucket at its start, in plan order, with
            ``ag_prefetch`` gathers in flight, and frees the module's
            parameter storage again at its end.  The update applies to the
            resident shard.

The gradient leg of each bucket and microbatch, in ``priority_order``
(the plan reversed: the backward produces the last buckets' gradients
first): pack, padded to a multiple of n, in fp32; add the error-feedback
residual; the one-shot ``wire_roundtrip`` of the bucket's wire format
(``ops/wire.py``), whose error ``x - C(x)`` becomes the next residual;
``reduce_scatter_tensor``; divide by n.  The legs start during the
backward: a hook on each parameter (``register_post_accumulate_grad_hook``)
marks its gradient done, and each bucket is packed, its gradients freed
(``.grad = None``) and its reduce-scatter issued as soon as it and every
bucket before it in ``priority_order`` are done, so the issue order and
the values are those of the JAX chain.  The all-gather legs are exact.

In the torch idiom: the state (``init_zero_state``) holds one flat fp32
shard tensor per bucket and the inner optimizer, a torch optimizer class
built over those shards with its keyword arguments; the step
(``make_zero_train_step``) is ``step(*batch) -> loss`` on an
``nn.Module``, with ``batch`` this rank's rows.  At level 3 the shards are
the parameters themselves (the module is the template, so there is no
``params_template`` argument); ``gather_zero3_params`` reassembles them.
Numerics: with fp32 parameters the three levels compute the same values.
With bf16 parameters, levels 1 and 2 apply the fp32 update to the bf16
parameters and round to bf16, while level 3 keeps fp32 master shards and
casts the gathered parameters to bf16, as the JAX chain does.

The chain runs over the default process group, or over ``group``: the
3D layout plane (``parallel/layout.py``) seats it on each rank's dp
subgroup, so every (tp, pp) coordinate shards its own parameter slice over
its own dp peers, and passes a gradient ``fixup`` that runs on each leaf's
gradient just before its bucket is packed (the embedding's all-reduce over
the pipeline stages).

Where the port differs: the inner optimizer updates its shard in place,
so levels 1 and 2 all-gather the updated parameter shard, not the update
(the same bytes); and the level-3 prefetch depth resolves from the
argument, then the runtime (the knob, or the autotuner's depth arm).

The measurement plane's hooks: building a step (the port's counterpart of
the JAX chain's trace) sets the ``hvd_zero_level``,
``hvd_zero_ag_prefetch`` and ``hvd_zero_sharded_bytes{kind}`` gauges,
the ``hvd_overlap_*{plane="zeroN"}`` split priced by
``perf/costmodel.py`` ``zero_comm_bytes``, and emits the
``zero.bucket.{ag,rs,free}`` instants of the schedule
(:func:`_record_zero_trace`).  The ``opt_state`` kind is set after the
first step: a torch optimizer makes its state at its first ``step``,
where the JAX chain traces an initialized optax state.
"""

from __future__ import annotations

import collections
import weakref
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .. import runtime as _rt
from ..common.reduce_op import Average, ReduceOp
from ..ops import wire as _wire
from ..ops.fusion import Bucket, BucketPlan, make_plan, pack_bucket_padded
from ..ops.overlap import MAX_OVERLAP_DEPTH, priority_order
from .data_parallel import _compute_cast

ZERO_LEVELS = (1, 2, 3)
DEFAULT_FUSION_BYTES = 128 * 1024 * 1024
# reduce-scatter legs in flight before the oldest is waited for: each holds
# its packed bucket until its collective has finished
RS_INFLIGHT = 2


# ------------------------------------------------------------ knob surface
def validate_zero_knobs(knobs) -> None:
    """Fail at init on invalid ZeRO knob values (``runtime.init``)."""
    lvl = int(knobs["HOROVOD_ZERO_LEVEL"])
    if lvl not in (0,) + ZERO_LEVELS:
        raise ValueError(
            f"HOROVOD_ZERO_LEVEL={lvl} invalid; the weight-update "
            "sharding level must be 0 (off), 1, 2 or 3")
    pre = int(knobs["HOROVOD_ZERO_AG_PREFETCH"])
    if not 1 <= pre <= MAX_OVERLAP_DEPTH:
        raise ValueError(
            f"HOROVOD_ZERO_AG_PREFETCH={pre} invalid; the ZeRO-3 param "
            f"all-gather prefetch depth must be in [1, {MAX_OVERLAP_DEPTH}]")


def resolve_zero_level(level: Optional[int] = None) -> int:
    """The ZeRO level: the argument, else the HOROVOD_ZERO_LEVEL knob
    (read live).  0 = off (plain data parallelism)."""
    if level is None:
        from ..common.knobs import current
        level = int(current("HOROVOD_ZERO_LEVEL"))
    level = int(level)
    if level not in (0,) + ZERO_LEVELS:
        raise ValueError(f"zero level {level} invalid; must be 0, 1, 2 or 3 "
                         "(HOROVOD_ZERO_LEVEL)")
    return level


def resolve_ag_prefetch(depth: Optional[int] = None) -> int:
    """The ZeRO-3 parameter all-gather prefetch depth: the argument, else
    the runtime's (the HOROVOD_ZERO_AG_PREFETCH knob read live, refined to
    the autotuner's depth arm while it tunes), else the knob."""
    if depth is None:
        from .. import runtime as _rt
        if _rt.is_initialized():
            depth = _rt.get().zero_ag_prefetch()
        else:
            from ..common.knobs import current
            depth = int(current("HOROVOD_ZERO_AG_PREFETCH"))
    depth = int(depth)
    if not 1 <= depth <= MAX_OVERLAP_DEPTH:
        raise ValueError(f"zero AG prefetch depth {depth} out of range "
                         f"[1, {MAX_OVERLAP_DEPTH}]")
    return depth


def _resolve_wire_policy(wire_policy):
    """The argument > the runtime's live policy > the knob, as the
    data-parallel path resolves it."""
    if wire_policy is not None:
        if callable(wire_policy):
            return wire_policy
        return _wire.validate_policy_name(wire_policy)
    if _rt.is_initialized():
        return _rt.get().wire_policy()
    from ..common.knobs import current
    return _wire.validate_policy_name(current("HOROVOD_WIRE_POLICY"))


def _resolve_ef(error_feedback: Optional[bool]) -> bool:
    """Error feedback: the argument > the HOROVOD_WIRE_EF knob."""
    if error_feedback is not None:
        return bool(error_feedback)
    from ..common.knobs import current
    return bool(current("HOROVOD_WIRE_EF"))


# --------------------------------------------------------------- internals
def _group_geometry(group) -> Tuple[int, int]:
    """(this rank, ranks) of ``group`` (None: the default group)."""
    if not dist.is_initialized():
        raise RuntimeError("the zero chain needs a process group; call "
                           "hvd.init() first")
    return dist.get_rank(group), dist.get_world_size(group)


def _leaves(params: Any) -> List[torch.Tensor]:
    """The parameter tensors of a module (``parameters()`` order) or of a
    sequence of tensors."""
    if isinstance(params, torch.nn.Module):
        return list(params.parameters())
    return list(params)


def _bucket_plan(leaves: Sequence[torch.Tensor], threshold_bytes: Any
                 ) -> BucketPlan:
    """The fusion-bucket plan over the parameter leaves, sized in fp32 (the
    update math is fp32 whatever the storage dtype), through the runtime's
    plan cache when it is initialized."""
    shapes = [tuple(t.shape) for t in leaves]
    dtypes = [torch.float32] * len(leaves)
    if threshold_bytes is None:
        threshold_bytes = (_rt.get().fusion_threshold() if _rt.is_initialized()
                           else DEFAULT_FUSION_BYTES)
    if _rt.is_initialized():
        return _rt.get().plan_cache.get(shapes, dtypes, threshold_bytes)
    return make_plan(shapes, dtypes, threshold_bytes)


def _monolithic_plan(leaves: Sequence[torch.Tensor]) -> BucketPlan:
    """The legacy level-1 chain's layout: one bucket holding every leaf
    (one flat vector)."""
    b = Bucket(torch.float32)
    for i, t in enumerate(leaves):
        b.add(i, tuple(t.shape), t.numel() * 4)
    return BucketPlan([b], len(leaves))


def _pack_padded(leaves: Sequence[torch.Tensor], bucket: Bucket,
                 n: int) -> torch.Tensor:
    """One bucket's leaves as a new flat fp32 vector padded to a multiple of
    the rank count."""
    return pack_bucket_padded(leaves, bucket, n, dtype=torch.float32)


def _padded_len(nelems: int, n: int) -> int:
    return -(-nelems // n) * n


@torch.no_grad()
def _pack_shard(leaves: Sequence[torch.Tensor], bucket: Bucket, n: int,
                rank: int, out: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
    """``_pack_padded(leaves, bucket, n)[rank * L/n:(rank + 1) * L/n]``,
    written into ``out`` (a new fp32 tensor when None) without packing the
    rest of the bucket."""
    shard_len = _padded_len(sum(bucket.sizes), n) // n
    lo, hi = rank * shard_len, (rank + 1) * shard_len
    if out is None:
        out = torch.empty(shard_len, dtype=torch.float32,
                          device=leaves[bucket.indices[0]].device)
    out.zero_()
    off = 0
    for i, size in zip(bucket.indices, bucket.sizes):
        a, b = max(off, lo), min(off + size, hi)
        if a < b:
            out[a - lo:b - lo].copy_(leaves[i].reshape(-1)[a - off:b - off])
        off += size
    return out


@torch.no_grad()
def _unpack_into(flat: torch.Tensor, bucket: Bucket,
                 leaves: Sequence[torch.Tensor]) -> None:
    """Copy a bucket's flat buffer (padded or not) into its leaves, cast
    to each leaf's dtype, restoring a leaf's freed storage first."""
    off = 0
    for i, size in zip(bucket.indices, bucket.sizes):
        t = leaves[i]
        storage = t.untyped_storage()
        nbytes = t.numel() * t.element_size()
        if storage.size() < nbytes:
            storage.resize_(nbytes)
        t.detach().copy_(flat[off:off + size].view(t.shape))
        off += size


def _release(leaves: Sequence[torch.Tensor]) -> None:
    """Free the storage of parameters that live as level-3 shards between
    steps (the shape and dtype stay; ``_unpack_into`` restores it)."""
    for t in leaves:
        if not t.untyped_storage().resizable():  # e.g. shared with numpy
            t.data = torch.empty_like(t)
        t.untyped_storage().resize_(0)


def _zero_formats(plan: BucketPlan, policy, n: int) -> List[str]:
    """Per-bucket wire formats of the reduce-scatter legs, with the rank
    count given explicitly, so the state's init and the step resolve the
    same formats and agree on the EF layout."""
    return _wire.plan_formats(plan, _wire.get_policy(policy),
                              ReduceOp.AVERAGE, axis_sizes={"flat": n})


Layout = Tuple[Tuple[int, Optional[int]], ...]


def _expected_state(plan: BucketPlan, n: int, ef: bool) -> Layout:
    """The layout the step expects: per bucket (shard length, residual
    length or None)."""
    out = []
    for b in plan.buckets:
        L = _padded_len(sum(b.sizes), n)
        out.append((L // n, L if ef else None))
    return tuple(out)


def _check_state_layout(state: "ZeroState", expected: Layout,
                        what: str) -> None:
    """Check the state a step is handed against the layout it was built
    for, so a state made ``interleaved=True`` consumed by a monolithic step
    (or the converse, or an EF state meeting a step without EF, or a stale
    world size) raises instead of mis-slicing."""
    got = state.layout()
    if got != expected:
        raise ValueError(
            f"zero opt_state layout mismatch for the {what} step: the "
            "`interleaved`, `zero_level`, wire/EF settings and world size "
            "of init_sharded_opt_state/init_zero_state and the step builder "
            "must match; e.g. state inited with interleaved=True must not "
            "be consumed by a monolithic (interleaved=False) step builder.  "
            f"Expected (shard, residual) lengths {list(expected)}; got "
            f"{list(got)}")


class ZeroState:
    """The sharded state of the zero chain on this rank: per bucket a flat
    fp32 shard (the inner optimizer's parameter; at level 3 the resident
    parameters), the inner optimizer built over the shards, and, with
    error feedback, each bucket's residual (this rank's encode error, the
    bucket's full padded length)."""

    def __init__(self, shards: List[torch.Tensor],
                 optimizer: torch.optim.Optimizer,
                 residuals: Optional[List[torch.Tensor]]):
        self.shards = shards
        self.optimizer = optimizer
        self.residuals = residuals

    def layout(self) -> Layout:
        res = self.residuals or [None] * len(self.shards)
        return tuple((s.numel(), None if r is None else r.numel())
                     for s, r in zip(self.shards, res))


# ----------------------------------------------------- build-time recording
def _record_zero_trace(plan: BucketPlan, order, formats, level: int, n: int,
                       k: int, depth: int, ef: bool,
                       param_bytes_full: int) -> None:
    """The measurement plane's view of one built chain (module docstring):
    the ZeRO gauges, the ``zeroN`` overlap split (the first- and
    last-issued buckets' bytes exposed at the pipeline's ends, the rest
    under an in-flight neighbour), and the schedule's instants."""
    from ..ops.overlap import record_overlap
    from ..perf import costmodel as _cm
    from ..utils import metrics as M
    from ..utils.timeline import trace_instant

    padded = [_padded_len(sum(b.sizes), n) for b in plan.buckets]
    per_bucket = [
        _cm.zero_comm_bytes(L, n, level, k=k,
                            wire_format=formats[bi])["total_bytes"]
        for bi, L in enumerate(padded)]
    total = float(sum(per_bucket))
    exposed = (total if len(plan.buckets) <= 1 else
               0.5 * (per_bucket[order[0]] + per_bucket[order[-1]]))
    record_overlap(total, exposed, plane=f"zero{level}")

    elems = sum(padded)
    M.ZERO_LEVEL.set(level)
    M.ZERO_AG_PREFETCH.set(depth if level == 3 else 0)
    M.ZERO_SHARDED_BYTES.set(
        param_bytes_full // n if level == 3 else param_bytes_full,
        kind="params")
    M.ZERO_SHARDED_BYTES.set(
        elems * 4 // n if level >= 2 else elems * 4, kind="grads")
    M.ZERO_SHARDED_BYTES.set(elems * 4 if ef else 0, kind="ef_residual")

    if level == 3:
        for j in range(len(plan.buckets)):  # plan order
            trace_instant("zero", "zero.bucket.ag",
                          args={"bucket": j, "position": j,
                                "level": level, "prefetch": depth,
                                "nbytes": int(padded[j]) * 4})
            trace_instant("zero", "zero.bucket.free",
                          args={"bucket": j, "level": level,
                                "nbytes": int(padded[j]) * 4})
    for j, bi in enumerate(order):
        trace_instant("zero", "zero.bucket.rs",
                      args={"bucket": int(bi), "position": j,
                            "level": level, "format": formats[bi],
                            "k": k, "nbytes": int(padded[bi]) * 4})


def _opt_state_bytes(optimizer: torch.optim.Optimizer) -> int:
    """Bytes of the tensors in this rank's optimizer state."""
    return sum(v.numel() * v.element_size()
               for st in optimizer.state.values() for v in st.values()
               if isinstance(v, torch.Tensor))


# ----------------------------------------------------------------- init API
def init_sharded_opt_state(optimizer: type, params: Any,
                           interleaved: bool = False,
                           fusion_threshold_bytes: Any = None,
                           zero_level: int = 1,
                           wire_policy=None,
                           error_feedback: Optional[bool] = None,
                           group=None,
                           **optimizer_kwargs) -> ZeroState:
    """The inner optimizer over this rank's flat fp32 shards:
    ``optimizer(shards, **optimizer_kwargs)``, so each rank holds state for
    1/n of the parameters.

    ``interleaved=True`` gives one shard per fusion bucket (plan order) and
    must pair with a step built ``interleaved=True`` (the layouts differ,
    and the steps check the state they are handed).  Levels 1-3 share the
    layout; at levels 1 and 2 the step refreshes the shards from the
    replicated parameters, at level 3 they are the parameters (what
    :func:`shard_zero3_params` makes).  With error feedback on a lossy wire
    format each bucket also keeps its residual.  ``group`` is the process
    group the chain shards over (None: the default group)."""
    level = resolve_zero_level(zero_level)
    if level == 0:
        raise ValueError(
            "zero_level=0 is plain data parallelism: build the inner "
            "optimizer directly")
    if level >= 2 and not interleaved:
        raise ValueError(
            f"zero_level={level} is bucket-interleaved by construction; "
            "pass interleaved=True")
    rank, n = _group_geometry(group)
    leaves = _leaves(params)
    ef = False
    if interleaved:
        plan = _bucket_plan(leaves, fusion_threshold_bytes)
        formats = _zero_formats(plan, _resolve_wire_policy(wire_policy), n)
        ef = _resolve_ef(error_feedback) and any(
            _wire.is_lossy(f) for f in formats)
    else:
        if wire_policy is not None and wire_policy != "none":
            raise ValueError(
                "the monolithic zero chain carries no wire formats; use "
                "interleaved=True for per-bucket wire policies")
        plan = _monolithic_plan(leaves)
    shards = [_pack_shard(leaves, b, n, rank) for b in plan.buckets]
    residuals = None
    if ef:
        residuals = [torch.zeros(_padded_len(sum(b.sizes), n),
                                 dtype=torch.float32, device=s.device)
                     for b, s in zip(plan.buckets, shards)]
    return ZeroState(shards, optimizer(shards, **optimizer_kwargs), residuals)


def init_zero_state(optimizer: type, params: Any,
                    zero_level: Optional[int] = None, wire_policy=None,
                    error_feedback: Optional[bool] = None,
                    fusion_threshold_bytes: Any = None, group=None,
                    **optimizer_kwargs) -> ZeroState:
    """:func:`init_sharded_opt_state` with the level from the knob when not
    given and the bucket-interleaved layout (the chain's construction)."""
    return init_sharded_opt_state(
        optimizer, params, interleaved=True,
        fusion_threshold_bytes=fusion_threshold_bytes,
        zero_level=resolve_zero_level(zero_level), wire_policy=wire_policy,
        error_feedback=error_feedback, group=group, **optimizer_kwargs)


# ------------------------------------------------------- level-3 param API
def shard_zero3_params(params: Any, fusion_threshold_bytes: Any = None,
                       group=None) -> List[torch.Tensor]:
    """The level-3 resident layout of a replicated model: one flat fp32
    shard per fusion bucket, this rank's 1/n of the bucket padded to a
    multiple of n.  The geometry is a function of (plan, n) only, so a new
    world size re-derives it by gather, then shard on the new group."""
    rank, n = _group_geometry(group)
    leaves = _leaves(params)
    plan = _bucket_plan(leaves, fusion_threshold_bytes)
    return [_pack_shard(leaves, b, n, rank) for b in plan.buckets]


def gather_zero3_params(pshards: Sequence[torch.Tensor],
                        params_template: Any,
                        fusion_threshold_bytes: Any = None,
                        group=None) -> List[torch.Tensor]:
    """The full parameters, in the template's order, shapes and dtypes,
    reassembled from the level-3 shards of every rank (for evaluation,
    checkpoints and resharding).  ``params_template`` is the module or its
    tensors; their storage may be freed."""
    _, n = _group_geometry(group)
    tleaves = _leaves(params_template)
    plan = _bucket_plan(tleaves, fusion_threshold_bytes)
    out: List[torch.Tensor] = [
        torch.empty(t.shape, dtype=t.dtype, device=pshards[0].device)
        for t in tleaves]
    for shard, b in zip(pshards, plan.buckets):
        full = torch.empty(shard.numel() * n, dtype=shard.dtype,
                           device=shard.device)
        dist.all_gather_into_tensor(full, shard.contiguous(), group=group)
        _unpack_into(full, b, out)
    return out


def _gather_buckets(nb: int, depth: int,
                    ag: Callable[[int], Tuple[Any, torch.Tensor]],
                    unpack: Callable[[int, torch.Tensor], None]) -> None:
    """The level-3 step start: all-gather every bucket in plan order with
    ``depth`` gathers issued ahead of the one being unpacked.  ``ag(j)``
    issues bucket j's gather and returns ``(handle, buffer)``; bucket j is
    unpacked only after its handle's ``wait()``, and its buffer is dropped
    before the next bucket's wait."""
    pending: Dict[int, Tuple[Any, torch.Tensor]] = {
        j: ag(j) for j in range(min(depth, nb))}
    for j in range(nb):
        if j + depth < nb:
            pending[j + depth] = ag(j + depth)
        handle, buf = pending.pop(j)
        handle.wait()
        unpack(j, buf)
        del handle, buf


# ------------------------------------------------------------- step builders
def make_zero_train_step(model: torch.nn.Module,
                         loss_fn: Callable[..., torch.Tensor],
                         state: ZeroState,
                         op: ReduceOp = Average,
                         zero_level: Optional[int] = None,
                         interleaved: Optional[bool] = None,
                         wire_policy=None,
                         error_feedback: Optional[bool] = None,
                         backward_passes_per_step: int = 1,
                         ag_prefetch: Optional[int] = None,
                         fusion_threshold_bytes: Any = None,
                         compute_dtype: Optional[torch.dtype] = None,
                         group=None,
                         fixup: Optional[Callable[[int, torch.Tensor],
                                                  torch.Tensor]] = None
                         ) -> Callable:
    """Build the ZeRO train step ``step(*batch) -> loss`` for ``zero_level``
    (module docstring).

    ``loss_fn(model, *local_batch)`` returns this rank's scalar loss;
    ``batch`` holds this rank's rows (moved to the runtime's device), with
    a leading ``k`` axis when ``backward_passes_per_step = k > 1``: every
    microbatch is synced, and the step returns the mean over the
    microbatches of the rank-mean loss.  ``state`` comes from
    :func:`init_zero_state` (or :func:`init_sharded_opt_state`) made with
    the same level, wire and EF settings; the step checks its layout.
    ``compute_dtype`` runs the loss on a copy of the parameters cast to it
    (fp32 master weights, bf16 compute).  At level 3 the module's
    parameter storage is freed here and between steps.  ``group`` is the
    process group the chain shards over and averages the loss over (None:
    the default group; the state must be made on the same group).
    ``fixup(i, grad) -> grad`` rewrites the gradient of the module's i-th
    parameter (``parameters()`` order) before its bucket is packed, on
    every microbatch; a parameter the backward left without a gradient
    comes to it as zeros."""
    level = resolve_zero_level(zero_level)
    if level == 0:
        raise ValueError(
            "zero_level=0 is plain data parallelism: use "
            "parallel.data_parallel.make_train_step")
    if op != Average:
        raise ValueError("zero update sharding reduces with Average "
                         "(gradient mean); prescale for other semantics")
    if level >= 2 and interleaved is False:
        raise ValueError(
            f"zero_level={level} is bucket-interleaved by construction (the "
            "gradient/param shards are per-fusion-bucket slices); "
            "interleaved=False exists only for the legacy level-1 "
            "monolithic chain")
    k = int(backward_passes_per_step)
    if k < 1:
        raise ValueError("backward_passes_per_step must be >= 1")
    rank, n = _group_geometry(group)
    leaves = _leaves(model)
    if interleaved is False:
        if k != 1:
            raise ValueError(
                "the monolithic zero chain takes one batch per step "
                "(backward_passes_per_step=1); microbatched steps ride the "
                "bucket-interleaved chain (interleaved=True)")
        if wire_policy is not None and wire_policy != "none":
            raise ValueError(
                "the monolithic zero chain carries no wire formats; use "
                "interleaved=True for per-bucket wire policies")
        if error_feedback:
            raise ValueError(
                "error feedback needs a lossy wire format, which the "
                "monolithic zero chain does not carry")
        plan = _monolithic_plan(leaves)
        formats, ef, what = ["none"], False, "monolithic"
    else:
        plan = _bucket_plan(leaves, fusion_threshold_bytes)
        formats = _zero_formats(plan, _resolve_wire_policy(wire_policy), n)
        ef = _resolve_ef(error_feedback) and any(
            _wire.is_lossy(f) for f in formats)
        what = f"bucket-interleaved level-{level}"
    expected = _expected_state(plan, n, ef)
    order = priority_order(plan)
    depth = resolve_ag_prefetch(ag_prefetch) if level == 3 else 0
    device = _rt.resolve_device()
    fn = _compute_cast(model, loss_fn, compute_dtype)
    chain = _GradientLegs(leaves, plan, order, formats, ef, level, k, n,
                          group, fixup)
    _record_zero_trace(plan, order, formats, level, n, k, depth, ef,
                       sum(p.numel() * p.element_size() for p in leaves))
    recorded_state = [False]
    if level == 3:
        _release(leaves)

    def gather_params() -> None:
        def ag(j):
            shard = state.shards[j]
            buf = torch.empty(shard.numel() * n, dtype=torch.float32,
                              device=shard.device)
            return dist.all_gather_into_tensor(buf, shard, group=group,
                                               async_op=True), buf
        _gather_buckets(len(plan.buckets), depth, ag,
                        lambda j, buf: _unpack_into(buf, plan.buckets[j],
                                                    leaves))

    def step(*batch: torch.Tensor) -> torch.Tensor:
        _check_state_layout(state, expected, what)
        if k > 1 and any(b.shape[0] != k for b in batch):
            raise ValueError(f"batch has {batch[0].shape[0]} microbatches, "
                             f"backward_passes_per_step is {k}")
        with torch.no_grad():
            if level == 3:
                gather_params()
            else:  # the update shards from the replicated parameters
                for s, b in zip(state.shards, plan.buckets):
                    _pack_shard(leaves, b, n, rank, out=s)
        mbs = [batch] if k == 1 else [tuple(b[i] for b in batch)
                                      for i in range(k)]
        losses = []
        for mb in mbs:
            loss = fn(*(b.to(device, non_blocking=True) for b in mb))
            chain.begin(state.residuals)
            loss.backward()
            chain.finish()
            losses.append(loss.detach().float())
        with torch.no_grad():
            if level == 3:  # the update needs only the shards
                _release(leaves)
            for bi in order:
                acc, chain.acc[bi] = chain.acc[bi], None
                if level == 1 and k > 1:
                    sl = acc.numel() // n
                    acc = acc[rank * sl:(rank + 1) * sl]
                state.shards[bi].grad = acc.div_(k) if k > 1 else acc
                del acc
            state.optimizer.step()
            if not recorded_state[0]:
                from ..utils import metrics as M
                M.ZERO_SHARDED_BYTES.set(_opt_state_bytes(state.optimizer),
                                         kind="opt_state")
                recorded_state[0] = True
            for s in state.shards:
                s.grad = None
            if level != 3:  # the updated shards onto the replicated parameters
                for bi in order:
                    s = state.shards[bi]
                    full = torch.empty(s.numel() * n, dtype=s.dtype,
                                       device=s.device)
                    dist.all_gather_into_tensor(full, s, group=group)
                    _unpack_into(full, plan.buckets[bi], leaves)
                    del full
            # one reduction after the last microbatch: a collective on the
            # caller's stream between microbatches would queue behind the
            # reduce-scatters in flight
            mean = torch.stack(losses)
            if n > 1:
                dist.all_reduce(mean, group=group)
                mean = mean / n
            return mean.mean()

    return step


def make_zero1_train_step(model: torch.nn.Module,
                          loss_fn: Callable[..., torch.Tensor],
                          state: ZeroState, op: ReduceOp = Average,
                          interleaved: bool = False,
                          fusion_threshold_bytes: Any = None,
                          compute_dtype: Optional[torch.dtype] = None
                          ) -> Callable:
    """Level 1, monolithic by default (one flat vector), bucket-interleaved
    with ``interleaved=True``.  New code uses :func:`make_zero_train_step`."""
    return make_zero_train_step(
        model, loss_fn, state, op=op, zero_level=1,
        interleaved=bool(interleaved),
        fusion_threshold_bytes=fusion_threshold_bytes,
        compute_dtype=compute_dtype)


class _GradientLegs:
    """One microbatch's gradient legs, started from the backward's
    gradient hooks in ``priority_order`` (module docstring) and
    accumulated into ``acc``: per bucket the 1/n shard, or at level 1 with
    k > 1 the full bucket (each shard gathered back)."""

    def __init__(self, leaves, plan: BucketPlan, order, formats, ef: bool,
                 level: int, k: int, n: int, group=None, fixup=None):
        self.leaves, self.plan, self.order = leaves, plan, order
        self.formats, self.ef = formats, ef
        self.gather_back = level == 1 and k > 1
        self.n, self.group, self.fixup = n, group, fixup
        self.acc: List[Optional[torch.Tensor]] = [None] * len(plan.buckets)
        self.armed = False
        self.bucket_of = {}
        for bi, b in enumerate(plan.buckets):
            for i in b.indices:
                self.bucket_of[i] = bi
        # the hooks live on the parameters, where Python's collector does
        # not see them: a strong reference back would keep this object,
        # and through it the parameters, alive for good
        me = weakref.ref(self)

        def hook(i):
            def on_grad(_t):
                legs = me()
                if legs is not None:
                    legs._on_grad(i)
            return on_grad
        for i, t in enumerate(leaves):
            if t.requires_grad:
                t.register_post_accumulate_grad_hook(hook(i))

    def begin(self, residuals: Optional[List[torch.Tensor]]) -> None:
        self.residuals = residuals
        self.missing = [len(b.indices) for b in self.plan.buckets]
        self.next = 0
        self.inflight: "collections.deque" = collections.deque()
        self.armed = True

    def _on_grad(self, i: int) -> None:
        if not self.armed:
            return
        self.missing[self.bucket_of[i]] -= 1
        while (self.next < len(self.order)
               and self.missing[self.order[self.next]] == 0):
            self._issue(self.order[self.next])
            self.next += 1

    def finish(self) -> None:
        """After the backward: issue what is left (a parameter without a
        gradient counts as zeros), then wait for every leg."""
        while self.next < len(self.order):
            self._issue(self.order[self.next])
            self.next += 1
        while self.inflight:
            self._drain()
        self.armed = False
        if any(t.grad is not None for t in self.leaves):
            raise RuntimeError(
                "a parameter's gradient was accumulated after its bucket "
                "was reduced (one backward must accumulate each gradient "
                "once; use non-reentrant checkpointing)")

    @torch.no_grad()
    def _issue(self, bi: int) -> None:
        b, fmt = self.plan.buckets[bi], self.formats[bi]
        grads: List[Optional[torch.Tensor]] = [None] * len(self.leaves)
        for i in b.indices:
            t = self.leaves[i]
            grads[i] = t.grad if t.grad is not None else torch.zeros_like(t)
            t.grad = None
            if self.fixup is not None:
                grads[i] = self.fixup(i, grads[i])
        flat = _pack_padded(grads, b, self.n)
        del grads
        if self.ef:
            flat = flat + self.residuals[bi]
        enc = _wire.wire_roundtrip(flat, fmt)
        if self.ef and _wire.is_lossy(fmt):
            self.residuals[bi].copy_(flat - enc)
        del flat
        shard = torch.empty(enc.numel() // self.n, dtype=torch.float32,
                            device=enc.device)
        work = dist.reduce_scatter_tensor(shard, enc, group=self.group,
                                          async_op=True)
        self.inflight.append((work, shard, enc, bi))
        while len(self.inflight) > RS_INFLIGHT:
            self._drain()

    @torch.no_grad()
    def _drain(self) -> None:
        work, shard, enc, bi = self.inflight.popleft()
        work.wait()
        del enc
        contrib = shard.div_(self.n)
        if self.gather_back:
            full = torch.empty(contrib.numel() * self.n, dtype=torch.float32,
                               device=contrib.device)
            dist.all_gather_into_tensor(full, contrib, group=self.group)
            contrib = full
        acc = self.acc[bi]
        self.acc[bi] = contrib if acc is None else acc.add_(contrib)

