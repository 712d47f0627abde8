"""The overlap plane's microbatch pipeline: the port of
``horovod_tpu/ops/overlap.py`` (``make_pipelined_transform`` and the
functions around it).

With ``backward_passes_per_step = k > 1`` the classic path accumulates k
microbatch gradients and syncs their mean once, after the last backward,
fully exposed.  The pipelined path syncs each microbatch's gradients on
its own: the sync of microbatch i runs on the side stream
(``ops/collectives.py`` ``launch``) while microbatch i+1's forward and
backward run on the caller's stream, with at most ``depth`` syncs in
flight.  The last call of the cycle waits for the rest, oldest first, and
applies the inner step to the mean.  Every depth runs the same syncs, in
the same order 0..k-1, on the same values, so every depth, 0 (sync at
once) included, gives the same result: the JAX plane's equivalence.

The JAX package restructures the traced program instead (a ring buffer in
the optax state, ``lax.cond`` and XLA's scheduler).  The byte model is the
same: ``record_overlap`` sets the ``hvd_overlap_exposed_bytes`` and
``hvd_overlap_overlapped_fraction`` gauges of its plane, and
``microbatch_overlap_model`` (run by the optimizer at the first call of a
cycle) emits one ``overlap.sync.issue`` or ``overlap.sync.flush`` instant
a microbatch, once per distinct plan, k and depth, where the JAX package
emits them once per traced program.  ``priority_order`` is the ZeRO
chain's bucket order.
"""

from __future__ import annotations

import collections
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, \
    Tuple

import torch

from . import collectives, wire as _wire
from .fusion import make_plan

# The knob's range; the argument also takes depth 0 (sync at once, the
# sequential schedule every depth is held to).
MAX_OVERLAP_DEPTH = 8


def validate_overlap_knobs(knobs: Mapping[str, Any]) -> None:
    """Fail at init on an invalid HOROVOD_OVERLAP_DEPTH or
    HOROVOD_PREFETCH_DEPTH (``data/loader.py`` ``prefetch``)."""
    depth = int(knobs["HOROVOD_OVERLAP_DEPTH"])
    if not 1 <= depth <= MAX_OVERLAP_DEPTH:
        raise ValueError(
            f"HOROVOD_OVERLAP_DEPTH={depth} invalid; the pipeline depth "
            f"must be in [1, {MAX_OVERLAP_DEPTH}]")
    pre = int(knobs["HOROVOD_PREFETCH_DEPTH"])
    if pre < 1:
        raise ValueError(
            f"HOROVOD_PREFETCH_DEPTH={pre} invalid; the device-prefetch "
            "depth must be >= 1")


def overlap_enabled(overlap: Optional[bool] = None) -> bool:
    """The argument wins; else the HOROVOD_OVERLAP knob, read live, so
    ``HOROVOD_OVERLAP=1`` alone turns the pipeline on for every
    ``backward_passes_per_step > 1`` optimizer built after it."""
    if overlap is not None:
        return bool(overlap)
    from ..common.knobs import current
    return bool(current("HOROVOD_OVERLAP"))


def resolve_depth(depth: Optional[int] = None) -> int:
    """The pipeline depth: the argument, else the runtime's (the knob)."""
    if depth is None:
        from .. import runtime as _rt
        if _rt.is_initialized():
            depth = _rt.get().overlap_depth()
        else:
            from ..common.knobs import current
            depth = int(current("HOROVOD_OVERLAP_DEPTH"))
    depth = int(depth)
    if not 0 <= depth <= MAX_OVERLAP_DEPTH:
        raise ValueError(
            f"overlap depth {depth} out of range [0, {MAX_OVERLAP_DEPTH}]")
    return depth


def priority_order(plan) -> Tuple[int, ...]:
    """Bucket issue order for a bucket-interleaved chain: the plan's
    buckets reversed (the last layers' gradients come first out of the
    backward, and the first layers' parameters are needed first by the
    next forward)."""
    return tuple(reversed(range(len(plan.buckets))))


def record_overlap(total_bytes: float, exposed_bytes: float,
                   plane: str) -> dict:
    """One schedule's modeled split of sync bytes into exposed (no compute
    to hide behind) and overlapped, set on the
    ``hvd_overlap_{exposed_bytes,overlapped_fraction}`` gauges under label
    ``plane``.  A model, not a measurement."""
    from ..utils import metrics as _metrics
    frac = 0.0
    if total_bytes > 0:
        frac = max(0.0, min(1.0, 1.0 - exposed_bytes / total_bytes))
    _metrics.OVERLAP_EXPOSED_BYTES.set(exposed_bytes, plane=plane)
    _metrics.OVERLAP_FRACTION.set(frac, plane=plane)
    return {"total_bytes": total_bytes, "exposed_bytes": exposed_bytes,
            "overlapped_fraction": frac}


# (plan, k, depth) whose schedule instants are already on the timeline
_TRACED: set = set()


def microbatch_overlap_model(leaves: Sequence[torch.Tensor], k: int,
                             depth: int,
                             axis_sizes: Optional[Dict[str, int]] = None
                             ) -> dict:
    """The pipeline's modeled split: each of the k syncs moves the same
    modeled bytes (format ``none``); the ``k - depth`` syncs waited for
    while a later microbatch computes count as overlapped, the final
    flush (and everything at depth 0) as exposed.  ``axis_sizes``
    defaults to the runtime's layout (``ops/wire.py`` ``_axis_sizes``)."""
    from .. import runtime as _rt
    threshold = (_rt.get().fusion_threshold() if _rt.is_initialized()
                 else 128 * 1024 * 1024)
    plan = make_plan([tuple(l.shape) for l in leaves],
                     [l.dtype for l in leaves], threshold)
    sizes = _wire._axis_sizes() if axis_sizes is None else axis_sizes
    per_sync = sum(_wire.modeled_wire_bytes(sum(b.sizes), b.dtype.itemsize,
                                            "none", sizes)["bottleneck"]
                   for b in plan.buckets)
    overlapped = max(0, k - depth) if depth >= 1 else 0
    key = (tuple((str(b.dtype), tuple(b.sizes)) for b in plan.buckets),
           tuple(sorted(sizes.items())), k, depth)
    if key not in _TRACED:
        # one instant a microbatch: where its sync issues, inside a later
        # microbatch's compute (the drain) or in the exposed final flush
        from ..utils.timeline import trace_instant
        _TRACED.add(key)
        for i in range(k):
            drained_in_loop = depth >= 1 and i < k - depth
            trace_instant(
                "overlap",
                "overlap.sync.issue" if drained_in_loop
                else "overlap.sync.flush",
                args={"microbatch": i,
                      "issued_at_call": (i + depth if drained_in_loop
                                         else k - 1),
                      "depth": depth})
    return record_overlap(k * per_sync, (k - overlapped) * per_sync,
                          plane="microbatch")


Grads = List[torch.Tensor]


class MicrobatchPipeline:
    """The pipelined ``backward_passes_per_step = k`` sync: call it once
    per microbatch, after its backward, with the gradients (the caller's
    ``.grad`` tensors); see :func:`make_pipelined_transform`."""

    def __init__(self, sync_fn: Callable[[Grads], Grads],
                 apply_fn: Callable[[Grads], Any], k: int, depth: int,
                 on_cycle: Optional[Callable] = None):
        if k < 2:
            raise ValueError("the microbatch pipeline needs "
                             f"backward_passes_per_step >= 2 (got {k})")
        self.sync_fn, self.apply_fn = sync_fn, apply_fn
        self.k = k
        self.depth = min(int(depth), k - 1)  # k or more never drains early
        self.on_cycle = on_cycle
        self.calls = 0
        self._inflight: "collections.deque" = collections.deque()
        self._sum: Optional[Grads] = None

    def _drain_oldest(self) -> None:
        synced = collectives.wait_for(*self._inflight.popleft())
        if self._sum is None:
            self._sum = [torch.zeros_like(s) for s in synced]
        for acc, s in zip(self._sum, synced):
            acc.add_(s)

    def __call__(self, grads: Sequence[torch.Tensor]) -> Any:
        pos = self.calls % self.k
        if pos == 0 and self.on_cycle is not None:
            self.on_cycle(grads, self.k, self.depth)
        # the next backward writes into the same buffers while the side
        # stream may still be reading: the sync reads a copy
        copies = [g.detach().clone() for g in grads]
        device = copies[0].device
        self._inflight.append(collectives.launch(
            lambda: self.sync_fn(copies), copies, device) + (device,))
        self.calls += 1
        final = pos == self.k - 1
        while len(self._inflight) > (0 if final else self.depth):
            self._drain_oldest()
        if not final:
            return None
        mean = [s.div_(self.k) for s in self._sum]
        self._sum = None
        return self.apply_fn(mean)


def make_pipelined_transform(sync_fn: Callable[[Grads], Grads],
                             apply_fn: Callable[[Grads], Any], k: int,
                             depth: int, on_cycle: Optional[Callable] = None
                             ) -> MicrobatchPipeline:
    """Build the pipelined ``backward_passes_per_step = k`` sync.

    ``sync_fn(grads) -> synced`` runs one microbatch's fused sync (the
    optimizer threads its error-feedback residuals through it);
    ``apply_fn(mean)`` runs the inner optimizer.  Call i copies the
    gradients, starts the copy's sync on the side stream, and while more
    than ``depth`` syncs are in flight waits for the oldest and adds it
    into the running sum, in call order.  The k-th call waits for the
    rest, oldest first, returns ``apply_fn(sum / k)`` and starts a new
    cycle; the other calls return None.  The side stream is the device's
    of the gradients; on the CPU each sync has finished when ``launch``
    returns.  ``on_cycle(grads, k, depth)`` runs at the
    first call of each cycle."""
    return MicrobatchPipeline(sync_fn, apply_fn, k, depth, on_cycle)
