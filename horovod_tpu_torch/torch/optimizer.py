"""The hook-driven ``DistributedOptimizer`` of the eager torch API: the port
of ``horovod_tpu/torch/optimizer.py`` (``_HookReducingOptimizer``,
``DistributedOptimizer``; the reference's ``horovod.torch`` optimizer).

A post-accumulate-grad hook on every parameter fires as the backward
produces its gradient.  Gradients are grouped into buckets (by
``bucket_bytes``, default ``HOROVOD_FUSION_THRESHOLD``, in the canonical
parameter order, so every rank forms the same buckets; or by ``num_groups``
/ ``groups``), and the hook that completes a bucket submits one grouped
allreduce for it, in place on the ``.grad`` tensors.  So each bucket's
allreduce starts during the backward, while later layers' gradients are
still being computed; ``step()`` (or ``synchronize()``) waits for the rest.
``bucket_bytes=0`` allreduces each parameter on its own.

``backward_passes_per_step = n`` lets gradients accumulate locally (in
``.grad``, summed) over n backward passes before the allreduce.
``gradient_predivide_factor = f`` scales gradients by 1/f before the sum
and by f after it (the reference Horovod's split of the average).

``op=Adasum`` returns the delta optimizer instead
(``_AdasumDeltaOptimizer``): no hooks; each step's local update is
Adasum-combined across ranks.
"""

from __future__ import annotations

import warnings
import weakref
from contextlib import contextmanager
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from .. import runtime as _rt
from ..common.knobs import KNOBS
from ..common.reduce_op import Adasum, Average, ReduceOp
from . import mpi_ops
from .compression import Compression


class _HookReducingOptimizer(torch.optim.Optimizer):
    """Methods merged into a subclass of the wrapped optimizer's class: the
    gradients are reduced across ranks before every ``step``."""

    _hvd_wrapper = True

    def __init__(self, params, named_parameters=None,
                 compression=Compression.none,
                 backward_passes_per_step: int = 1,
                 op: ReduceOp = Average,
                 gradient_predivide_factor: float = 1.0,
                 num_groups: int = 0,
                 groups: Optional[Sequence[Sequence[torch.Tensor]]] = None,
                 bucket_bytes: Optional[int] = None):
        # type(self) is the subclass DistributedOptimizer builds, so this
        # is the wrapped optimizer's __init__
        super(type(self), self).__init__(params)
        self._compression = compression
        self._op = op
        self._scales = (1.0 / gradient_predivide_factor,
                        gradient_predivide_factor)
        self.backward_passes_per_step = backward_passes_per_step

        every_param = [p for g in self.param_groups for p in g["params"]]
        if named_parameters is None:
            named_parameters = [(f"allreduce.noname.{i}.{j}", p)
                                for i, g in enumerate(self.param_groups)
                                for j, p in enumerate(g["params"])]
        else:
            named_parameters = list(named_parameters)
        # the name is the negotiation key: a doubly named or unnamed tensor
        # would negotiate against the wrong peer
        if len({k for k, _ in named_parameters}) != len(named_parameters):
            raise ValueError("named_parameters contains duplicate names")
        covered = {p for _, p in named_parameters}
        missing = [p for p in every_param if p not in covered]
        if missing:
            raise ValueError(
                f"{len(missing)} parameters were not named by "
                "named_parameters; name all parameters or pass none")
        self._names = {p: k for k, p in named_parameters}
        self._inflight: Dict[torch.Tensor, Tuple[int, Any]] = {}
        self._hooked = set()
        self._hook_handles: List[Any] = []
        self._drained = False
        self._auto_drain = True
        # the reduction fires on the pass that brings this to zero
        self._passes_left = {p: backward_passes_per_step for p in every_param}

        buckets: Optional[List[List[torch.Tensor]]] = None
        if groups is not None:
            if num_groups:
                raise ValueError("pass either num_groups or groups, not both")
            buckets = [list(g) for g in groups]
        elif num_groups > 0:
            n = max(1, -(-len(every_param) // num_groups))
            buckets = [every_param[i:i + n]
                       for i in range(0, len(every_param), n)]
        else:
            if bucket_bytes is None:
                bucket_bytes = (_rt.get().fusion_threshold()
                                if _rt.is_initialized() else
                                KNOBS["HOROVOD_FUSION_THRESHOLD"].default)
            # a bucket has no per-tensor context to decompress with
            if compression is not Compression.none:
                bucket_bytes = 0
            if bucket_bytes > 0:
                buckets, cur, cur_bytes = [], [], 0
                for p in every_param:
                    nb = p.numel() * p.element_size()
                    if cur and cur_bytes + nb > bucket_bytes:
                        buckets.append(cur)
                        cur, cur_bytes = [], 0
                    cur.append(p)
                    cur_bytes += nb
                if cur:
                    buckets.append(cur)
                if len(buckets) == 1 and len(buckets[0]) == 1:
                    buckets = None
        self._buckets = buckets
        self._bucket_of = ({p: i for i, b in enumerate(buckets) for p in b}
                           if buckets is not None else {})
        self._bucket_pending: Dict[int, List[torch.Tensor]] = {}

        # the hooks live on the parameters, where Python's collector does
        # not see them: a bound method would keep this optimizer, and
        # through it the parameters and their state, alive for good
        me = weakref.ref(self)

        def on_grad(p: torch.Tensor) -> None:
            opt = me()
            if opt is not None:
                opt._on_grad_ready(p)
        for p in every_param:
            if p.requires_grad:
                self._hooked.add(p)
                self._hook_handles.append(
                    p.register_post_accumulate_grad_hook(on_grad))

    # ------------------------------------------------------------------ hooks
    def _on_grad_ready(self, p: torch.Tensor) -> None:
        if p in self._inflight and self._passes_left[p] <= 0:
            raise AssertionError(
                f"parameter {self._names.get(p)} accumulated a gradient "
                "again after its allreduce was submitted this step: more "
                "backward passes than backward_passes_per_step "
                f"({self.backward_passes_per_step}) between step() calls")
        if p.grad.requires_grad:
            raise AssertionError(
                "gradient tensors must not themselves require grad")
        self._passes_left[p] -= 1
        if self._passes_left[p] > 0:
            return
        # explicit groups need not cover every parameter; the rest reduce
        # on their own
        if p in self._bucket_of:
            self._enqueue_bucket(p)
        else:
            self._inflight[p] = self._submit_one(p)

    def _submit_one(self, p: torch.Tensor) -> Tuple[int, Any]:
        compressed, cctx = self._compression.compress(p.grad)
        handle = mpi_ops.allreduce_async_(
            compressed, name=self._names.get(p), op=self._op,
            prescale_factor=self._scales[0], postscale_factor=self._scales[1])
        if compressed is p.grad:
            return handle, None
        return handle, (cctx, compressed)

    def _enqueue_bucket(self, p: torch.Tensor) -> None:
        """Collect a bucket's ready parameters; submit one grouped
        allreduce when the last arrives, in the bucket's canonical order
        (hooks fire in any order, and a group matches tensors by
        position)."""
        gid = self._bucket_of[p]
        pending = self._bucket_pending.setdefault(gid, [])
        if not any(q is p for q in pending):  # tensor == is elementwise
            pending.append(p)
        bucket = [q for q in self._buckets[gid] if q.requires_grad]
        if len(pending) < len(bucket):
            return
        handle = mpi_ops.grouped_allreduce_async_(
            [q.grad for q in bucket],
            name=f"group.{gid}." + self._names.get(bucket[0], "noname"),
            op=self._op, prescale_factor=self._scales[0],
            postscale_factor=self._scales[1])
        for q in bucket:
            self._inflight[q] = (handle, None)
        self._bucket_pending[gid] = []

    # ------------------------------------------------------------ synchronize
    def synchronize(self) -> None:
        """Wait for every outstanding reduction (submitting those whose
        hooks did not fire) and write decompressed gradients back."""
        # a bucket left partial this step (a member got no gradient) falls
        # back to per-parameter reduction below
        self._bucket_pending.clear()
        for p in [q for q in self._hooked if q not in self._inflight]:
            if p.grad is not None:
                self._inflight[p] = self._submit_one(p)
        # sorted by handle: every rank waits in submission order
        waited = set()
        for p, (handle, ctx) in sorted(self._inflight.items(),
                                       key=lambda kv: kv[1][0]):
            self._passes_left[p] = self.backward_passes_per_step
            if handle not in waited:  # one wait covers a bucket
                mpi_ops.synchronize(handle)
                waited.add(handle)
            if ctx is not None:
                cctx, compressed = ctx
                p.grad.copy_(self._compression.decompress(compressed, cctx))
        self._inflight.clear()
        self._drained = True

    @contextmanager
    def skip_synchronize(self):
        """For ``optimizer.synchronize()``, then clipping, then ``step()``:
        the step does not synchronize again."""
        self._auto_drain = False
        try:
            yield
        finally:
            self._auto_drain = True

    def step(self, closure=None):
        if self._auto_drain:
            if self._drained:
                warnings.warn(
                    "step() after synchronize(): wrap step() in "
                    "skip_synchronize() when you call synchronize() "
                    "yourself")
            self.synchronize()
        self._drained = False
        return super(type(self), self).step(closure)

    def zero_grad(self, *args, **kwargs):
        if self._inflight:
            raise AssertionError(
                "zero_grad() while allreduces are in flight would race with "
                "their write-back: call step() or synchronize() first")
        return super(type(self), self).zero_grad(*args, **kwargs)


class _AdasumDeltaOptimizer(torch.optim.Optimizer):
    """Methods merged into a subclass of the wrapped optimizer's class: the
    update of a local step, Adasum-combined across ranks (the reference's
    Adasum optimizer).

    ``step()`` takes one local step with the wrapped optimizer's own rule,
    then sets each parameter to ``before + adasum(after - before)``: the
    local learning rate applies locally, and Adasum decides how the ranks'
    updates mix.  The deltas are submitted as ``adasum.delta.{group}.
    {index}`` (the parameter's place in ``param_groups``, the same on every
    rank) and waited for in that order.  With ``backward_passes_per_step =
    n`` only every n-th ``step()`` steps; gradients accumulate in ``.grad``
    meanwhile."""

    _hvd_wrapper = True

    def __init__(self, params, compression=Compression.none,
                 backward_passes_per_step: int = 1):
        super(type(self), self).__init__(params)
        self._compression = compression
        self.backward_passes_per_step = backward_passes_per_step
        self._step_count = 0

    def step(self, closure=None):
        self._step_count += 1
        if self._step_count % self.backward_passes_per_step:
            return None
        befores = [(gi, pi, p, p.detach().clone())
                   for gi, group in enumerate(self.param_groups)
                   for pi, p in enumerate(group["params"])
                   if p.grad is not None]
        loss = super(type(self), self).step(closure)
        pending = []
        for gi, pi, p, before in befores:
            comp, cctx = self._compression.compress(p.detach() - before)
            handle = mpi_ops.allreduce_async(comp, op=Adasum,
                                             name=f"adasum.delta.{gi}.{pi}")
            pending.append((p, before, handle, cctx))
        with torch.no_grad():
            for p, before, handle, cctx in pending:
                mixed = self._compression.decompress(
                    mpi_ops.synchronize(handle), cctx)
                p.copy_(before + mixed)
        return loss


def DistributedOptimizer(optimizer: torch.optim.Optimizer,
                         named_parameters=None,
                         compression=Compression.none,
                         backward_passes_per_step: int = 1,
                         op: ReduceOp = Average,
                         gradient_predivide_factor: float = 1.0,
                         num_groups: int = 0,
                         groups=None,
                         bucket_bytes: Optional[int] = None
                         ) -> torch.optim.Optimizer:
    """Wrap a torch optimizer for data-parallel training: an instance of a
    subclass of ``optimizer``'s class, on its ``param_groups``, whose
    gradients are allreduced as the backward produces them."""
    if gradient_predivide_factor != 1.0 and op != Average:
        raise ValueError(
            "gradient_predivide_factor needs op=Average")
    if backward_passes_per_step < 1:
        raise ValueError("backward_passes_per_step must be >= 1")
    base = type(optimizer)
    if op == Adasum:
        cls = type(base.__name__, (base,),
                   dict(_AdasumDeltaOptimizer.__dict__))
        return cls(optimizer.param_groups, compression,
                   backward_passes_per_step)
    cls = type(base.__name__, (base,), dict(_HookReducingOptimizer.__dict__))
    return cls(optimizer.param_groups, named_parameters, compression,
               backward_passes_per_step, op, gradient_predivide_factor,
               num_groups, groups, bucket_bytes)
