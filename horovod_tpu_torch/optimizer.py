"""DistributedOptimizer: the port of ``horovod_tpu/optimizer.py``
(``sync_gradients``, ``sync_gradients_ef``, ``distributed_optimizer``,
``wire_residual_report``) in the Horovod torch idiom.

``DistributedOptimizer(torch_optimizer, named_parameters=...)`` returns an
optimizer of the same class whose ``step()`` first allreduces the gradients:
packed into the fusion plan's buckets, one collective per bucket in the
bucket's wire format (``ops/wire.py``), unpacked back into each ``.grad``.
With ``backward_passes_per_step = n > 1`` it follows the JAX wrapper: every
``step()`` takes one microbatch's gradients and every n-th applies the
update; the other calls leave the parameters alone.  Either the n
gradients are accumulated and their mean synced once (the classic path),
or, with the overlap plane on (``ops/overlap.py``), each microbatch's
gradients are synced on the side stream while the next one computes.

The sync runs at ``step()``.  The eager API's ``DistributedOptimizer``
(``horovod_tpu_torch.torch``) starts it during the backward through
gradient hooks instead.
"""

from __future__ import annotations

import weakref
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from . import runtime as _rt
from .common.knobs import KNOBS, current
from .common.reduce_op import Average, ReduceOp, Sum
from .ops import overlap as _overlap
from .ops import spmd, wire as _wire
from .ops.compression import Compression
from .ops.fusion import BucketPlan, fused_apply, make_plan

WirePolicy = Union[str, _wire.Policy]


def _plan_for(tensors: Sequence[torch.Tensor], threshold: int):
    shapes = [tuple(t.shape) for t in tensors]
    dtypes = [t.dtype for t in tensors]
    if _rt.is_initialized():
        return _rt.get().plan_cache.get(shapes, dtypes, threshold)
    return make_plan(shapes, dtypes, threshold)


def _resolve_wire_policy(wire_policy: Optional[WirePolicy],
                         quantized_wire: bool, compression: type,
                         op: ReduceOp
                         ) -> Tuple[Optional[_wire.Policy], Optional[type]]:
    """The resolution order wire_policy > quantized_wire > compression >
    HOROVOD_WIRE_POLICY.  ``quantized_wire=True`` is the 'int8_ring'
    policy and ``Compression.bf16/fp16`` the cast policies.  Returns
    ``(policy, None)``, or ``(None, compressor)`` for a custom Compressor
    subclass, which keeps the fused compress/allreduce/decompress path."""
    if wire_policy is not None:
        return _wire.get_policy(wire_policy), None
    if quantized_wire:
        if op not in (Average, Sum):
            raise ValueError(
                "quantized_wire supports Average/Sum reductions only "
                f"(got {op}); Adasum/Min/Max/Product have no quantized "
                "ring")
        return _wire.get_policy("int8_ring"), None
    if compression is Compression.bf16:
        return _wire.get_policy("bf16"), None
    if compression is Compression.fp16:
        return _wire.get_policy("fp16"), None
    if compression is not Compression.none:
        return None, compression
    name = (_rt.get().wire_policy() if _rt.is_initialized()
            else _wire.validate_policy_name(current("HOROVOD_WIRE_POLICY")))
    return _wire.get_policy(name), None


def _grads_of(params_or_grads: Iterable[torch.Tensor]) -> List[torch.Tensor]:
    grads = []
    for t in params_or_grads:
        if isinstance(t, torch.nn.Parameter):
            if t.grad is not None:
                grads.append(t.grad)
        else:
            grads.append(t)
    if not all(g.is_contiguous() for g in grads):
        raise ValueError("sync_gradients needs contiguous gradients")
    return grads


def _sync_impl(grads: List[torch.Tensor],
               residuals: Optional[List[torch.Tensor]], op: ReduceOp,
               compression: type, prescale_factor: float,
               postscale_factor: float,
               fusion_threshold_bytes: Optional[int], quantized_wire: bool,
               wire_policy: Optional[WirePolicy]
               ) -> Tuple[List[torch.Tensor], Optional[List[torch.Tensor]]]:
    """The engine behind sync_gradients / sync_gradients_ef: reduces
    ``grads`` in place and returns ``(grads, new_residuals)`` (residuals
    pass through when error feedback is off or the custom-compressor path
    runs)."""
    if not grads:
        return grads, residuals
    threshold = fusion_threshold_bytes
    if threshold is None:
        threshold = (_rt.get().fusion_threshold() if _rt.is_initialized()
                     else KNOBS["HOROVOD_FUSION_THRESHOLD"].default)
    plan = _plan_for(grads, threshold)
    policy, legacy = _resolve_wire_policy(wire_policy, quantized_wire,
                                          compression, op)
    if legacy is not None:
        # a custom Compressor: no error feedback (it owns its loss)
        def reduce(buf: torch.Tensor) -> torch.Tensor:
            buf, ctx = legacy.compress(buf)
            buf = spmd.allreduce(buf, op=op, prescale_factor=prescale_factor,
                                 postscale_factor=postscale_factor)
            return legacy.decompress(buf, ctx)
        synced, new_res = fused_apply(grads, plan, reduce), residuals
    else:
        formats = _wire.plan_formats(plan, policy, op, once=True)
        synced, new_res = _wire.wire_sync(
            grads, plan, formats, op, prescale_factor=prescale_factor,
            postscale_factor=postscale_factor, residuals=residuals)
        if new_res is None:
            new_res = residuals
    with torch.no_grad():
        for g, s in zip(grads, synced):
            if s.data_ptr() != g.data_ptr():  # one-leaf buckets reduced in place
                g.copy_(s)
    return grads, new_res


def sync_gradients(params_or_grads: Iterable[torch.Tensor],
                   op: ReduceOp = Average,
                   compression: type = Compression.none,
                   prescale_factor: float = 1.0,
                   postscale_factor: float = 1.0,
                   fusion_threshold_bytes: Optional[int] = None,
                   quantized_wire: bool = False,
                   wire_policy: Optional[WirePolicy] = None
                   ) -> List[torch.Tensor]:
    """Allreduce gradients in place with bucket fusion and return them.

    Takes parameters (their ``.grad`` is synced; parameters without one are
    skipped) or the gradient tensors themselves.  ``wire_policy`` picks a
    wire format per bucket (ops/wire.py): a format name, 'auto', or a
    callable ``(nbytes, dtype, layout) -> name``; ``quantized_wire`` and
    ``compression`` are its older aliases (resolution order: wire_policy >
    quantized_wire > compression > HOROVOD_WIRE_POLICY).  For error
    feedback use :func:`sync_gradients_ef` or the optimizer."""
    grads, _ = _sync_impl(_grads_of(params_or_grads), None, op, compression,
                          prescale_factor, postscale_factor,
                          fusion_threshold_bytes, quantized_wire,
                          wire_policy)
    return grads


def sync_gradients_ef(params_or_grads: Iterable[torch.Tensor],
                      residuals: Sequence[torch.Tensor],
                      op: ReduceOp = Average,
                      compression: type = Compression.none,
                      prescale_factor: float = 1.0,
                      postscale_factor: float = 1.0,
                      fusion_threshold_bytes: Optional[int] = None,
                      quantized_wire: bool = False,
                      wire_policy: Optional[WirePolicy] = None
                      ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """:func:`sync_gradients` with EF-SGD error feedback: ``residuals``
    (one tensor per gradient, zeros at first) is added into the gradients
    before compression, and each lossy bucket's rank-local encode error
    comes back as the new residual.  Returns ``(grads, new_residuals)``."""
    return _sync_impl(_grads_of(params_or_grads), list(residuals), op,
                      compression, prescale_factor, postscale_factor,
                      fusion_threshold_bytes, quantized_wire, wire_policy)


def _ef_enabled(error_feedback: Optional[bool],
                wire_policy: Optional[WirePolicy], quantized_wire: bool,
                compression: type) -> bool:
    """Error feedback defaults to the HOROVOD_WIRE_EF knob whenever a
    wire format is asked for by argument (wire_policy, quantized_wire or
    Compression.bf16/fp16); a policy set only through HOROVOD_WIRE_POLICY
    adds no residuals.  ``error_feedback`` wins either way."""
    if error_feedback is not None:
        return bool(error_feedback)
    active = (wire_policy not in (None, "none") or quantized_wire
              or compression in (Compression.bf16, Compression.fp16))
    return bool(active and current("HOROVOD_WIRE_EF"))


def wire_residual_report(residuals: Sequence[torch.Tensor],
                         plan: Optional[BucketPlan] = None) -> Dict[str, float]:
    """L2 norms of error-feedback residuals, per bucket of ``plan`` or per
    leaf, computed in float64 on the host and set on the
    ``hvd_wire_residual_norm`` gauge (label ``bucket``), as the JAX
    function does."""
    from .utils import metrics as _metrics
    sq = [float(np.sum(np.square(r.detach().double().cpu().numpy())))
          for r in residuals]
    if plan is not None:
        report = {f"bucket{i}": float(np.sqrt(sum(sq[j] for j in b.indices)))
                  for i, b in enumerate(plan.buckets)}
    else:
        report = {f"leaf{i}": float(np.sqrt(s)) for i, s in enumerate(sq)}
    for label, norm in report.items():
        _metrics.WIRE_RESIDUAL_NORM.set(norm, bucket=label)
    return report


class _DistributedOptimizer(torch.optim.Optimizer):
    """Methods merged into a subclass of the wrapped optimizer's class.

    The error-feedback residuals live in ``wire_residuals``, a dict from
    parameter to a tensor shaped like its gradient, made at the first sync
    and outside ``optimizer.state``: they are each rank's own encode error
    (the JAX package's ``_WireState.residual``), so ``state_dict()`` does
    not save them and ``broadcast_optimizer_state`` leaves every rank's
    own.  A reloaded optimizer keeps the residuals it had in memory, or
    starts from none."""

    _hvd_wrapper = True

    def __init__(self, params, backward_passes_per_step, sync_kw,
                 error_feedback, overlap, overlap_depth):
        super(self.__class__, self).__init__(params)
        self._hvd_passes = backward_passes_per_step
        self._hvd_sync_kw = sync_kw
        self._hvd_ef = error_feedback
        self.wire_residuals: Dict[torch.Tensor, torch.Tensor] = {}
        self._hvd_count = 0
        self._hvd_acc = None
        self._hvd_pipeline = None
        self.set_overlap(overlap, overlap_depth)

    def set_overlap(self, overlap: Optional[bool] = None,
                    overlap_depth: Optional[int] = None) -> None:
        """Turn the microbatch pipeline on or off (the argument, else
        HOROVOD_OVERLAP) at depth ``overlap_depth`` (else the runtime's);
        only between cycles.  ``backward_passes_per_step = 1`` has nothing
        to pipeline."""
        if (self._hvd_count % self._hvd_passes or (
                self._hvd_pipeline is not None
                and self._hvd_pipeline.calls % self._hvd_passes)):
            raise RuntimeError("set_overlap in the middle of a "
                               "backward_passes_per_step cycle")
        self._hvd_pipeline = None
        if self._hvd_passes > 1 and _overlap.overlap_enabled(overlap):
            # through a weak reference: a pipeline holding its optimizer
            # would make a cycle, which keeps the parameters' state on the
            # card until the garbage collector happens to run
            ref = weakref.ref(self)
            self._hvd_pipeline = _overlap.make_pipelined_transform(
                lambda grads: ref()._hvd_sync(grads),
                lambda mean: ref()._hvd_apply(mean), self._hvd_passes,
                _overlap.resolve_depth(overlap_depth),
                on_cycle=_overlap.microbatch_overlap_model)

    def _hvd_params(self) -> List[torch.Tensor]:
        return [p for group in self.param_groups for p in group["params"]
                if p.grad is not None]

    def _hvd_sync(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """One fused sync of ``grads`` (those of ``_hvd_params()``, in
        order) in place, threading the residuals when EF is on."""
        kw = self._hvd_sync_kw
        if not self._hvd_ef:
            return sync_gradients(grads, **kw)
        params = self._hvd_params()
        res = [self.wire_residuals.get(p) for p in params]
        res = [torch.zeros_like(g) if r is None else r
               for r, g in zip(res, grads)]
        grads, res = sync_gradients_ef(grads, res, **kw)
        self.wire_residuals.update(zip(params, res))
        return grads

    def _hvd_apply(self, mean: List[torch.Tensor]):
        with torch.no_grad():
            for p, m in zip(self._hvd_params(), mean):
                p.grad.copy_(m)
        return super(self.__class__, self).step()

    def synchronize(self) -> None:
        """Allreduce every parameter's gradient (what ``step`` runs)."""
        self._hvd_sync([p.grad for p in self._hvd_params()])

    def step(self, closure=None):
        if self._hvd_passes == 1:
            self.synchronize()
            return super(self.__class__, self).step(closure)
        if self._hvd_pipeline is not None:
            if closure is not None:
                raise ValueError("the microbatch pipeline takes no closure")
            return self._hvd_pipeline([p.grad for p in self._hvd_params()])
        params = self._hvd_params()
        with torch.no_grad():
            if self._hvd_acc is None:
                self._hvd_acc = {p: torch.zeros_like(p.grad) for p in params}
            for p in params:
                self._hvd_acc[p].add_(p.grad)
        self._hvd_count += 1
        if self._hvd_count % self._hvd_passes:
            return None
        with torch.no_grad():
            for p in params:
                p.grad.copy_(self._hvd_acc[p]).div_(self._hvd_passes)
                self._hvd_acc[p].zero_()
        self.synchronize()
        return super(self.__class__, self).step(closure)


def DistributedOptimizer(optimizer: torch.optim.Optimizer,
                         named_parameters=None,
                         op: ReduceOp = Average,
                         backward_passes_per_step: int = 1,
                         fusion_threshold_bytes: Optional[int] = None,
                         compression: type = Compression.none,
                         prescale_factor: float = 1.0,
                         postscale_factor: float = 1.0,
                         quantized_wire: bool = False,
                         wire_policy: Optional[WirePolicy] = None,
                         error_feedback: Optional[bool] = None,
                         overlap: Optional[bool] = None,
                         overlap_depth: Optional[int] = None
                         ) -> torch.optim.Optimizer:
    """Wrap ``optimizer`` so that ``step()`` sees gradients synced across
    ranks (Horovod: ``hvd.DistributedOptimizer``).  The result is an
    instance of a subclass of ``optimizer``'s class, built on its
    ``param_groups`` (hyperparameters kept, state fresh).

    ``compression``, ``quantized_wire`` and ``wire_policy`` choose the wire
    formats (see :func:`sync_gradients`); ``error_feedback`` keeps EF
    residuals for the lossy ones (default: HOROVOD_WIRE_EF when a format
    is asked for by argument); ``overlap`` and ``overlap_depth`` pipeline
    the per-microbatch syncs when ``backward_passes_per_step > 1``
    (default: HOROVOD_OVERLAP and HOROVOD_OVERLAP_DEPTH)."""
    if backward_passes_per_step < 1:
        raise ValueError("backward_passes_per_step must be >= 1")
    if named_parameters is not None:
        named = {id(p) for _, p in named_parameters}
        if any(id(p) not in named for group in optimizer.param_groups
               for p in group["params"]):
            raise ValueError("named_parameters does not name every "
                             "parameter of the optimizer")
    # resolve now, so a bad name or reduction fails here, not at step()
    _resolve_wire_policy(wire_policy, quantized_wire, compression, op)
    if overlap_depth is not None:
        _overlap.resolve_depth(overlap_depth)
    sync_kw = dict(op=op, compression=compression,
                   prescale_factor=prescale_factor,
                   postscale_factor=postscale_factor,
                   fusion_threshold_bytes=fusion_threshold_bytes,
                   quantized_wire=quantized_wire, wire_policy=wire_policy)
    ef = _ef_enabled(error_feedback, wire_policy, quantized_wire, compression)
    cls = type(optimizer.__class__.__name__, (optimizer.__class__,),
               dict(_DistributedOptimizer.__dict__))
    return cls(optimizer.param_groups, backward_passes_per_step, sync_kw, ef,
               overlap, overlap_depth)
