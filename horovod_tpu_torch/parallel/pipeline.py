"""Pipeline parallelism: the GPipe microbatch schedule over a process group,
the port of ``horovod_tpu/parallel/pipeline.py``.

Each rank of the pipeline group holds one stage of a layer stack.  The
batch is cut into ``n_micro`` microbatches that enter at stage 0 and leave
at stage ``S - 1``; the schedule runs ``n_micro + S - 1`` ticks, and at
every tick each stage computes on what it holds and shifts its result one
stage on, around the ring (the wrap-around link back to stage 0 carries a
value stage 0 never reads).  The JAX package writes the ticks as a
``lax.scan`` of compute then ``ppermute`` and lets autodiff pipeline the
backward; here the ticks are a Python loop and the shift is an autograd
``Function`` (:class:`_Shift`) whose backward is the reverse shift, so
``loss.backward()`` runs the pipelined backward.

The backward's exchanges pair up across ranks only if every rank runs
every tick's reverse shift, in the same order.  Each shift therefore also
takes the previous tick's received tensor as an anchor input: the shifts
form one chain, tick ``t`` depends on tick ``t - 1``, and autograd runs
their backwards from the last tick down to the first on every rank,
whether or not the stage used what it received (stage 0 reads its
microbatches instead).  The closing collect (:class:`_Collect`, the JAX
package's ``psum`` of the last stage's outputs, whose transpose is again a
``psum``) takes the last shift's output as its anchor.  A stage skips the
compute of a tick on which it holds no microbatch: the JAX schedule
computes it and masks the result to zeros, so the values and the per-tick
exchange are the same.

``pipeline_shardings`` (NamedShardings that place each stage's slice of
the stacked parameters on its chip) has no counterpart: a rank builds or
loads only its own stage's parameters (``layout.slice_llama``), so there
is no stacked array to place.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

Tensor = torch.Tensor


def stack_stage_params(stage_params: Sequence[Any]) -> Any:
    """Stack per-stage parameter trees (dicts, lists, tensors or numpy
    arrays) along a new leading ``[S]`` axis."""
    first = stage_params[0]
    if isinstance(first, dict):
        return {k: stack_stage_params([p[k] for p in stage_params])
                for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(stack_stage_params([p[i] for p in stage_params])
                           for i in range(len(first)))
    if isinstance(first, torch.Tensor):
        return torch.stack(list(stage_params), dim=0)
    return np.stack([np.asarray(p) for p in stage_params], axis=0)


def _group_or_world(group):
    return dist.group.WORLD if group is None else group


class _Shift(torch.autograd.Function):
    """One tick's ring shift over the pipeline group: send ``x`` to stage
    ``idx + 1``, receive from stage ``idx - 1``; the backward shifts the
    cotangent the other way.  ``anchor`` (the previous tick's output) only
    orders the backwards (module docstring)."""

    @staticmethod
    def forward(ctx, x: Tensor, anchor: Tensor, group, nxt: int,
                prv: int) -> Tensor:
        ctx.group, ctx.nxt, ctx.prv = group, nxt, prv
        return _exchange(x.contiguous(), send_to=nxt, recv_from=prv,
                         group=group)

    @staticmethod
    def backward(ctx, g: Tensor):
        back = _exchange(g.contiguous(), send_to=ctx.prv,
                         recv_from=ctx.nxt, group=ctx.group)
        return (back if ctx.needs_input_grad[0] else None, None, None, None,
                None)


def _exchange(x: Tensor, send_to: int, recv_from: int, group) -> Tensor:
    """Send ``x`` to global rank ``send_to`` while receiving a tensor of its
    shape from ``recv_from``, in one batch of point-to-point operations."""
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, send_to, group),
           dist.P2POp(dist.irecv, out, recv_from, group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return out


class _Collect(torch.autograd.Function):
    """The closing ``psum`` over the pipeline group, whose backward is also
    a ``psum`` (JAX's transpose of ``psum``; the layout plane's
    ``scale_grad(1/pp)`` compensates).  ``anchor`` is the last shift's
    output, so that shift's backward runs on every rank."""

    @staticmethod
    def forward(ctx, x: Tensor, anchor: Tensor, group) -> Tensor:
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g: Tensor):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return (g if ctx.needs_input_grad[0] else None), None, None


def _spmd_pipeline(stage_fn: Callable[[Tensor], Tensor], x: Tensor,
                   n_micro: int, group=None) -> Tensor:
    """This rank is stage ``idx`` of ``S`` (its rank in ``group``).

    ``x``: ``[M, mb, ...]`` microbatches on every rank (only stage 0 reads
    its values); ``stage_fn(h) -> h'`` keeps the shape.  Returns the
    ``[M, mb, ...]`` outputs of the last stage on every rank."""
    g = _group_or_world(group)
    S, idx = dist.get_world_size(g), dist.get_rank(g)
    if S == 1:
        return torch.stack([stage_fn(x[m]) for m in range(n_micro)])
    nxt = dist.get_global_rank(g, (idx + 1) % S)
    prv = dist.get_global_rank(g, (idx - 1) % S)
    mb_shape = x.shape[1:]
    recv = torch.zeros(mb_shape, dtype=x.dtype, device=x.device,
                       requires_grad=torch.is_grad_enabled())
    banked: List[Optional[Tensor]] = [None] * n_micro
    for t in range(n_micro + S - 1):
        mb = t - idx  # the microbatch this stage works on at tick t
        if 0 <= mb < n_micro:
            out = stage_fn(x[t] if idx == 0 else recv)
            if idx == S - 1:
                banked[mb] = out
        else:
            out = torch.zeros(mb_shape, dtype=x.dtype, device=x.device)
        recv = _Shift.apply(out, recv, g, nxt, prv)
    local = (torch.stack(banked) if idx == S - 1 else
             torch.zeros((n_micro,) + tuple(mb_shape), dtype=x.dtype,
                         device=x.device))
    return _Collect.apply(local, recv, g)


def make_pipeline_fn(stage_fn: Callable[[Any, Tensor], Tensor],
                     n_micro: int, group=None) -> Callable:
    """``apply(stage_params, x) -> out``: ``x`` ``[B, ...]`` (the same on
    every rank of ``group``, the world when None) through the stages in
    ``n_micro`` microbatches; ``stage_params`` are this rank's stage's
    (whatever ``stage_fn(stage_params, h) -> h'`` takes; it must keep h's
    shape).  Differentiable: the backward is pipelined.

    Data parallelism composes by giving each data-parallel rank its own
    rows and averaging the gradients over the data-parallel group, as the
    layout plane's train step does (the JAX package's ``batch_axis``).

    Every rank computes the loss from the same ``out``; the backward of
    each rank's loss gives the true gradients of its stage's parameters
    (the collect's ``psum`` transpose sums the ranks' cotangents, and
    ``scale_grad(1/S)`` divides them back)."""
    from . import layout as _lay

    def apply(stage_params, x: Tensor) -> Tensor:
        B = x.shape[0]
        if B % n_micro:
            raise ValueError(f"batch {B} not divisible by "
                             f"n_micro={n_micro}")
        xm = x.reshape((n_micro, B // n_micro) + tuple(x.shape[1:]))
        out = _spmd_pipeline(lambda h: stage_fn(stage_params, h), xm,
                             n_micro, group)
        out = _lay.scale_grad(out, 1.0 / apply.n_stages)
        return out.reshape((B,) + tuple(out.shape[2:]))

    apply.n_stages = dist.get_world_size(_group_or_world(group))
    apply.n_micro = n_micro
    return apply


def make_pipelined_llama(cfg, n_micro: int, group=None,
                         attn_fn: Optional[Callable] = None):
    """Pipeline the Llama over ``group`` (the world when None): the layer
    stack runs through the GPipe schedule, ``n_layers / S`` layers per
    stage, while the embedding, final norm and lm_head run on every rank
    outside it.

    Returns ``(apply_fn, restack)``: ``restack(model)`` slices a full
    ``llama.Llama`` into this rank's stage (a ``layout.LayoutLlama`` at
    tp = 1: the embedding, the stage's layers, the final norm and the
    lm_head), and ``apply_fn(pmodel, ids) -> logits`` is differentiable end
    to end and gives the same logits on every rank."""
    from . import layout as _lay
    g = _group_or_world(group)
    S, stage = dist.get_world_size(g), dist.get_rank(g)
    if cfg.n_layers % S:
        raise ValueError(f"n_layers={cfg.n_layers} not divisible by "
                         f"{S} stages")
    ranks = dist.get_process_group_ranks(g)
    lay = _lay.ProcessLayout((1, 1, S), (0, 0, stage), {"pp": g},
                             {"pp": ranks})

    def restack(model):
        pmodel = _lay.slice_llama(model, lay.coord, lay.dims)
        pmodel.process_layout, pmodel.n_micro = lay, n_micro
        return pmodel

    def apply_fn(pmodel, ids: Tensor) -> Tensor:
        return pmodel(ids, attn_fn=attn_fn)

    return apply_fn, restack


def pipeline_bubble_fraction(n_stages: int, n_micro: int) -> float:
    """The GPipe bubble (S - 1) / (M + S - 1)."""
    return (n_stages - 1) / (n_micro + n_stages - 1)


__all__ = ["make_pipeline_fn", "stack_stage_params", "make_pipelined_llama",
           "pipeline_bubble_fraction"]
