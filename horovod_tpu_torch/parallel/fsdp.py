"""FSDP with tensor parallelism by sharding propagation: the port of
``horovod_tpu/parallel/fsdp.py``.

The JAX module annotates each parameter with a ``NamedSharding`` and lets
XLA's SPMD partitioner place the all-gathers (parameter use), the
reduce-scatters (gradients) and the all-reduces (data parallelism).  Its
torch counterpart is DTensor: the parameters become ``DTensor``s on a
``DeviceMesh`` with axes ``("dp", "fsdp", "tp")``, placed from the same
specs, and torch's sharding propagation picks each operator's strategy and
inserts the collectives.  The explicitly scheduled chain is
``parallel/zero.py``; this module hands the same memory shape to the
propagation, with the least knob control.

A spec is a tuple with one entry per tensor dim: None, an axis name, or a
tuple of axis names (the dim split over several axes, the first major),
the JAX ``PartitionSpec``'s entries.  The port's dense weights are
``[out, in]``, so its Megatron rules read reversed against the JAX
module's ``[in, out]`` kernels: column-parallel wq/wk/wv/w_gate/w_up are
``(tp, fsdp)``, row-parallel wo/w_down ``(fsdp, tp)``, the lm_head
``(tp, fsdp)``, and the embedding is vocab-parallel over both axes,
``(("fsdp", "tp"), None)``.

The model's plain tensors (the RoPE tables, the causal mask) enter as
replicated through ``implicit_replication``.  Every operator of the Llama
forward and backward propagates but one: ``aten.gather`` of the targets'
logits from logits whose vocab dim is sharded over tp (the lm_head is
column-parallel) gives a ``MaskPartial`` value, and its reduction after
``layers.softmax_cross_entropy``'s ``squeeze`` applies a mask of the
unsqueezed shape and raises (``IndexError: too many indices``).
:func:`llama_loss_fn` therefore gathers the logits' vocab dim over tp (an
all-gather of activations; every parameter stays sharded) before the
cross-entropy.

The attention runs on explicitly placed activations
(:func:`placed_attention`): q, k and v are redistributed to rows over the
data axes and heads over tp, and the attention computes on each rank's
local tensors.  Left to propagation, the attention's first ``einsum``
(``layers.causal_attention``, ``bqhrd,bkhd->bhrqk``) stalled the step: on
four gloo ranks of a (1, 2, 2) mesh, DTensor's strategy expansion for it
spends its time in the graph search of redistribution costs
(``_redistribute.find_min_cost_path``, from
``generate_redistribute_costs``).  The ``tiny`` Llama on 8 rows did not
finish a step in 70 s at 11, 12, 14 and 15 positions (and not in 5
minutes at 15, the JAX test's shape), where 16, 17, 18, 20 and 24
positions finished (the whole four-process run in 21-25 s at 17-24); so
the trigger is a short sequence, not one the mesh does not divide, and
why short sequences search longer was not found.  With the placement, 8,
12 and 15 positions each finish, the whole run in 17-26 s (PyTorch 2.13
on the CPU).
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn

Spec = Tuple[Any, ...]
MESH_AXES = ("dp", "fsdp", "tp")


def auto_shard_spec(shape: Sequence[int], axis_name: str,
                    axis_size: int) -> Spec:
    """Shard the largest divisible dim over ``axis_name``; replicate when
    nothing divides (small scalars, norm scales)."""
    if not shape:
        return ()
    for i in sorted(range(len(shape)), key=lambda i: -shape[i]):
        if shape[i] % axis_size == 0 and shape[i] >= axis_size:
            spec = [None] * len(shape)
            spec[i] = axis_name
            return tuple(spec)
    return ()


def _axis_size(mesh, axis: str) -> int:
    names = mesh.mesh_dim_names or ()
    return mesh.size(names.index(axis)) if axis in names else 1


def fsdp_shardings(params: Any, mesh, axis_name: str = "fsdp"
                   ) -> Dict[str, Spec]:
    """ZeRO-3-style specs ``{name: spec}`` of a module's parameters (or a
    ``{name: tensor}`` dict): each on its largest dim that ``axis_name``
    divides."""
    named = (dict(params.named_parameters())
             if isinstance(params, nn.Module) else dict(params))
    size = _axis_size(mesh, axis_name)
    return {n: auto_shard_spec(tuple(t.shape), axis_name, size)
            for n, t in named.items()}


def llama_param_specs(params: Any, tp_axis: Optional[str] = "tp",
                      fsdp_axis: Optional[str] = "fsdp",
                      mesh=None) -> Dict[str, Spec]:
    """Megatron TP x FSDP specs ``{name: spec}`` of a ``llama.Llama``'s
    parameters (or a ``{name: tensor}`` dict), the port's ``[out, in]``
    layout: column-parallel wq/wk/wv/w_gate/w_up ``(tp, fsdp)``,
    row-parallel wo/w_down ``(fsdp, tp)``, lm_head ``(tp, fsdp)``, the
    embedding vocab-parallel over both axes (its dim replicated), norm
    scales replicated.  With ``mesh``, an axis it lacks is dropped."""
    names = set(mesh.mesh_dim_names or ()) if mesh is not None else None
    tp = tp_axis if names is None or tp_axis in names else None
    fs = fsdp_axis if names is None or fsdp_axis in names else None
    named = (dict(params.named_parameters())
             if isinstance(params, nn.Module) else dict(params))

    def spec(path: str, ndim: int) -> Spec:
        if ndim < 2:
            return ()
        if re.search(r"(wq|wk|wv|w_gate|w_up)", path):
            return (tp, fs)
        if re.search(r"(wo|w_down)", path):
            return (fs, tp)
        if "lm_head" in path:
            return (tp, fs)
        if "embed" in path:
            vocab = tuple(a for a in (fs, tp) if a is not None)
            if not vocab:
                return (None, None)
            return (vocab if len(vocab) > 1 else vocab[0], None)
        return ()

    return {n: spec(n, t.dim()) for n, t in named.items()}


def placements(spec: Spec, mesh) -> list:
    """The DTensor placements of ``spec`` on ``mesh``: per mesh dim,
    ``Shard(d)`` for the tensor dim whose entry names it, else
    ``Replicate()``.  A dim named by several axes is split over them in
    mesh order, the first major (as the JAX entry's tuple)."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for axis in mesh.mesh_dim_names:
        place = Replicate()
        for d, entry in enumerate(spec):
            if entry == axis or (isinstance(entry, tuple) and axis in entry):
                place = Shard(d)
        out.append(place)
    return out


@torch.no_grad()
def shard_params(model: nn.Module, mesh, param_specs: Dict[str, Spec]
                 ) -> nn.Module:
    """Replace every parameter of ``model`` (the same values on every rank)
    by a DTensor parameter placed per its spec, in place: each rank keeps
    only its shards."""
    from torch.distributed.tensor import distribute_tensor
    for name, p in list(model.named_parameters()):
        owner = model.get_submodule(name.rsplit(".", 1)[0]) \
            if "." in name else model
        leaf = name.rsplit(".", 1)[-1]
        d = distribute_tensor(p.detach(), mesh,
                              placements(param_specs[name], mesh))
        setattr(owner, leaf, nn.Parameter(d, requires_grad=p.requires_grad))
    return model


def init_opt_state(optimizer: type, model: nn.Module, **optimizer_kwargs
                   ) -> torch.optim.Optimizer:
    """The optimizer over the sharded parameters: its parameter-shaped
    state (moments) takes each parameter's placement, so it is created in
    its final sharded layout."""
    return optimizer(model.parameters(), **optimizer_kwargs)


# q/k/v ``[B, S, heads, head_dim]`` at the attention: rows over the data
# axes, heads over tp (the column-parallel wq/wk/wv's output split)
ATTN_SPEC: Spec = (("dp", "fsdp"), None, "tp", None)


def placed_attention(attn_fn: Optional[Callable] = None) -> Callable:
    """An ``attn_fn`` for the sharded model: q, k and v are redistributed
    to :data:`ATTN_SPEC` and ``attn_fn`` (the plain
    ``layers.causal_attention`` when None) runs on each rank's local rows
    and heads, whose GQA groups stay whole (a contiguous split of the
    heads splits the kv heads alike).  The output re-enters as a DTensor of
    the same placement, so no sharding strategy is searched for the
    attention's operators (module docstring)."""
    from torch.distributed.tensor import DTensor
    from ..models import layers as L
    inner = attn_fn or L.causal_attention

    def attn(q, k, v):
        if not isinstance(q, DTensor):
            return inner(q, k, v)
        mesh = q.device_mesh
        place = placements(ATTN_SPEC, mesh)
        o = inner(*(t.redistribute(mesh, place).to_local()
                    for t in (q, k, v)))
        return DTensor.from_local(o, mesh, place, run_check=False,
                                  shape=q.shape, stride=q.stride())
    return attn


def llama_loss_fn(model: nn.Module, ids: torch.Tensor,
                  attn_fn: Optional[Callable] = None) -> torch.Tensor:
    """``llama.loss_fn`` for a model sharded by :func:`shard_params`:
    attention through :func:`placed_attention`, and the logits' vocab dim
    gathered over its mesh axes before the cross-entropy (module
    docstring)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from ..models import layers as L
    logits = model(ids[:, :-1], attn_fn=placed_attention(attn_fn))
    if isinstance(logits, DTensor):
        last = logits.ndim - 1
        logits = logits.redistribute(placements=[
            Replicate() if isinstance(p, Shard) and p.dim == last else p
            for p in logits.placements])
    return L.softmax_cross_entropy(logits, ids[:, 1:]).mean()


def make_fsdp_train_step(model: nn.Module,
                         loss_fn: Callable[..., torch.Tensor],
                         optimizer: torch.optim.Optimizer, mesh,
                         batch_spec: Spec = ("dp",)) -> Callable:
    """``step(*batch) -> loss``: the batch (global, the same on every rank)
    placed per ``batch_spec``, ``loss_fn(model, *batch)`` on the sharded
    parameters (:func:`shard_params`), the backward and the optimizer step,
    with every collective placed by sharding propagation.  Returns the loss
    as a plain tensor."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    def step(*batch: torch.Tensor) -> torch.Tensor:
        dev = next(iter(model.parameters())).device
        placed = [distribute_tensor(b.to(dev), mesh,
                                    placements(batch_spec, mesh))
                  for b in batch]
        with implicit_replication():
            loss = loss_fn(model, *placed)
            loss.backward()
            optimizer.step()
        optimizer.zero_grad(set_to_none=True)
        loss = loss.detach()
        return loss.full_tensor() if isinstance(loss, DTensor) else loss
    return step


__all__ = ["auto_shard_spec", "fsdp_shardings", "llama_param_specs",
           "placements", "shard_params", "llama_loss_fn",
           "init_opt_state", "make_fsdp_train_step"]
