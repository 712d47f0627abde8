"""Expert parallelism: capacity-bounded top-k MoE dispatch over a process
group, the port of ``horovod_tpu/parallel/expert.py``.

With E experts over an ep-rank group (``group``; ``None``: the world) each
rank owns E/ep experts (rank r the experts ``[r * E/ep, (r + 1) * E/ep)``)
and its own token shard.  Per rank: route -> the dispatch einsum
``[T, D] x [T, E, C] -> [E, C, D]`` -> an all-to-all that brings every
expert's slots to its owner -> the expert FFNs -> the inverse all-to-all ->
the combine einsum weighted by the gates.  Static capacity keeps every
shape fixed.  The all-to-alls are ``sequence.all_to_all`` (differentiable,
the backward is the inverse exchange), and the load-balancing ``aux`` is
averaged over the group by an all-reduce whose backward sums the ranks'
cotangents (the adjoint of the mean when each rank's loss holds its own
copy of it).

Parameters are ``{"router": [D, E], "wi": [E_local, D, H], "wo":
[E_local, H, D]}`` tensors, the JAX tree's layout (no transposes).
:func:`moe_params_from_jax` loads a JAX tree; :func:`local_experts`
slices a full tree to this rank's experts.

Composition: each rank computes its share of the global loss on its own
token shard (the global batch split by rows, so the tokens are the JAX
``P(axis)`` shard of the flattened batch).  The gradients of the
replicated leaves (the router and everything outside the MoE block) are
then summed over the group; each rank's expert gradients are already
complete, since the all-to-all's backward brings every rank's share home.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as Fn

from .sequence import all_to_all

Tensor = torch.Tensor
MoeParams = Dict[str, Tensor]


def init_moe_params(dim: int, hidden: int, n_experts: int,
                    generator: Optional[torch.Generator] = None,
                    dtype: torch.dtype = torch.float32,
                    device: Union[str, torch.device, None] = None
                    ) -> MoeParams:
    """Router and per-expert FFN weights, experts stacked on dim 0, with the
    JAX package's scales: router and wi N(0, 1/dim), wo N(0, 1/hidden)."""
    def normal(shape, scale):
        t = torch.empty(shape, device=device)
        t.normal_(0.0, 1.0, generator=generator)
        return (t * scale).to(dtype)
    return {"router": normal((dim, n_experts), 1.0 / math.sqrt(dim)),
            "wi": normal((n_experts, dim, hidden), 1.0 / math.sqrt(dim)),
            "wo": normal((n_experts, hidden, dim), 1.0 / math.sqrt(hidden))}


def _route_topk(logits: Tensor, capacity: int, k: int = 1
                ) -> Tuple[Tensor, Tensor, Tensor]:
    """Top-k router, capacity-bounded (k=1: Switch; k=2: Mixtral/GShard).

    Returns the ``[T, E, C]`` dispatch tensor (0/1), the ``[T, E, C]``
    combine tensor (dispatch weighted by each choice's gate) and the
    load-balancing aux loss ``E * sum_e f_e P_e`` (f_e the raw,
    pre-capacity fraction of assignments).  k=1 gates by the raw softmax
    probability, k>1 renormalizes the chosen gates to sum to 1.  Slots are
    granted choice-major: every token's first choice before any second
    choice.  Ties take the lowest expert index, as ``lax.top_k`` does."""
    T, E = logits.shape
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_vals, top_idx = vals[:, :k], idx[:, :k]
    if k > 1:
        gates = top_vals / top_vals.sum(-1, keepdim=True).clamp_min(1e-30)
    else:
        gates = top_vals
    # slot bookkeeping in fp32 whatever the logits' dtype: a bf16 cumsum
    # cannot count past 256, and slots on a hot expert would collide
    dev = logits.device
    disp = torch.zeros((T, E, capacity), dtype=torch.float32, device=dev)
    comb = torch.zeros((T, E, capacity), dtype=torch.float32, device=dev)
    raw_total = torch.zeros(E, dtype=torch.float32, device=dev)
    slot_base = torch.zeros((1, E), dtype=torch.float32, device=dev)
    gates32 = gates.float()
    slots = torch.arange(capacity, device=dev)
    for j in range(k):
        oh = Fn.one_hot(top_idx[:, j], E).float()
        raw_total = raw_total + oh.sum(0)
        # 1-based slot per (token, expert), past the earlier choices' claims
        position = slot_base + torch.cumsum(oh, dim=0) * oh
        within = (position >= 1) & (position <= capacity)
        ohk = oh * within
        slot = (position - 1).clamp_min(0).long()
        disp_j = ohk[:, :, None] * (slot[:, :, None] == slots).float()
        disp = disp + disp_j
        comb = comb + disp_j * gates32[:, j][:, None, None]
        slot_base = slot_base + oh.sum(0, keepdim=True)
    aux = E * torch.sum((raw_total / (T * k)) * probs.float().mean(0))
    return (disp.to(logits.dtype), comb.to(logits.dtype),
            aux.to(logits.dtype))


def _gelu(x: Tensor) -> Tensor:
    # jax.nn.gelu's default is the tanh approximation
    return Fn.gelu(x, approximate="tanh")


def _expert_ffn(wi: Tensor, wo: Tensor, x: Tensor) -> Tensor:
    """Per-expert MLP batched over the local experts: ``[El, S, D]``."""
    h = _gelu(torch.einsum("esd,edh->esh", x, wi))
    return torch.einsum("esh,ehd->esd", h, wo)


class _MeanAllReduce(torch.autograd.Function):
    """The mean over ``group``; the backward sums every rank's cotangent
    and divides by the size (the adjoint of the mean when each rank's loss
    holds its own copy of it)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out / dist.get_world_size(group)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g / dist.get_world_size(ctx.group), None


def make_moe_fn(group=None, n_experts: int = 8,
                capacity_factor: float = 1.25,
                experts_per_token: int = 1) -> Callable:
    """``apply(params, x) -> (y, aux)`` over ``group``: ``x`` ``[T, D]`` is
    this rank's token shard, ``params`` the router and this rank's experts
    (:func:`local_experts`).  ``aux`` is the Switch load-balancing term
    averaged over the group.  Capacity is ``ceil(T * k * capacity_factor /
    E)`` slots per expert, T the rank's tokens.  Differentiable end to
    end."""
    g = dist.group.WORLD if group is None else group
    ep = dist.get_world_size(g)
    if n_experts % ep:
        raise ValueError(f"n_experts={n_experts} not divisible by ep={ep}")
    e_local = n_experts // ep
    k = experts_per_token

    def apply(params: MoeParams, x: Tensor) -> Tuple[Tensor, Tensor]:
        T, D = x.shape
        capacity = int(np.ceil(T * k * capacity_factor / n_experts))
        disp, comb, aux = _route_topk(x @ params["router"], capacity, k=k)
        # tokens in their expert's slot, then to the expert's owner:
        # [ep, e_local, C, D] -> [ep (source), e_local, C, D]
        xd = torch.einsum("td,tec->ecd", x, disp)
        xd = all_to_all(xd.reshape(ep, e_local, capacity, D), 0, 0, g)
        # the sources into each expert's working set (transpose first: a
        # bare reshape would interleave experts across source chunks)
        xw = xd.transpose(0, 1).reshape(e_local, ep * capacity, D)
        yw = _expert_ffn(params["wi"], params["wo"], xw)
        yd = yw.reshape(e_local, ep, capacity, D).transpose(0, 1)
        yd = all_to_all(yd.contiguous(), 0, 0, g)
        y = torch.einsum("ecd,tec->td", yd.reshape(n_experts, capacity, D),
                         comb)
        if ep > 1:
            aux = _MeanAllReduce.apply(aux, g)
        return y, aux

    return apply


def moe_dense_reference(params: MoeParams, x: Tensor, n_experts: int,
                        capacity: int, experts_per_token: int = 1
                        ) -> Tuple[Tensor, Tensor]:
    """One-rank reference with the same routing: every token goes through
    its routed experts unless over capacity."""
    disp, comb, aux = _route_topk(x @ params["router"], capacity,
                                  k=experts_per_token)
    y_all = _gelu(torch.einsum("td,edh->teh", x, params["wi"]))
    y_all = torch.einsum("teh,ehd->ted", y_all, params["wo"])
    y = torch.einsum("ted,te->td", y_all, comb.sum(-1))
    return y, aux


def local_experts(params: MoeParams, group=None) -> MoeParams:
    """``params`` holding every expert, cut to this rank's share of
    ``group``: the router whole, wi/wo rows ``[r * E/ep, (r + 1) *
    E/ep)``."""
    g = dist.group.WORLD if group is None else group
    ep, r = dist.get_world_size(g), dist.get_rank(g)
    e_local = params["wi"].shape[0] // ep
    return {"router": params["router"],
            "wi": params["wi"][r * e_local:(r + 1) * e_local],
            "wo": params["wo"][r * e_local:(r + 1) * e_local]}


def _from_numpy(a: Any) -> Tensor:
    a = np.array(np.asarray(a), order="C")  # a writable copy
    if a.dtype.name == "bfloat16":  # ml_dtypes.bfloat16: torch cannot read it
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def moe_params_from_jax(tree: Dict[str, Any],
                        device: Union[str, torch.device, None] = None,
                        dtype: Optional[torch.dtype] = None) -> MoeParams:
    """A JAX ``init_moe_params`` tree (numpy arrays) as tensors, in the same
    layout."""
    out = {}
    for name in ("router", "wi", "wo"):
        t = _from_numpy(tree[name]).to(device)
        out[name] = t if dtype is None else t.to(dtype)
    return out


__all__ = ["init_moe_params", "make_moe_fn", "moe_dense_reference",
           "local_experts", "moe_params_from_jax"]
