"""3D parallelism: the (dp, tp, pp) composition and its knob surface, the
port of ``horovod_tpu/parallel/layout.py``.

The world factorizes into ``dp x tp x pp``: the ZeRO chain
(``parallel/zero.py``) runs over each rank's dp subgroup only, Megatron
tensor parallelism over tp, and the GPipe schedule (``parallel/pipeline.py``)
over pp.  Rank ``(i * tp + j) * pp + k`` holds coordinate (dp=i, tp=j,
pp=k), the JAX package's ordering of ``P(("dp", "tp", "pp"))``.  The cost
model (``perf/costmodel.solve_layout``) picks the factorization when
``HOROVOD_LAYOUT=auto``; ``runtime.init`` resolves the knob and builds the
subgroups (:func:`build_layout`), which every rank creates in the same
order.

Composition contract (the JAX package's, which the tests hold the port to):

  * Megatron's conjugate operators are autograd ``Function``s over the tp
    group: ``g`` is an all-reduce forward and the identity backward (after
    wo and w_down), ``f`` the identity forward and an all-reduce backward
    (at the column-parallel block inputs).  Every rank's activation
    cotangents are then the true ones, the tp-sliced weights' gradients are
    exact slices, and the tp-replicated leaves (norms, embedding, lm_head)
    get the same true gradient on every tp rank.
  * Each rank computes the loss; under pp the last stage's outputs are
    collected by a ``psum`` whose backward is a ``psum`` too, so
    ``scale_grad(1/pp)`` restores the true cotangent.
  * The one gradient fixup: only stage 0 feeds tokens in, so only its ranks
    produce the embedding's gradient, which is all-reduced over pp before
    its bucket is packed (the chain's ``fixup`` argument).
  * The ZeRO chain's geometry is per rank: bucket plans come from this
    rank's (tp, pp) slice of the parameters, its shards are 1/dp of them.

In the torch idiom a rank holds only its own slice: :class:`LayoutLlama` is
the Llama with this stage's layers (:class:`TPLayer`, each with this tp
rank's slices of the weights) beside the embedding, final norm and lm_head,
and :func:`slice_llama` / :func:`layout_params_from_jax` build it from a
full model or a JAX parameter tree.  Dense weights are ``[out, in]`` as in
``models/llama.py``: column-parallel wq/wk/wv/w_gate/w_up split dim 0,
row-parallel wo/w_down dim 1.  The JAX package's specs
(:func:`llama_layout_specs`) describe its ``[in, out]`` kernels and are kept
in its order.  Attention is ``layers.causal_attention`` unless an
``attn_fn`` is given (on the card, ``ops.flash_attention``).

``resolve_layout``'s ``auto`` sets the ``hvd_layout_candidates``,
``hvd_layout_chosen_rank`` and ``hvd_layout_predicted_step_seconds``
gauges, as the JAX function does.  ``layout_of_mesh`` becomes
:func:`layout_of_runtime`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from .. import runtime as _rt
from ..common.reduce_op import Average, ReduceOp
from ..models import layers as L
from ..models.llama import (Dense, Llama, LlamaConfig, RMSNorm,
                            params_from_jax)
from ..perf import costmodel as _cm
from . import zero as _zero
from .pipeline import _spmd_pipeline, stack_stage_params

Tensor = torch.Tensor
LAYOUT_AXES = ("dp", "tp", "pp")
LAYOUT_VALUES = ("", "auto", "dp-only")
Dims = Tuple[int, int, int]


# ------------------------------------------------------------ knob surface
def _parse_explicit(value: str) -> Optional[Dims]:
    parts = [p.strip() for p in value.split(",")]
    if len(parts) != 3 or not all(p.isdigit() for p in parts):
        return None
    return tuple(int(p) for p in parts)  # type: ignore[return-value]


def validate_layout_knobs(knobs, world: Optional[int] = None,
                          mesh_spec: str = "") -> None:
    """Fail at init on invalid layout knob values (``runtime.init``, before
    the subgroups are built).  ``mesh_spec`` is an explicit layout that
    would conflict with the knob (the port has no mesh knob: its runtime
    passes none)."""
    value = str(knobs["HOROVOD_LAYOUT"]).strip()
    tp = int(knobs["HOROVOD_TP"])
    pp = int(knobs["HOROVOD_PP"])
    if tp < 0 or pp < 0:
        raise ValueError(
            f"HOROVOD_TP={tp} / HOROVOD_PP={pp} invalid; the parallel "
            "degrees must be >= 0 (0 = let the solver pick)")
    explicit = _parse_explicit(value) if value else None
    if value and value not in LAYOUT_VALUES and explicit is None:
        raise ValueError(
            f"HOROVOD_LAYOUT={value!r} invalid; use 'auto', 'dp-only' or "
            "an explicit 'dp,tp,pp' triple")
    if value and mesh_spec:
        raise ValueError(
            f"HOROVOD_LAYOUT={value!r} and an explicit mesh spec "
            f"({mesh_spec!r}) both claim the layout; set one")
    if not value and (tp > 1 or pp > 1):
        raise ValueError(
            f"HOROVOD_TP={tp} / HOROVOD_PP={pp} have no effect without "
            "HOROVOD_LAYOUT (set HOROVOD_LAYOUT=auto to constrain the "
            "solver, or an explicit 'dp,tp,pp')")
    if value == "dp-only" and (tp > 1 or pp > 1):
        raise ValueError(
            f"HOROVOD_LAYOUT=dp-only conflicts with HOROVOD_TP={tp} / "
            f"HOROVOD_PP={pp}")
    if explicit is not None:
        d, t, p = explicit
        if min(explicit) < 1:
            raise ValueError(
                f"HOROVOD_LAYOUT={value!r} invalid; every factor of the "
                "'dp,tp,pp' triple must be >= 1")
        if tp > 1 and tp != t:
            raise ValueError(
                f"HOROVOD_TP={tp} contradicts HOROVOD_LAYOUT={value!r}")
        if pp > 1 and pp != p:
            raise ValueError(
                f"HOROVOD_PP={pp} contradicts HOROVOD_LAYOUT={value!r}")
        if world is not None and d * t * p != world:
            raise ValueError(
                f"HOROVOD_LAYOUT={value!r} covers {d * t * p} ranks but the "
                f"world has {world} (dp*tp*pp must equal the world size)")
    if world is not None:
        for name, deg in (("HOROVOD_TP", tp), ("HOROVOD_PP", pp)):
            if deg > 1 and world % deg:
                raise ValueError(
                    f"{name}={deg} does not divide the world size {world}")
        if tp > 1 and pp > 1 and world % (tp * pp):
            raise ValueError(
                f"HOROVOD_TP={tp} x HOROVOD_PP={pp} does not divide the "
                f"world size {world}")


def resolve_layout(world: int, knobs=None, *,
                   model: Optional[Dict[str, Any]] = None,
                   mem_cap_bytes: Optional[float] = None,
                   chip: str = "cpu", link: str = "loopback"
                   ) -> Optional[Dims]:
    """The (dp, tp, pp) triple ``HOROVOD_LAYOUT`` resolves to at ``world``
    ranks, or None when the knob is unset (the flat data-parallel group).

    ``auto`` runs :func:`perf.costmodel.solve_layout` against ``model``
    when the caller knows it, priced on ``chip`` and ``link``, else against
    a topology-only descriptor where every factorization is admissible and
    the zero-FLOP tie-break prefers pure dp; constrained to HOROVOD_TP /
    HOROVOD_PP when set."""
    if knobs is None:
        from ..common.knobs import current
        knobs = {name: current(name) for name in (
            "HOROVOD_LAYOUT", "HOROVOD_TP", "HOROVOD_PP",
            "HOROVOD_ZERO_LEVEL")}
    value = str(knobs["HOROVOD_LAYOUT"]).strip()
    tp_knob = int(knobs["HOROVOD_TP"])
    pp_knob = int(knobs["HOROVOD_PP"])
    level = int(knobs["HOROVOD_ZERO_LEVEL"])
    if not value:
        return None
    if value == "dp-only":
        return (world, 1, 1)
    explicit = _parse_explicit(value)
    if explicit is not None:
        if int(np.prod(explicit)) != world:
            raise ValueError(
                f"HOROVOD_LAYOUT={value!r} covers "
                f"{int(np.prod(explicit))} ranks but the world has {world}")
        return explicit
    if model is None:  # topology only: nothing to price
        model = {"n_params": 0, "n_heads": world, "n_kv_heads": world,
                 "n_layers": world, "batch": world, "dim": 0, "seq": 1,
                 "flops_per_step": 0.0}
    sol = _cm.solve_layout(model, world, mem_cap_bytes=mem_cap_bytes,
                           levels=(level,) if level in (1, 2, 3) else (1,),
                           chip=chip, link=link)
    chosen = None
    for row in sol["candidates"]:
        lay = row["layout"]
        if tp_knob > 1 and lay["tp"] != tp_knob:
            continue
        if pp_knob > 1 and lay["pp"] != pp_knob:
            continue
        chosen = row
        break
    if chosen is None:
        raise ValueError(
            f"HOROVOD_LAYOUT=auto found no valid layout at world={world} "
            f"under HOROVOD_TP={tp_knob} / HOROVOD_PP={pp_knob}")
    from ..utils import metrics as M
    M.LAYOUT_CANDIDATES.set(sol["n_candidates"])
    M.LAYOUT_CHOSEN_RANK.set(chosen["rank"])
    M.LAYOUT_PREDICTED_STEP.set(chosen["step_s"])
    lay = chosen["layout"]
    return (lay["dp"], lay["tp"], lay["pp"])


def layout_mesh_spec(dp: int, tp: int, pp: int) -> str:
    """The layout as the JAX package's mesh spec string."""
    return f"dp={dp},tp={tp},pp={pp}"


# ------------------------------------------------------- process subgroups
def layout_rank(coord: Dims, dims: Dims) -> int:
    """Global rank of coordinate (dp=i, tp=j, pp=k): ``(i*tp + j)*pp + k``."""
    (i, j, k), (_, tp, pp) = coord, dims
    return (i * tp + j) * pp + k


def layout_coord(rank: int, dims: Dims) -> Dims:
    """(dp, tp, pp) coordinate of a global rank."""
    _, tp, pp = dims
    return rank // (tp * pp), (rank // pp) % tp, rank % pp


@dataclasses.dataclass
class ProcessLayout:
    """This rank's place in a (dp, tp, pp) layout: the sizes, its
    coordinate, and its three subgroups with their global ranks (a
    subgroup's rank order is its axis index)."""
    dims: Dims
    coord: Dims
    groups: Dict[str, Any]
    ranks: Dict[str, List[int]]

    @property
    def dp(self) -> int:
        return self.dims[0]

    @property
    def tp(self) -> int:
        return self.dims[1]

    @property
    def pp(self) -> int:
        return self.dims[2]


def build_layout(dp: int, tp: int, pp: int) -> ProcessLayout:
    """The subgroups of a (dp, tp, pp) layout of the world.  Every rank
    must call it, in the same order: it creates every dp group (one per
    (tp, pp) coordinate), then every tp group, then every pp group, as
    ``dist.new_group`` requires."""
    world, rank = dist.get_world_size(), dist.get_rank()
    dims = (int(dp), int(tp), int(pp))
    if min(dims) < 1 or dp * tp * pp != world:
        raise ValueError(f"layout {dims} does not factor the world size "
                         f"{world}")
    grid = np.arange(world).reshape(dims)  # rank at [i, j, k]
    groups: Dict[str, Any] = {}
    ranks: Dict[str, List[int]] = {}
    for axis, name in enumerate(LAYOUT_AXES):
        for members in np.moveaxis(grid, axis, -1).reshape(
                -1, dims[axis]).tolist():
            group = dist.new_group(members)
            if rank in members:
                groups[name], ranks[name] = group, members
    return ProcessLayout(dims, layout_coord(rank, dims), groups, ranks)


def release_layout(layout: ProcessLayout) -> None:
    """Destroy this rank's subgroups of ``layout`` (each NCCL communicator
    holds device memory).  Every member must call it, after its last
    collective on them; the runtime's own layout stays until shutdown."""
    for group in layout.groups.values():
        dist.destroy_process_group(group)
    layout.groups.clear()


def layout_of_runtime() -> Dims:
    """(dp, tp, pp) of the runtime's layout; raises when ``HOROVOD_LAYOUT``
    was unset at init (the flat data-parallel group has no layout)."""
    return runtime_layout().dims


def runtime_layout() -> ProcessLayout:
    rt = _rt.get()
    if rt.layout is None:
        raise ValueError(
            "the runtime has no (dp, tp, pp) layout; layout train steps need "
            "the layout HOROVOD_LAYOUT resolves at init, or a "
            "ProcessLayout from build_layout")
    return rt.layout


def _resolve(layout: Optional[ProcessLayout]) -> ProcessLayout:
    return layout if layout is not None else runtime_layout()


# ------------------------------------------- Megatron conjugate operators
class _GPsum(torch.autograd.Function):
    """Megatron's ``g``: all-reduce forward (completes a row-parallel
    matmul), identity backward."""

    @staticmethod
    def forward(ctx, x: Tensor, group) -> Tensor:
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g: Tensor):
        return g, None


class _FCopy(torch.autograd.Function):
    """Megatron's ``f``: identity forward (the input is replicated over
    tp), all-reduce backward (each rank's cotangent is the contribution
    through its weight slice; the sum is the true cotangent)."""

    @staticmethod
    def forward(ctx, x: Tensor, group) -> Tensor:
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g: Tensor):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ScaleGrad(torch.autograd.Function):
    """Identity forward, cotangent scaled by ``s`` backward."""

    @staticmethod
    def forward(ctx, x: Tensor, s: float) -> Tensor:
        ctx.s = s
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g: Tensor):
        return g * ctx.s, None


def g_psum(x: Tensor, group) -> Tensor:
    return _GPsum.apply(x, group)


def f_copy(x: Tensor, group) -> Tensor:
    return _FCopy.apply(x, group)


def scale_grad(x: Tensor, s: float) -> Tensor:
    return _ScaleGrad.apply(x, s)


# ------------------------------------------------- llama family realization
COLUMN = ("wq", "wk", "wv", "w_gate", "w_up")
ROW = ("wo", "w_down")


class TPLayer(nn.Module):
    """One Llama layer holding this tp rank's slices: ``n_heads / tp`` query
    heads, ``n_kv_heads / tp`` kv heads and ``ffn_dim / tp`` ffn columns
    (the JAX package's ``_tp_apply_layer``).  The head dim is the config's
    (``dim / n_heads``): the weights are sliced, not the config.  At tp = 1
    it is op for op ``llama.LlamaLayer``."""

    def __init__(self, cfg: LlamaConfig, tp: int, device,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        pcfg = cfg if dtype is None else dataclasses.replace(cfg, dtype=dtype)
        d, hd = cfg.dim, cfg.head_dim
        self.cfg, self.tp = cfg, tp
        self.n_heads, self.n_kv_heads = cfg.n_heads // tp, cfg.n_kv_heads // tp
        ffn = cfg.ffn_dim // tp
        self.attn_norm = RMSNorm(d, pcfg, device)
        self.wq = Dense(d, self.n_heads * hd, pcfg, device)
        self.wk = Dense(d, self.n_kv_heads * hd, pcfg, device)
        self.wv = Dense(d, self.n_kv_heads * hd, pcfg, device)
        self.wo = Dense(self.n_heads * hd, d, pcfg, device)
        self.ffn_norm = RMSNorm(d, pcfg, device)
        self.w_gate = Dense(d, ffn, pcfg, device)
        self.w_up = Dense(d, ffn, pcfg, device)
        self.w_down = Dense(ffn, d, pcfg, device)

    def _attn(self, x: Tensor, cos: Tensor, sin: Tensor, attn_fn,
              pos_offset: int, group) -> Tensor:
        B, S, _ = x.shape
        hd = self.cfg.head_dim
        q = self.wq(x).reshape(B, S, self.n_heads, hd)
        k = self.wk(x).reshape(B, S, self.n_kv_heads, hd)
        v = self.wv(x).reshape(B, S, self.n_kv_heads, hd)
        q = L.apply_rope(q, cos, sin, offset=pos_offset)
        k = L.apply_rope(k, cos, sin, offset=pos_offset)
        if attn_fn is None:
            o = L.causal_attention(q, k, v, causal=True)
        else:
            o = attn_fn(q, k, v)
        o = self.wo(o.reshape(B, S, self.n_heads * hd))
        return g_psum(o, group) if group is not None else o

    def _ffn(self, x: Tensor, group) -> Tensor:
        h = self.w_down(torch.nn.functional.silu(self.w_gate(x))
                        * self.w_up(x))
        return g_psum(h, group) if group is not None else h

    def forward(self, x: Tensor, cos: Tensor, sin: Tensor,
                attn_fn: Optional[Callable] = None, pos_offset: int = 0,
                group=None) -> Tensor:
        """``group``: the tp group (None at tp = 1)."""
        a_in = self.attn_norm(x)
        if group is not None:
            a_in = f_copy(a_in, group)
        x = x + self._attn(a_in, cos, sin, attn_fn, pos_offset, group)
        f_in = self.ffn_norm(x)
        if group is not None:
            f_in = f_copy(f_in, group)
        return x + self._ffn(f_in, group)


class LayoutLlama(nn.Module):
    """This rank's part of the Llama under a (dp, tp, pp) layout: the
    embedding, the ``n_layers / pp`` layers of stage ``k`` (each a
    :class:`TPLayer` with tp slice ``j``), the final norm and the lm_head,
    in ``llama.Llama``'s parameter order.  ``dtype`` is the parameters'
    (default ``cfg.dtype``, which stays the activations' dtype).

    ``forward`` takes ``llama.Llama.forward``'s arguments, so
    ``llama.loss_fn`` runs on it; the pipeline's microbatch count
    (``n_micro``) and the subgroups (``process_layout``) are attributes the
    step builder sets.  Parameters are left uninitialized: build with
    :func:`slice_llama` or :func:`layout_params_from_jax`."""

    def __init__(self, cfg: LlamaConfig, coord: Dims, dims: Dims,
                 device=None, dtype: Optional[torch.dtype] = None):
        super().__init__()
        _check_divisible(cfg, dims)
        device = _rt.resolve_device(device)
        pcfg = cfg if dtype is None else dataclasses.replace(cfg, dtype=dtype)
        self.cfg, self.coord, self.dims = cfg, tuple(coord), tuple(dims)
        self.n_micro = 1
        self.process_layout: Optional[ProcessLayout] = None
        self.embed = nn.Module()
        self.embed.table = nn.Parameter(torch.empty(
            (cfg.vocab, cfg.dim), dtype=pcfg.dtype, device=device))
        self.layers = nn.ModuleList(
            TPLayer(cfg, dims[1], device, dtype)
            for _ in range(cfg.n_layers // dims[2]))
        self.final_norm = RMSNorm(cfg.dim, pcfg, device)
        self.lm_head = Dense(cfg.dim, cfg.vocab, pcfg, device)

    def _group(self, axis: str):
        if self.dims[LAYOUT_AXES.index(axis)] == 1:
            return None
        if self.process_layout is None:
            raise ValueError(f"a LayoutLlama at {axis}="
                             f"{self.dims[LAYOUT_AXES.index(axis)]} needs "
                             "its process_layout (the step builder sets it)")
        return self.process_layout.groups[axis]

    def forward(self, ids: Tensor, attn_fn: Optional[Callable] = None,
                remat: bool = False, return_hidden: bool = False,
                pos_offset: int = 0) -> Tensor:
        """Token ids ``[B, S]`` -> logits ``[B, S, vocab]`` (or the final
        norm's hidden states), the same on every rank of the layout's
        (tp, pp) coordinates: the layers through the TP blocks, and under
        pp through the GPipe schedule in ``n_micro`` microbatches (the JAX
        package's ``_llama_local_loss`` up to the loss)."""
        cfg = self.cfg
        tp_group, pp_group = self._group("tp"), self._group("pp")
        cos, sin = L.rope_freqs(cfg.head_dim, cfg.max_seq, cfg.rope_theta,
                                device=ids.device)
        x = L.embedding(self.embed.table, ids).to(cfg.dtype)

        def stage_fn(h: Tensor) -> Tensor:
            for layer in self.layers:
                if remat:
                    h = checkpoint(layer, h, cos, sin, attn_fn, pos_offset,
                                   tp_group, use_reentrant=False)
                else:
                    h = layer(h, cos, sin, attn_fn, pos_offset, tp_group)
            return h

        pp = self.dims[2]
        if pp > 1:
            B = x.shape[0]
            m = _cm._effective_microbatches(B, self.n_micro)
            xm = x.reshape((m, B // m) + tuple(x.shape[1:]))
            h = _spmd_pipeline(stage_fn, xm, m, pp_group)
            h = scale_grad(h, 1.0 / pp)
            x = h.reshape((B,) + tuple(h.shape[2:]))
        else:
            x = stage_fn(x)
        x = self.final_norm(x)
        if return_hidden:
            return x
        return self.lm_head(x)


def _check_divisible(cfg: LlamaConfig, dims: Dims) -> None:
    _, tp, pp = dims
    if cfg.n_heads % tp or cfg.n_kv_heads % tp or cfg.ffn_dim % tp:
        raise ValueError(
            f"tp={tp} must divide n_heads={cfg.n_heads}, n_kv_heads="
            f"{cfg.n_kv_heads} and ffn_dim={cfg.ffn_dim} (contiguous GQA "
            "head slices)")
    if cfg.n_layers % pp:
        raise ValueError(f"pp={pp} must divide n_layers={cfg.n_layers}")


def _tp_slice(name: str, t: Tensor, j: int, tp: int) -> Tensor:
    """Tp slice ``j`` of a full layer weight named ``name`` (``[out, in]``):
    column-parallel weights split dim 0, row-parallel ones dim 1."""
    if tp == 1 or name not in COLUMN + ROW:
        return t
    dim = 0 if name in COLUMN else 1
    n = t.shape[dim] // tp
    return t.narrow(dim, j * n, n)


@torch.no_grad()
def slice_llama(model, coord: Dims, dims: Dims, device=None) -> LayoutLlama:
    """Rank ``coord``'s :class:`LayoutLlama` of a full ``llama.Llama``
    (copies, in the model's parameter dtype and on ``device``, by default
    the model's)."""
    device = device if device is not None else model.embed.table.device
    out = LayoutLlama(model.cfg, coord, dims, device=device,
                      dtype=model.embed.table.dtype)
    _, j, k = coord
    _, tp, pp = dims
    per = model.cfg.n_layers // pp
    out.embed.table.copy_(model.embed.table)
    out.final_norm.scale.copy_(model.final_norm.scale)
    out.lm_head.weight.copy_(model.lm_head.weight)
    for mine, full in zip(out.layers, model.layers[k * per:(k + 1) * per]):
        for name, sub in mine.named_children():
            src = getattr(full, name)
            for pname, p in sub.named_parameters():
                p.copy_(_tp_slice(name, getattr(src, pname), j, tp))
    return out


def layout_params_from_jax(tree: Dict[str, Any], cfg: LlamaConfig,
                           coord: Dims, layout: Dims,
                           device=None) -> LayoutLlama:
    """Rank ``coord``'s :class:`LayoutLlama` holding the weights of a JAX
    ``llama.init`` tree given as numpy arrays: the tree through
    ``llama.params_from_jax`` on the CPU, then :func:`slice_llama` of it
    onto ``device``."""
    full = params_from_jax(tree, cfg, device="cpu")
    return slice_llama(full, coord, layout,
                       device=_rt.resolve_device(device))


# ------------------------------------------- the JAX-form trees and specs
def _tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def llama_layout_params(params: Dict[str, Any], pp: int) -> Dict[str, Any]:
    """Restack a JAX ``llama.init`` tree (numpy arrays or tensors) into the
    layout form ``{"embed", "final_norm", "lm_head", "stages"}``, every
    stage leaf stacked ``[pp, n_layers/pp, ...]``.  No tp slicing."""
    layers = params["layers"]
    n_layers = len(layers)
    if n_layers % pp:
        raise ValueError(f"n_layers={n_layers} not divisible by pp={pp}")
    per = n_layers // pp
    groups = [stack_stage_params(layers[s * per:(s + 1) * per])
              for s in range(pp)]
    return {"embed": params["embed"], "final_norm": params["final_norm"],
            "lm_head": params["lm_head"],
            "stages": stack_stage_params(groups)}


def llama_layout_specs(stacked: Dict[str, Any]) -> Dict[str, Any]:
    """The specs of the stacked JAX-form tree, one tuple of axis names (or
    None) per dim: column-parallel wq/wk/wv/w_gate/w_up split their out dim
    (the last of ``[pp, L/pp, in, out]``) over tp, row-parallel wo/w_down
    their in dim, every stage leaf dim 0 over pp; embed, final_norm and
    lm_head replicate (``()``)."""
    def stage_spec(name: str, leaf_name: str, leaf) -> Tuple:
        if name in COLUMN and leaf_name == "kernel":
            return ("pp", None, None, "tp")
        if name in ROW and leaf_name == "kernel":
            return ("pp", None, "tp", None)
        return ("pp",) + (None,) * (np.ndim(leaf) - 1)

    stages = {name: {leaf: stage_spec(name, leaf, a)
                     for leaf, a in sub.items()}
              for name, sub in stacked["stages"].items()}
    repl = lambda sub: _tree_map(lambda _: (), sub)  # noqa: E731
    return {"embed": repl(stacked["embed"]),
            "final_norm": repl(stacked["final_norm"]),
            "lm_head": repl(stacked["lm_head"]), "stages": stages}


def llama_layout_template(cfg: LlamaConfig, pp: int) -> Dict[str, Any]:
    """The stacked JAX-form tree's shapes as meta tensors (fp32), the
    source of local shapes when no parameters are at hand."""
    hd = cfg.head_dim

    def t(*shape):
        return torch.empty(shape, dtype=torch.float32, device="meta")
    layer = {"attn_norm": {"scale": t(cfg.dim)},
             "ffn_norm": {"scale": t(cfg.dim)},
             "wq": {"kernel": t(cfg.dim, cfg.n_heads * hd)},
             "wk": {"kernel": t(cfg.dim, cfg.n_kv_heads * hd)},
             "wv": {"kernel": t(cfg.dim, cfg.n_kv_heads * hd)},
             "wo": {"kernel": t(cfg.n_heads * hd, cfg.dim)},
             "w_gate": {"kernel": t(cfg.dim, cfg.ffn_dim)},
             "w_up": {"kernel": t(cfg.dim, cfg.ffn_dim)},
             "w_down": {"kernel": t(cfg.ffn_dim, cfg.dim)}}
    params = {"embed": {"table": t(cfg.vocab, cfg.dim)},
              "final_norm": {"scale": t(cfg.dim)},
              "lm_head": {"kernel": t(cfg.dim, cfg.vocab)},
              "layers": [layer] * cfg.n_layers}
    return llama_layout_params(params, pp)


def _broadcast_specs(specs: Any, tree: Any) -> Any:
    """Expand a spec prefix (one tuple for a whole subtree) to one spec per
    leaf of ``tree``."""
    if isinstance(specs, tuple):
        return _tree_map(lambda _: specs, tree)
    if isinstance(tree, dict):
        return {k: _broadcast_specs(specs[k], tree[k]) for k in tree}
    return type(tree)(_broadcast_specs(s, t) for s, t in zip(specs, tree))


def _local_template(template: Any, specs: Any, dims: Dims) -> Any:
    """Per-rank shapes of ``template`` under ``specs``: each sharded dim
    divided by its axis size (meta tensors)."""
    sizes = dict(zip(LAYOUT_AXES, dims))

    def one(leaf, spec):
        shape = list(leaf.shape)
        for d, axes in enumerate(spec):
            if axes is None:
                continue
            for a in (axes if isinstance(axes, tuple) else (axes,)):
                if shape[d] % sizes[a]:
                    raise ValueError(
                        f"dim {d} of shape {tuple(leaf.shape)} not divisible "
                        f"by axis {a}={sizes[a]}")
                shape[d] //= sizes[a]
        return torch.empty(shape, dtype=leaf.dtype, device="meta")

    return _tree_map(one, template, _broadcast_specs(specs, template))


# ----------------------------------------------------- sharded state plumbing
def init_layout_state(optimizer: type, model: nn.Module,
                      zero_level: Optional[int] = None, wire_policy=None,
                      error_feedback: Optional[bool] = None,
                      fusion_threshold_bytes: Any = None,
                      layout: Optional[ProcessLayout] = None,
                      **optimizer_kwargs) -> _zero.ZeroState:
    """ZeRO state for the composed chain: this rank's optimizer state of
    its 1/dp shard of its (tp, pp) slice (``model``), the chain's state
    (``zero.init_zero_state``) on the layout's dp group.  At tp = pp = 1 it
    is ``init_zero_state``'s."""
    level = _zero.resolve_zero_level(zero_level)
    if level == 0:
        raise ValueError("zero_level=0 is plain data parallelism: build the "
                         "inner optimizer directly")
    return _zero.init_zero_state(
        optimizer, model, zero_level=level, wire_policy=wire_policy,
        error_feedback=error_feedback,
        fusion_threshold_bytes=fusion_threshold_bytes,
        group=_resolve(layout).groups["dp"], **optimizer_kwargs)


def shard_layout_params(model: nn.Module, fusion_threshold_bytes: Any = None,
                        layout: Optional[ProcessLayout] = None
                        ) -> List[Tensor]:
    """The level-3 resident layout of the composed chain: per bucket this
    rank's 1/dp fp32 shard of its (tp, pp) slice."""
    return _zero.shard_zero3_params(model, fusion_threshold_bytes,
                                    group=_resolve(layout).groups["dp"])


@torch.no_grad()
def gather_layout_params(model: LayoutLlama,
                         shards: Optional[List[Tensor]] = None,
                         fusion_threshold_bytes: Any = None,
                         layout: Optional[ProcessLayout] = None
                         ) -> Dict[str, Tensor]:
    """The full Llama's parameters, ``{llama.Llama parameter name:
    tensor}`` in its order, on every rank: the level-3 ``shards`` gathered
    over dp when given (else the module's own parameters), then the tp
    slices and the pp stages stitched back together."""
    lay = _resolve(layout)
    names = [n for n, _ in model.named_parameters()]
    if shards is not None:
        local = _zero.gather_zero3_params(shards, model,
                                          fusion_threshold_bytes,
                                          group=lay.groups["dp"])
    else:
        local = [p.detach() for p in model.parameters()]
    _, tp, pp = lay.dims
    per = model.cfg.n_layers // pp
    out: Dict[str, Tensor] = {}
    for name, t in zip(names, local):
        parts = name.split(".")
        if parts[0] != "layers":
            out[name] = t
            continue
        if tp > 1 and parts[2] in COLUMN + ROW:
            pieces = [torch.empty_like(t) for _ in range(tp)]
            dist.all_gather(pieces, t.contiguous(), group=lay.groups["tp"])
            t = torch.cat(pieces, dim=0 if parts[2] in COLUMN else 1)
        pieces = [t]
        if pp > 1:
            pieces = [torch.empty_like(t) for _ in range(pp)]
            dist.all_gather(pieces, t.contiguous(), group=lay.groups["pp"])
        for s, piece in enumerate(pieces):
            parts[1] = str(s * per + int(name.split(".")[1]))
            out[".".join(parts)] = piece
    full = Llama(model.cfg, device="meta")
    return {n: out[n] for n, _ in full.named_parameters()}


# ------------------------------------------------------------- step builders
def _make_composed_step(model: nn.Module, local_loss: Callable,
                        state: _zero.ZeroState, layout: ProcessLayout, *,
                        op: ReduceOp, zero_level: Optional[int],
                        wire_policy, error_feedback: Optional[bool],
                        backward_passes_per_step: int,
                        ag_prefetch: Optional[int],
                        fusion_threshold_bytes: Any,
                        compute_dtype: Optional[torch.dtype],
                        fixup: Optional[Callable]) -> Callable:
    """The ZeRO chain (``zero.make_zero_train_step``) re-seated on the
    layout's dp group: ``local_loss`` runs on this rank (its own
    collectives over tp and pp inside), ``fixup`` applies the family's
    gradient correction before each bucket is packed, and every formula of
    the chain has n = dp.  The chain checks the state against the layout
    it was built for."""
    level = _zero.resolve_zero_level(zero_level)
    if level == 0:
        raise ValueError(
            "zero_level=0 is plain data parallelism; the composed chain "
            "shards the weight update over dp (use level 1-3)")
    if op != Average:
        raise ValueError("the composed chain reduces with Average "
                         "(gradient mean); prescale for other semantics")
    return _zero.make_zero_train_step(
        model, local_loss, state, op=op, zero_level=level, interleaved=True,
        wire_policy=wire_policy, error_feedback=error_feedback,
        backward_passes_per_step=backward_passes_per_step,
        ag_prefetch=ag_prefetch,
        fusion_threshold_bytes=fusion_threshold_bytes,
        compute_dtype=compute_dtype, group=layout.groups["dp"], fixup=fixup)


def make_layout_train_step(model: nn.Module, loss_fn: Callable,
                           state: _zero.ZeroState,
                           layout: Optional[ProcessLayout] = None,
                           op: ReduceOp = Average,
                           zero_level: Optional[int] = None,
                           wire_policy=None,
                           error_feedback: Optional[bool] = None,
                           backward_passes_per_step: int = 1,
                           ag_prefetch: Optional[int] = None,
                           fusion_threshold_bytes: Any = None,
                           compute_dtype: Optional[torch.dtype] = None
                           ) -> Callable:
    """The composed step for a generic loss whose parameters are
    replicated over tp and pp: ``loss_fn(model, *batch)``; the chain runs
    over each (tp, pp) coordinate's dp group, and every coordinate computes
    the same update.  ``step(*batch) -> loss`` takes this rank's dp shard
    of the rows.  Model-sliced TP/PP needs
    :func:`make_llama_layout_train_step`."""
    return _make_composed_step(
        model, loss_fn, state, _resolve(layout), op=op,
        zero_level=zero_level, wire_policy=wire_policy,
        error_feedback=error_feedback,
        backward_passes_per_step=backward_passes_per_step,
        ag_prefetch=ag_prefetch,
        fusion_threshold_bytes=fusion_threshold_bytes,
        compute_dtype=compute_dtype, fixup=None)


def _llama_grad_fixup(model: LayoutLlama, layout: ProcessLayout):
    """The embedding's gradient all-reduced over pp (only stage 0 produces
    it); every other leaf's gradient is already true."""
    if layout.pp == 1:
        return None
    index = [p is model.embed.table for p in model.parameters()].index(True)
    group = layout.groups["pp"]

    def fixup(i: int, grad: Tensor) -> Tensor:
        if i == index:
            dist.all_reduce(grad, group=group)
        return grad
    return fixup


def make_llama_layout_train_step(model: LayoutLlama, state: _zero.ZeroState,
                                 n_micro: int = 4,
                                 layout: Optional[ProcessLayout] = None,
                                 op: ReduceOp = Average,
                                 zero_level: Optional[int] = None,
                                 wire_policy=None,
                                 error_feedback: Optional[bool] = None,
                                 backward_passes_per_step: int = 1,
                                 ag_prefetch: Optional[int] = None,
                                 fusion_threshold_bytes: Any = None,
                                 compute_dtype: Optional[torch.dtype] = None,
                                 attn_fn: Optional[Callable] = None,
                                 ce_chunks: int = 0) -> Callable:
    """The Llama composed step: Megatron TP over tp, GPipe over pp in
    ``n_micro`` microbatches, the ZeRO chain over dp.  ``model`` is this
    rank's :class:`LayoutLlama`, ``state`` from :func:`init_layout_state`
    with the same level, wire and EF settings.  ``step(ids) -> loss``:
    ``ids`` ``[rows, seq + 1]`` (``[k, rows, seq + 1]`` with
    ``backward_passes_per_step = k > 1``) are the rows of this rank's dp
    index, the same on every (tp, pp) coordinate of it; the loss is the
    dp mean.  ``attn_fn`` and ``ce_chunks`` are ``llama.loss_fn``'s."""
    lay = _resolve(layout)
    cfg = model.cfg
    dp, tp, pp = lay.dims
    if cfg.n_heads % tp or cfg.n_kv_heads % tp:
        raise ValueError(
            f"tp={tp} must divide n_heads={cfg.n_heads} AND n_kv_heads="
            f"{cfg.n_kv_heads} (contiguous GQA head slices)")
    if cfg.n_layers % pp:
        raise ValueError(f"pp={pp} must divide n_layers={cfg.n_layers}")
    if model.dims != lay.dims or model.coord != lay.coord:
        raise ValueError(
            f"the model is coordinate {model.coord} of layout {model.dims}; "
            f"this rank is {lay.coord} of {lay.dims}")
    model.process_layout, model.n_micro = lay, int(n_micro)
    from ..models.llama import loss_fn

    def local_loss(m, ids):
        return loss_fn(m, ids, attn_fn=attn_fn, ce_chunks=ce_chunks)
    return _make_composed_step(
        model, local_loss, state, lay, op=op, zero_level=zero_level,
        wire_policy=wire_policy, error_feedback=error_feedback,
        backward_passes_per_step=backward_passes_per_step,
        ag_prefetch=ag_prefetch,
        fusion_threshold_bytes=fusion_threshold_bytes,
        compute_dtype=compute_dtype, fixup=_llama_grad_fixup(model, lay))


__all__ = [
    "LAYOUT_AXES", "LAYOUT_VALUES", "validate_layout_knobs",
    "resolve_layout", "layout_mesh_spec", "layout_of_runtime",
    "runtime_layout", "build_layout", "release_layout", "ProcessLayout",
    "layout_rank",
    "layout_coord", "g_psum", "f_copy", "scale_grad", "TPLayer",
    "LayoutLlama", "slice_llama", "layout_params_from_jax",
    "llama_layout_params", "llama_layout_specs", "llama_layout_template",
    "init_layout_state", "shard_layout_params", "gather_layout_params",
    "make_layout_train_step", "make_llama_layout_train_step",
]
