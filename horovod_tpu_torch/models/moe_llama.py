"""MoE decoder: Llama attention blocks with switch-MoE FFNs, the port of
``horovod_tpu/models/moe_llama.py`` (``MoeLlamaConfig``, ``CONFIGS``,
``init``, ``apply`` as ``MoeLlama.forward``, ``loss_fn``, ``param_count``)
as an ``nn.Module``.

A layer's attention half is the port's Llama attention
(``llama.LlamaLayer``, with the same ``attn_fn`` and ``pos_offset``); its
FFN half is the MoE block of ``parallel/expert.py``, dense on one rank by
default (``moe_dense_reference``) or expert-parallel through an injected
``moe_fn`` (``expert.make_moe_fn``), over the same ``{router, wi, wo}``
parameters: a model built with ``ep_size`` ranks holds its rank's experts
only (:func:`shard_experts`).

The serving half of the JAX module (``apply_cached``, ``init_cache``,
``copy_blocks``, ``dropfree_moe_fn``) is not ported yet (ROADMAP queue 1
item 7).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch
import torch.distributed as dist
import torch.nn as nn

from .. import runtime as _rt
from ..parallel import expert as _ep
from . import layers as L
from . import llama as Ll

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class MoeLlamaConfig:
    vocab: int = 4096
    dim: int = 256
    n_layers: int = 4
    n_heads: int = 8
    n_kv_heads: int = 4
    moe_hidden: int = 512
    n_experts: int = 8
    experts_per_token: int = 1  # 1 = Switch, 2 = Mixtral top-2
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    max_seq: int = 512
    rope_theta: float = 10000.0
    dtype: torch.dtype = torch.float32

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads


CONFIGS = {
    "tiny": MoeLlamaConfig(vocab=256, dim=64, n_layers=2, n_heads=4,
                           n_kv_heads=2, moe_hidden=128, n_experts=4,
                           max_seq=128),
    "mini": MoeLlamaConfig(),
    # Mixtral-style top-2 routing with renormalized gates
    "mixtral-tiny": MoeLlamaConfig(vocab=256, dim=64, n_layers=2,
                                   n_heads=4, n_kv_heads=2,
                                   moe_hidden=128, n_experts=8,
                                   experts_per_token=2, max_seq=128),
}


def _llama_cfg(cfg: MoeLlamaConfig) -> Ll.LlamaConfig:
    """The attention half of a layer is exactly llama's."""
    return Ll.LlamaConfig(vocab=cfg.vocab, dim=cfg.dim,
                          n_layers=cfg.n_layers, n_heads=cfg.n_heads,
                          n_kv_heads=cfg.n_kv_heads, ffn_dim=1,
                          max_seq=cfg.max_seq, rope_theta=cfg.rope_theta,
                          dtype=cfg.dtype)


class MoE(nn.Module):
    """The MoE block's parameters: the router ``[dim, E]`` and ``n_local``
    experts' ``wi [n_local, dim, hidden]`` and ``wo [n_local, hidden,
    dim]``."""

    def __init__(self, cfg: MoeLlamaConfig, n_local: int, device):
        super().__init__()
        mk = lambda *s: nn.Parameter(torch.empty(s, dtype=cfg.dtype,
                                                 device=device))
        self.router = mk(cfg.dim, cfg.n_experts)
        self.wi = mk(n_local, cfg.dim, cfg.moe_hidden)
        self.wo = mk(n_local, cfg.moe_hidden, cfg.dim)

    def params(self) -> Dict[str, Tensor]:
        return {"router": self.router, "wi": self.wi, "wo": self.wo}


class MoeLlamaLayer(Ll.LlamaLayer):
    """A Llama layer whose dense FFN is replaced by the MoE block."""

    def __init__(self, cfg: MoeLlamaConfig, n_local: int, device):
        super().__init__(_llama_cfg(cfg), device)
        del self.w_gate, self.w_up, self.w_down
        self.moe_cfg = cfg
        self.moe = MoE(cfg, n_local, device)

    def _moe_block(self, x: Tensor, moe_fn: Optional[Callable]
                   ) -> Tuple[Tensor, Tensor]:
        """``[B, S, D] -> ([B, S, D], aux)``: dense by default, or through
        the injected expert-parallel ``moe_fn`` with the same parameters."""
        cfg = self.moe_cfg
        B, S, D = x.shape
        tokens = x.reshape(B * S, D)
        if moe_fn is not None:
            y, aux = moe_fn(self.moe.params(), tokens)
        else:
            capacity = int(math.ceil(B * S * cfg.experts_per_token *
                                     cfg.capacity_factor / cfg.n_experts))
            y, aux = _ep.moe_dense_reference(
                self.moe.params(), tokens, cfg.n_experts, capacity,
                experts_per_token=cfg.experts_per_token)
        return y.reshape(B, S, D), aux

    def forward(self, x: Tensor, cos: Tensor, sin: Tensor,
                attn_fn=None, pos_offset: int = 0,
                moe_fn: Optional[Callable] = None) -> Tuple[Tensor, Tensor]:
        x = x + self._attn(self.attn_norm(x), cos, sin, attn_fn, pos_offset)
        y, aux = self._moe_block(self.ffn_norm(x), moe_fn)
        return x + y, aux


class MoeLlama(nn.Module):
    """Parameters are left uninitialized: build with :func:`init` or
    :func:`moe_llama_params_from_jax`.  With ``ep_size > 1`` it holds one
    rank's share of the experts, ``n_experts / ep_size`` of them
    (:func:`shard_experts`)."""

    def __init__(self, cfg: MoeLlamaConfig,
                 device: Union[str, torch.device, None] = None,
                 ep_size: int = 1):
        super().__init__()
        if cfg.n_experts % ep_size:
            raise ValueError(f"n_experts={cfg.n_experts} not divisible by "
                             f"ep={ep_size}")
        device = _rt.resolve_device(device)
        lcfg = _llama_cfg(cfg)
        self.cfg = cfg
        n_local = cfg.n_experts // ep_size
        self.embed = nn.Module()
        self.embed.table = Ll._param((cfg.vocab, cfg.dim), lcfg, device)
        self.layers = nn.ModuleList(
            MoeLlamaLayer(cfg, n_local, device) for _ in range(cfg.n_layers))
        self.final_norm = Ll.RMSNorm(cfg.dim, lcfg, device)
        self.lm_head = Ll.Dense(cfg.dim, cfg.vocab, lcfg, device)

    def forward(self, ids: Tensor, moe_fn: Optional[Callable] = None,
                attn_fn=None, pos_offset: int = 0) -> Tuple[Tensor, Tensor]:
        """The JAX package's ``moe_llama.apply``: ids ``[B, S]`` ->
        ``(logits [B, S, vocab], the mean router aux over the layers)``."""
        cfg = self.cfg
        cos, sin = L.rope_freqs(cfg.head_dim, cfg.max_seq, cfg.rope_theta,
                                device=ids.device)
        x = L.embedding(self.embed.table, ids).to(cfg.dtype)
        auxes = []
        for layer in self.layers:
            x, aux = layer(x, cos, sin, attn_fn, pos_offset, moe_fn)
            auxes.append(aux)
        x = self.final_norm(x)
        return self.lm_head(x), torch.stack(auxes).mean()


def init(cfg: MoeLlamaConfig, generator: Optional[torch.Generator] = None,
         device: Union[str, torch.device, None] = None) -> MoeLlama:
    """A model holding every expert, with the JAX package's initial
    distributions: embeddings N(0, 0.02), dense weights N(0, 1/in_dim),
    norms one, and ``expert.init_moe_params``'s router and experts.
    ``generator`` (on ``device``) defaults to one seeded 0."""
    model = MoeLlama(cfg, device)
    dev = model.embed.table.device
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    with torch.no_grad():
        model.embed.table.normal_(0.0, 0.02, generator=generator)
        for name, p in model.named_parameters():
            if name.endswith("scale"):
                p.fill_(1.0)
            elif name.endswith("weight"):
                p.normal_(0.0, 1.0 / math.sqrt(p.shape[1]),
                          generator=generator)
        for layer in model.layers:
            moe = _ep.init_moe_params(cfg.dim, cfg.moe_hidden, cfg.n_experts,
                                      generator, cfg.dtype, dev)
            for name, t in moe.items():
                getattr(layer.moe, name).copy_(t)
    return model


def shard_experts(model: MoeLlama, group=None) -> MoeLlama:
    """A copy of ``model`` (which holds every expert) holding only this
    rank's experts of ``group`` (the world when None), for
    ``expert.make_moe_fn``."""
    g = dist.group.WORLD if group is None else group
    ep, r = dist.get_world_size(g), dist.get_rank(g)
    dev = model.embed.table.device
    out = MoeLlama(model.cfg, dev, ep_size=ep)
    full = model.state_dict()
    e_local = model.cfg.n_experts // ep
    with torch.no_grad():
        for name, p in out.state_dict().items():
            t = full[name]
            if name.endswith(("moe.wi", "moe.wo")):
                t = t[r * e_local:(r + 1) * e_local]
            p.copy_(t)
    return out


def loss_fn(model: MoeLlama, ids: Tensor, moe_fn: Optional[Callable] = None,
            attn_fn=None) -> Tensor:
    """Next-token cross-entropy plus ``router_aux_coef`` times the router's
    load-balancing aux."""
    logits, aux = model(ids[:, :-1], moe_fn=moe_fn, attn_fn=attn_fn)
    nll = L.softmax_cross_entropy(logits, ids[:, 1:])
    return nll.mean() + model.cfg.router_aux_coef * aux


def param_count(cfg: MoeLlamaConfig) -> int:
    attn = (cfg.dim * cfg.n_heads * cfg.head_dim
            + 2 * cfg.dim * cfg.n_kv_heads * cfg.head_dim
            + cfg.n_heads * cfg.head_dim * cfg.dim + 2 * cfg.dim)
    moe = (cfg.dim * cfg.n_experts
           + 2 * cfg.n_experts * cfg.dim * cfg.moe_hidden)
    return (cfg.n_layers * (attn + moe)
            + 2 * cfg.vocab * cfg.dim + cfg.dim)


def moe_llama_params_from_jax(tree: Dict[str, Any], cfg: MoeLlamaConfig,
                              device: Union[str, torch.device, None] = None
                              ) -> MoeLlama:
    """A model holding the weights of a JAX ``moe_llama.init`` tree given as
    numpy arrays: the attention half as ``llama.params_from_jax`` loads it
    (dense kernels ``[in, out]`` become ``[out, in]`` weights), the MoE
    block's ``{router, wi, wo}`` as they are."""
    model = MoeLlama(cfg, device)
    if len(tree["layers"]) != cfg.n_layers:
        raise ValueError(f"tree has {len(tree['layers'])} layers, config "
                         f"{cfg.n_layers}")

    def put(p: nn.Parameter, a: Any, transpose: bool = False) -> None:
        t = Ll._to_tensor(a, transpose)
        if tuple(t.shape) != tuple(p.shape):
            raise ValueError(f"shape {tuple(t.shape)} does not fit parameter "
                             f"{tuple(p.shape)}")
        p.copy_(t.to(device=p.device, dtype=p.dtype))

    with torch.no_grad():
        put(model.embed.table, tree["embed"]["table"])
        put(model.final_norm.scale, tree["final_norm"]["scale"])
        put(model.lm_head.weight, tree["lm_head"]["kernel"], transpose=True)
        for layer, lt in zip(model.layers, tree["layers"]):
            for norm in ("attn_norm", "ffn_norm"):
                put(getattr(layer, norm).scale, lt[norm]["scale"])
            for name in ("wq", "wk", "wv", "wo"):
                put(getattr(layer, name).weight, lt[name]["kernel"],
                    transpose=True)
            for name in ("router", "wi", "wo"):
                put(getattr(layer.moe, name), lt["moe"][name])
    return model


__all__ = ["MoeLlamaConfig", "CONFIGS", "MoeLlama", "init", "loss_fn",
           "param_count", "shard_experts", "moe_llama_params_from_jax"]
