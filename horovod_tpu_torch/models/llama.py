"""Llama-3-style decoder: the port of ``horovod_tpu/models/llama.py``
(``LlamaConfig``, ``CONFIGS``, ``init``, ``apply`` as ``Llama.forward``,
``loss_fn``, ``param_count``, and the decode path ``init_cache``,
``copy_blocks``, ``apply_cached``) as an ``nn.Module``.

RMSNorm pre-norm, RoPE (theta 500000, split halves), grouped-query
attention through the ``attn_fn`` hook (``ops.flash_attention`` on the
training path, ``layers.causal_attention`` by default) and SwiGLU, with the
JAX model's initial scales.  Dense weights are ``[out, in]`` as in
``nn.Linear``; ``params_from_jax`` loads a JAX parameter tree (as numpy
arrays) and transposes its ``[in, out]`` kernels.

The decode path serves from one preallocated paged KV pool shared by every
in-flight sequence: a sequence owns whole blocks through its block-table
row (-1 = unassigned).  Where the JAX scatters drop an out-of-range write
(``mode="drop"``), a PyTorch index out of range is an error (on a CUDA
device, a device-side assert), so the pool carries one trash block after
its ``num_blocks`` usable ones: every dropped write lands there, and no
block table points at it, so it is never read.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .. import runtime as _rt
from . import layers as L

Tensor = torch.Tensor
AttnFn = Callable[[Tensor, Tensor, Tensor], Tensor]


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab: int = 128256
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    ffn_dim: int = 14336
    max_seq: int = 8192
    rope_theta: float = 500000.0
    dtype: torch.dtype = torch.bfloat16
    # One matmul for q/k/v (and one for gate/up) on concatenated weights;
    # the same numbers as the separate matmuls.
    fuse_proj: bool = False

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads


CONFIGS = {
    "tiny": LlamaConfig(vocab=256, dim=64, n_layers=2, n_heads=4,
                        n_kv_heads=2, ffn_dim=128, max_seq=128,
                        dtype=torch.float32),
    "mini": LlamaConfig(vocab=4096, dim=512, n_layers=4, n_heads=8,
                        n_kv_heads=4, ffn_dim=1024, max_seq=1024),
    "1b": LlamaConfig(vocab=128256, dim=2048, n_layers=16, n_heads=32,
                      n_kv_heads=8, ffn_dim=8192, max_seq=8192),
    "8b": LlamaConfig(),  # Llama-3-8B
}


def _param(shape, cfg: LlamaConfig, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=cfg.dtype, device=device))


class Dense(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, cfg: LlamaConfig, device):
        super().__init__()
        self.weight = _param((out_dim, in_dim), cfg, device)

    def forward(self, x: Tensor) -> Tensor:
        return L.dense(self.weight, x)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, cfg: LlamaConfig, device):
        super().__init__()
        self.scale = _param((dim,), cfg, device)

    def forward(self, x: Tensor) -> Tensor:
        return L.rmsnorm(self.scale, x)


class LlamaLayer(nn.Module):
    def __init__(self, cfg: LlamaConfig, device):
        super().__init__()
        d, hd = cfg.dim, cfg.head_dim
        self.cfg = cfg
        self.attn_norm = RMSNorm(d, cfg, device)
        self.wq = Dense(d, cfg.n_heads * hd, cfg, device)
        self.wk = Dense(d, cfg.n_kv_heads * hd, cfg, device)
        self.wv = Dense(d, cfg.n_kv_heads * hd, cfg, device)
        self.wo = Dense(cfg.n_heads * hd, d, cfg, device)
        self.ffn_norm = RMSNorm(d, cfg, device)
        self.w_gate = Dense(d, cfg.ffn_dim, cfg, device)
        self.w_up = Dense(d, cfg.ffn_dim, cfg, device)
        self.w_down = Dense(cfg.ffn_dim, d, cfg, device)

    def _attn(self, x: Tensor, cos: Tensor, sin: Tensor,
              attn_fn: Optional[AttnFn], pos_offset: int) -> Tensor:
        cfg = self.cfg
        B, S, _ = x.shape
        nq, nkv = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
        if cfg.fuse_proj:
            wqkv = torch.cat([self.wq.weight, self.wk.weight, self.wv.weight])
            q, k, v = L.dense(wqkv, x).split((nq, nkv, nkv), dim=-1)
        else:
            q, k, v = self.wq(x), self.wk(x), self.wv(x)
        q = q.reshape(B, S, cfg.n_heads, cfg.head_dim)
        k = k.reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
        v = v.reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
        q = L.apply_rope(q, cos, sin, offset=pos_offset)
        k = L.apply_rope(k, cos, sin, offset=pos_offset)
        if attn_fn is None:
            o = L.causal_attention(q, k, v, causal=True)
        else:
            o = attn_fn(q, k, v)
        return self.wo(o.reshape(B, S, nq))

    def _ffn(self, x: Tensor) -> Tensor:
        if self.cfg.fuse_proj:
            wgu = torch.cat([self.w_gate.weight, self.w_up.weight])
            g, u = L.dense(wgu, x).chunk(2, dim=-1)
            return self.w_down(F.silu(g) * u)
        return self.w_down(F.silu(self.w_gate(x)) * self.w_up(x))

    def forward(self, x: Tensor, cos: Tensor, sin: Tensor,
                attn_fn: Optional[AttnFn] = None, pos_offset: int = 0
                ) -> Tensor:
        x = x + self._attn(self.attn_norm(x), cos, sin, attn_fn, pos_offset)
        return x + self._ffn(self.ffn_norm(x))

    def _qkv_at(self, x: Tensor, cos: Tensor, sin: Tensor,
                positions: Tensor):
        """q ``[S, C, n_heads, hd]`` and k, v ``[S, C, n_kv_heads, hd]`` of
        a tick's chunk, RoPE'd at ``positions``.  The projections are
        unfused, as in the JAX decode path."""
        cfg = self.cfg
        S, C, _ = x.shape
        q = self.wq(x).reshape(S, C, cfg.n_heads, cfg.head_dim)
        k = self.wk(x).reshape(S, C, cfg.n_kv_heads, cfg.head_dim)
        v = self.wv(x).reshape(S, C, cfg.n_kv_heads, cfg.head_dim)
        pos_c = positions.clamp(max=cfg.max_seq - 1)
        return (L.apply_rope_at(q, cos, sin, pos_c),
                L.apply_rope_at(k, cos, sin, pos_c), v)

    def _attn_cached(self, x: Tensor, cos: Tensor, sin: Tensor,
                     k_pool: Tensor, v_pool: Tensor, block_tables: Tensor,
                     positions: Tensor, valid: Tensor,
                     pool: Any = None) -> Tensor:
        """Attention of one layer over its paged pool.  x: ``[S, C, dim]``,
        S slots of C token positions each.  ``pool`` is the serving
        engine's plan of a pool sharded over ranks
        (``serve.pool.PoolPlan``): it writes this rank's share of the k/v
        and attends over it with its peers; without one, the whole pool
        is here (:func:`paged_attention`)."""
        S, C, _ = x.shape
        q, k, v = self._qkv_at(x, cos, sin, positions)
        if pool is None:
            o = paged_attention(q, k, v, k_pool, v_pool, block_tables,
                                positions, valid)
        else:
            o = pool.attend(q, k, v, k_pool, v_pool, block_tables,
                            positions, valid)
        return self.wo(o.reshape(S, C, -1))


def write_paged_kv(k_pool: Tensor, v_pool: Tensor, k: Tensor, v: Tensor,
                   block_tables: Tensor, positions: Tensor, valid: Tensor,
                   blocks: Optional[Tuple[int, int]] = None) -> None:
    """Scatter a chunk's k/v ``[S, C, kv_heads, hd]`` into a pool ``[nb +
    1, block_size, kv_heads, hd]``: the token at position P to
    ``block_tables[s, P // bs]``, offset ``P % bs``.  ``blocks = (b0,
    b1)`` is the range of global block ids this pool holds (local id ``b -
    b0``; default: all of them); every invalid position, and every block
    outside the range, goes to the pool's last block, the trash block."""
    trash, bs = k_pool.shape[0] - 1, k_pool.shape[1]
    max_blocks = block_tables.shape[1]
    slot_idx = (positions // bs).clamp(max=max_blocks - 1)
    blk = block_tables.gather(1, slot_idx)
    if blocks is None:
        blk = torch.where(valid, blk.clamp(min=0), trash)
    else:
        b0, b1 = blocks
        blk = torch.where(valid & (blk >= b0) & (blk < b1), blk - b0, trash)
    off = positions % bs
    k_pool[blk, off] = k.to(k_pool.dtype)
    v_pool[blk, off] = v.to(v_pool.dtype)


def paged_attention(q: Tensor, k: Tensor, v: Tensor, k_pool: Tensor,
                    v_pool: Tensor, block_tables: Tensor, positions: Tensor,
                    valid: Tensor) -> Tensor:
    """The whole pool's decode attention ``[S, C, H, hd]``: the chunk's k/v
    are scattered into the pool ``[num_blocks + 1, block_size, kv_heads,
    hd]`` first (:func:`write_paged_kv`), then each query attends over its
    slot's whole gathered context under a per-position mask."""
    S, C = q.shape[:2]
    bs, hk, hd = k_pool.shape[1:]
    write_paged_kv(k_pool, v_pool, k, v, block_tables, positions, valid)
    # gathered index t is global position t; unassigned entries (-1,
    # read as block 0) cover only positions the mask excludes
    bt = block_tables.clamp(min=0)
    T = block_tables.shape[1] * bs
    k_ctx = k_pool[bt].reshape(S, T, hk, hd)
    v_ctx = v_pool[bt].reshape(S, T, hk, hd)
    key_pos = torch.arange(T, device=q.device)
    mask = (key_pos[None, None, :] <= positions[:, :, None])[:, None]
    return L.causal_attention(q, k_ctx, v_ctx, causal=False, mask=mask)


class Llama(nn.Module):
    """Parameters are left uninitialized: build with :func:`init` or
    :func:`params_from_jax`."""

    def __init__(self, cfg: LlamaConfig,
                 device: Union[str, torch.device, None] = None):
        super().__init__()
        device = _rt.resolve_device(device)
        self.cfg = cfg
        self.embed = nn.Module()
        self.embed.table = _param((cfg.vocab, cfg.dim), cfg, device)
        self.layers = nn.ModuleList(
            LlamaLayer(cfg, device) for _ in range(cfg.n_layers))
        self.final_norm = RMSNorm(cfg.dim, cfg, device)
        self.lm_head = Dense(cfg.dim, cfg.vocab, cfg, device)

    def forward(self, ids: Tensor, attn_fn: Optional[AttnFn] = None,
                remat: bool = False, return_hidden: bool = False,
                pos_offset: int = 0) -> Tensor:
        """The JAX package's ``llama.apply``: token ids ``[B, S]`` -> logits
        ``[B, S, vocab]``, or the
        final-norm hidden states ``[B, S, dim]`` with ``return_hidden``.
        ``remat`` recomputes each layer in the backward
        (``torch.utils.checkpoint``); ``pos_offset`` shifts RoPE
        positions."""
        cfg = self.cfg
        cos, sin = L.rope_freqs(cfg.head_dim, cfg.max_seq, cfg.rope_theta,
                                device=ids.device)
        x = L.embedding(self.embed.table, ids).to(cfg.dtype)
        for layer in self.layers:
            if remat:
                x = checkpoint(layer, x, cos, sin, attn_fn, pos_offset,
                               use_reentrant=False)
            else:
                x = layer(x, cos, sin, attn_fn, pos_offset)
        x = self.final_norm(x)
        if return_hidden:
            return x
        return self.lm_head(x)

    @torch.no_grad()
    def apply_cached(self, tokens: Tensor, cache: Dict[str, Tensor],
                     block_tables: Tensor, lengths: Tensor, n_new: Tensor,
                     pool: Any = None) -> Tensor:
        """Mixed prefill/decode forward over the paged pool (the JAX
        package's ``apply_cached``).  ``tokens [S, C]``: slot s's next
        ``n_new[s]`` tokens (0 = inactive slot), starting at context length
        ``lengths[s]``; ``block_tables [S, max_blocks]`` indexes the pool
        (-1 = unassigned).  Writes the chunk's k/v into ``cache`` in place
        and returns logits ``[S, C, vocab]``; the caller samples at
        position ``n_new[s] - 1``.  ``pool``: the plan of a pool sharded
        over ranks, whose shard ``cache`` is (``LlamaLayer._attn_cached``)."""
        cfg = self.cfg
        tokens, block_tables, lengths, n_new = (
            t.long() for t in (tokens, block_tables, lengths, n_new))
        S, C = tokens.shape
        dev = tokens.device
        cos, sin = L.rope_freqs(cfg.head_dim, cfg.max_seq, cfg.rope_theta,
                                device=dev)
        cols = torch.arange(C, device=dev)
        positions = lengths[:, None] + cols[None]
        valid = cols[None] < n_new[:, None]
        x = L.embedding(self.embed.table, tokens).to(cfg.dtype)
        for i, layer in enumerate(self.layers):
            x = x + layer._attn_cached(
                layer.attn_norm(x), cos, sin, cache["k"][i], cache["v"][i],
                block_tables, positions, valid, pool)
            x = x + layer._ffn(layer.ffn_norm(x))
        return self.lm_head(self.final_norm(x))


def init(cfg: LlamaConfig, generator: Optional[torch.Generator] = None,
         device: Union[str, torch.device, None] = None) -> Llama:
    """A model with the JAX package's initial distributions: embeddings
    N(0, 0.02), dense weights N(0, 1/in_dim), norms one.  ``generator``
    (on ``device``) defaults to one seeded 0."""
    model = Llama(cfg, device)
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
    return model


def init_cache(cfg: LlamaConfig, num_blocks: int, block_size: int,
               dtype: Optional[torch.dtype] = None,
               device: Union[str, torch.device, None] = None,
               plan: Any = None) -> Dict[str, Tensor]:
    """The paged KV pool ``{"k", "v"}``, zeros of shape ``[n_layers,
    num_blocks + 1, block_size, n_kv_heads, head_dim]``: blocks ``0 ..
    num_blocks - 1`` are the ones block tables may name, block
    ``num_blocks`` is the trash block that takes dropped writes.  Zeros,
    so a masked stale value is finite and its softmax weight exactly 0.
    With ``plan`` (``serve.pool.PoolPlan``) it is this rank's shard,
    ``[n_layers, b1 - b0 + 1, block_size, h1 - h0, head_dim]`` for the
    plan's block range ``[b0, b1)`` and kv-head range ``[h0, h1)``, with a
    trash block of its own."""
    device = _rt.resolve_device(device)
    dtype = dtype if dtype is not None else cfg.dtype
    n_blocks, n_heads = num_blocks, cfg.n_kv_heads
    if plan is not None:
        (b0, b1), (h0, h1) = plan.blocks, plan.heads
        n_blocks, n_heads = b1 - b0, h1 - h0
    shape = (cfg.n_layers, n_blocks + 1, block_size, n_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


@torch.no_grad()
def copy_blocks(cache: Dict[str, Tensor], src: Tensor, dst: Tensor) -> None:
    """Copy-on-write for the serving prefix cache: clone whole pool blocks
    ``src[i] -> dst[i]`` across every layer, in place.  Run it before the
    tick's k/v writes: the right-hand gather is materialized before the
    scatter, so it reads the pool as it was.  Entries with ``dst`` outside
    ``[0, num_blocks)`` are padding and go to the trash block; ``src`` is
    clamped so the gather stays in bounds."""
    trash = cache["k"].shape[1] - 1
    src, dst = src.long(), dst.long()
    safe = src.clamp(0, trash - 1)
    dst = torch.where((dst >= 0) & (dst < trash), dst, trash)
    for pool in cache.values():
        pool[:, dst] = pool[:, safe]


def apply_cached(model: Llama, tokens: Tensor, cache: Dict[str, Tensor],
                 block_tables: Tensor, lengths: Tensor, n_new: Tensor,
                 pool: Any = None) -> Tensor:
    """:meth:`Llama.apply_cached` as a function of the model, the JAX
    package's calling shape."""
    return model.apply_cached(tokens, cache, block_tables, lengths, n_new,
                              pool=pool)


def _chunk_nll(weight: Tensor, h: Tensor, t: Tensor) -> Tensor:
    return L.softmax_cross_entropy(L.dense(weight, h), t).sum()


def loss_fn(model: Llama, ids: Tensor, attn_fn: Optional[AttnFn] = None,
            remat: bool = False, ce_chunks: int = 0) -> Tensor:
    """Next-token cross-entropy over shifted ids.

    ``ce_chunks > 0`` runs the lm_head and the loss over that many sequence
    chunks, each under ``torch.utils.checkpoint``: only one
    ``[B, S/C, vocab]`` logits slab is live, and the backward recomputes
    it."""
    targets = ids[:, 1:]
    if ce_chunks:
        h = model(ids[:, :-1], attn_fn=attn_fn, remat=remat,
                  return_hidden=True)
        B, S, _ = h.shape
        if S % ce_chunks:
            raise ValueError(f"seq {S} not divisible by ce_chunks={ce_chunks}")
        n = S // ce_chunks
        total = sum(checkpoint(_chunk_nll, model.lm_head.weight,
                               h[:, c * n:(c + 1) * n],
                               targets[:, c * n:(c + 1) * n],
                               use_reentrant=False)
                    for c in range(ce_chunks))
        return total / (B * S)
    logits = model(ids[:, :-1], attn_fn=attn_fn, remat=remat)
    return L.softmax_cross_entropy(logits, targets).mean()


def param_count(cfg: LlamaConfig) -> int:
    per_layer = (cfg.dim * cfg.n_heads * cfg.head_dim
                 + 2 * cfg.dim * cfg.n_kv_heads * cfg.head_dim
                 + cfg.n_heads * cfg.head_dim * cfg.dim
                 + 3 * cfg.dim * cfg.ffn_dim + 2 * cfg.dim)
    return (cfg.vocab * cfg.dim * 2 + cfg.dim
            + cfg.n_layers * per_layer)


def _to_tensor(a: Any, transpose: bool) -> Tensor:
    a = np.asarray(a)
    return L.to_tensor(a.T if transpose else a)


def params_from_jax(tree: Dict[str, Any], cfg: LlamaConfig,
                    device: Union[str, torch.device, None] = None) -> Llama:
    """A model holding the weights of a JAX ``llama.init`` tree given as
    numpy arrays (``embed.table``, ``final_norm.scale``,
    ``lm_head.kernel``, ``layers[i].{attn_norm,wq,...,w_down}``).  Dense
    kernels ``[in, out]`` become ``[out, in]`` weights; values are cast to
    ``cfg.dtype``."""
    model = Llama(cfg, device)

    def put(p: nn.Parameter, a: Any, transpose: bool = False) -> None:
        t = _to_tensor(a, transpose)
        if tuple(t.shape) != tuple(p.shape):
            raise ValueError(f"shape {tuple(t.shape)} does not fit parameter "
                             f"{tuple(p.shape)}")
        p.copy_(t.to(device=p.device, dtype=p.dtype))

    with torch.no_grad():
        put(model.embed.table, tree["embed"]["table"])
        put(model.final_norm.scale, tree["final_norm"]["scale"])
        put(model.lm_head.weight, tree["lm_head"]["kernel"], transpose=True)
        if len(tree["layers"]) != cfg.n_layers:
            raise ValueError(f"tree has {len(tree['layers'])} layers, config "
                             f"{cfg.n_layers}")
        for layer, lt in zip(model.layers, tree["layers"]):
            for norm in ("attn_norm", "ffn_norm"):
                put(getattr(layer, norm).scale, lt[norm]["scale"])
            for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
                put(getattr(layer, name).weight, lt[name]["kernel"],
                    transpose=True)
    return model
