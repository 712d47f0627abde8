"""Layers of the Llama decoder: the port of ``horovod_tpu/models/layers.py``
(``dense``, ``embedding``, ``rmsnorm``, ``softmax_cross_entropy``,
``rope_freqs``, ``apply_rope``, ``apply_rope_at``, ``causal_attention``),
with the same math and the same fp32 upcasts, as plain functions on
tensors.

Dense weights follow PyTorch's ``nn.Linear`` layout ``[out, in]``:
``dense(w, x) = x @ w.T`` (the JAX kernels are ``[in, out]``;
``llama.params_from_jax`` transposes them).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def dense(weight: Tensor, x: Tensor) -> Tensor:
    return F.linear(x, weight)


def embedding(table: Tensor, ids: Tensor) -> Tensor:
    return F.embedding(ids, table)


def rmsnorm(scale: Tensor, x: Tensor, eps: float = 1e-6) -> Tensor:
    x32 = x.float()
    y = x32 * torch.rsqrt(x32.square().mean(-1, keepdim=True) + eps)
    return (y * scale).to(x.dtype)


def softmax_cross_entropy(logits: Tensor, targets: Tensor) -> Tensor:
    """Per-position negative log-likelihood ``logsumexp(logits) -
    logits[target]`` in fp32, ``logits[..., V]`` against integer
    ``targets[...]``."""
    lse = torch.logsumexp(logits.float(), dim=-1)
    tgt = logits.gather(-1, targets.long().unsqueeze(-1)).squeeze(-1).float()
    return lse - tgt


def rope_freqs(head_dim: int, max_len: int, theta: float = 10000.0,
               dtype: torch.dtype = torch.float32,
               device: Union[str, torch.device, None] = None
               ) -> Tuple[Tensor, Tensor]:
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                        device=device) / head_dim))
    t = torch.arange(max_len, dtype=torch.float32, device=device)
    ang = torch.outer(t, inv)  # [max_len, head_dim/2]
    return torch.cos(ang).to(dtype), torch.sin(ang).to(dtype)


def apply_rope(x: Tensor, cos: Tensor, sin: Tensor, offset: int = 0) -> Tensor:
    """x: ``[..., seq, heads, head_dim]``; rotary position embedding in the
    split-halves convention."""
    seq = x.shape[-3]
    c = cos[offset:offset + seq, None, :]
    s = sin[offset:offset + seq, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def apply_rope_at(x: Tensor, cos: Tensor, sin: Tensor,
                  positions: Tensor) -> Tensor:
    """x: ``[B, S, heads, head_dim]``; rotary embedding at explicit
    per-token positions ``[B, S]`` (each serving slot sits at its own
    position), on the same tables and with the same math as
    :func:`apply_rope`."""
    c = cos[positions][..., None, :]
    s = sin[positions][..., None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def causal_attention(q: Tensor, k: Tensor, v: Tensor, causal: bool = True,
                     mask: Optional[Tensor] = None,
                     score_dtype: Optional[torch.dtype] = torch.float32
                     ) -> Tensor:
    """Multi-head attention core.  q: ``[B, S, H, D]``; k/v:
    ``[B, Sk, Hkv, D]`` (grouped-query when Hkv < H, by folding the group
    into the batched product rather than repeating k/v).  Scores
    materialize in ``score_dtype`` (``None``: the input dtype), masked
    positions fill with that dtype's minimum, and the softmax runs in
    fp32."""
    B, S, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    rep = H // Hkv
    scale = 1.0 / math.sqrt(D)
    qg = q.reshape(B, S, Hkv, rep, D)
    sdt = q.dtype if score_dtype is None else score_dtype
    fill = torch.finfo(sdt).min
    logits = torch.einsum("bqhrd,bkhd->bhrqk", qg.to(sdt), k.to(sdt)) * scale
    if causal:
        keep = torch.ones(S, Sk, dtype=torch.bool, device=q.device).tril(Sk - S)
        logits = logits.masked_fill(~keep, fill)
    if mask is not None:
        # user masks address [B?, H, Sq, Sk]: expose the grouped logits in
        # that layout, mask, and re-group
        lg = logits.reshape(B, H, S, Sk)
        lg = lg.masked_fill(~mask.to(torch.bool), fill)
        logits = lg.reshape(B, Hkv, rep, S, Sk)
    probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    o = torch.einsum("bhrqk,bkhd->bqhrd", probs, v)
    return o.reshape(B, S, H, D)
