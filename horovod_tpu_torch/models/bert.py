"""BERT encoder (BERT-Large by default): the port of
``horovod_tpu/models/bert.py`` (``BertConfig``, ``CONFIGS``, ``init``,
``apply_layer``, ``apply`` as ``Bert.forward``, ``loss_fn``).

Learned position embeddings, post-norm residuals, a tanh-GELU FFN and the
masked-LM head.  Attention runs through the ``attn_fn`` hook (on the card
``ops.flash_attention`` with ``causal=False``; by default the plain
``layers.causal_attention(causal=False)``, which alone takes a
``pad_mask``).  :func:`sp_loss_fn` is one rank's share of the masked-LM
loss under Ulysses sequence parallelism (the JAX example
``bert_ulysses_sp.py``'s ``shard_loss``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Union

import torch
import torch.distributed as dist
import torch.nn as nn

from .. import runtime as _rt
from . import layers as L

Tensor = torch.Tensor
AttnFn = Callable[[Tensor, Tensor, Tensor], Tensor]


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab: int = 30522
    dim: int = 1024          # BERT-Large hidden
    n_layers: int = 24
    n_heads: int = 16
    ffn_dim: int = 4096
    max_seq: int = 512
    type_vocab: int = 2
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads


CONFIGS = {
    "tiny": BertConfig(vocab=256, dim=64, n_layers=2, n_heads=4,
                       ffn_dim=128, max_seq=64, dtype=torch.float32),
    "base": BertConfig(dim=768, n_layers=12, n_heads=12, ffn_dim=3072),
    "large": BertConfig(),
}


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig, device):
        super().__init__()
        d, dt, s = cfg.dim, cfg.dtype, 1.0 / math.sqrt(cfg.dim)
        self.cfg = cfg
        for name in ("wq", "wk", "wv", "wo"):
            self.add_module(name, L.Dense(d, d, dt, device, scale=s))
        self.ln1 = L.LayerNorm(d, device)
        self.ffn_in = L.Dense(d, cfg.ffn_dim, dt, device, scale=s)
        self.ffn_out = L.Dense(cfg.ffn_dim, d, dt, device,
                               scale=1.0 / math.sqrt(cfg.ffn_dim))
        self.ln2 = L.LayerNorm(d, device)

    def forward(self, x: Tensor, pad_mask: Optional[Tensor] = None,
                attn_fn: Optional[AttnFn] = None) -> Tensor:
        cfg = self.cfg
        B, S, _ = x.shape
        q, k, v = (getattr(self, w)(x).reshape(B, S, cfg.n_heads,
                                               cfg.head_dim)
                   for w in ("wq", "wk", "wv"))
        if attn_fn is None:
            mask = None if pad_mask is None else pad_mask[:, None, None, :]
            o = L.causal_attention(q, k, v, causal=False, mask=mask)
        else:
            o = attn_fn(q, k, v)
        x = self.ln1(x + self.wo(o.reshape(B, S, cfg.dim)))
        return self.ln2(x + self.ffn_out(L.gelu(self.ffn_in(x))))


class Bert(nn.Module):
    def __init__(self, cfg: BertConfig,
                 device: Union[str, torch.device, None] = None):
        super().__init__()
        device = _rt.resolve_device(device)
        self.cfg = cfg
        self.tok_embed = L.Embedding(cfg.vocab, cfg.dim, cfg.dtype, device)
        self.pos_embed = L.Embedding(cfg.max_seq, cfg.dim, cfg.dtype, device)
        self.type_embed = L.Embedding(cfg.type_vocab, cfg.dim, cfg.dtype,
                                      device)
        self.embed_ln = L.LayerNorm(cfg.dim, device)
        self.layers = nn.ModuleList(BertLayer(cfg, device)
                                    for _ in range(cfg.n_layers))
        self.mlm_head = L.Dense(cfg.dim, cfg.vocab, cfg.dtype, device,
                                scale=1.0 / math.sqrt(cfg.dim))

    def forward(self, ids: Tensor, type_ids: Optional[Tensor] = None,
                pad_mask: Optional[Tensor] = None,
                attn_fn: Optional[AttnFn] = None,
                positions: Optional[Tensor] = None) -> Tensor:
        """``ids`` ``[B, S]`` -> masked-LM logits ``[B, S, vocab]``.
        ``positions`` (default ``arange(S)``) are the tokens' global
        positions, which a sequence shard must give."""
        if attn_fn is not None and pad_mask is not None:
            raise ValueError(
                "pad_mask is applied by the built-in attention only; a "
                "custom attn_fn receives no mask")
        S = ids.shape[1]
        pos = (torch.arange(S, device=ids.device) if positions is None
               else positions)
        x = self.tok_embed(ids) + self.pos_embed(pos)[None]
        if type_ids is not None:
            x = x + self.type_embed(type_ids)
        x = self.embed_ln(x).to(self.cfg.dtype)
        for layer in self.layers:
            x = layer(x, pad_mask, attn_fn)
        return self.mlm_head(x)


def init(cfg: BertConfig, generator: Optional[torch.Generator] = None,
         device: Union[str, torch.device, None] = None) -> Bert:
    """A model with the JAX package's initial distributions: embeddings
    N(0, 0.02), dense weights N(0, 1/dim) (the FFN's output N(0,
    1/ffn_dim)), biases zero, norms one."""
    return L.init_weights(Bert(cfg, device), generator)


def loss_fn(model: Bert, ids: Tensor, labels: Tensor,
            mask: Optional[Tensor] = None, attn_fn: Optional[AttnFn] = None,
            positions: Optional[Tensor] = None) -> Tensor:
    """Masked-LM cross-entropy; ``mask`` selects the predicted positions
    (the mean over this call's positions: under sequence parallelism use
    :func:`sp_loss_fn`)."""
    nll = L.softmax_cross_entropy(
        model(ids, attn_fn=attn_fn, positions=positions), labels)
    if mask is not None:
        return (nll * mask).sum() / mask.sum().clamp_min(1.0)
    return nll.mean()


def sp_loss_fn(model: Bert, ids: Tensor, labels: Tensor, mask: Tensor,
               group=None) -> Tensor:
    """This rank's share of the global masked-LM loss when each rank of
    ``group`` (default: the world) holds one contiguous sequence shard
    ``[B, S/n]``: global positions, attention through Ulysses
    (``parallel/sequence.py``), and its masked positions' summed loss over
    the count of masked positions in every shard.  The shares sum to the
    global masked mean, and summing the ranks' gradients (``op=Sum``)
    gives its gradient."""
    from ..parallel.sequence import ulysses_attention
    g = dist.group.WORLD if group is None else group
    shard = ids.shape[1]
    positions = dist.get_rank(g) * shard + torch.arange(shard,
                                                        device=ids.device)
    nll = L.softmax_cross_entropy(model(
        ids, positions=positions,
        attn_fn=lambda q, k, v: ulysses_attention(q, k, v, group=g,
                                                  causal=False)), labels)
    den = mask.float().sum()
    dist.all_reduce(den, group=g)
    return (nll * mask).sum() / den.clamp_min(1.0)


def params_from_jax(tree: Dict[str, Any], cfg: BertConfig,
                    device: Union[str, torch.device, None] = None) -> Bert:
    """A model holding a JAX ``bert.init`` tree's weights (numpy leaves),
    cast to ``cfg.dtype`` (norms fp32)."""
    return L.load_state(Bert(cfg, device), L.state_from_jax(tree))
