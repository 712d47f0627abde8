"""Layers of the model zoo: the port of ``horovod_tpu/models/layers.py``
with the same math and the same fp32 upcasts, as plain functions on
tensors (``dense``, ``embedding``, ``layernorm``, ``rmsnorm``, ``gelu``,
``conv``, ``batchnorm``, ``maxpool``, ``avgpool``,
``softmax_cross_entropy``, ``rope_freqs``, ``apply_rope``,
``apply_rope_at``, ``causal_attention``) and as the modules the CNNs,
BERT and the MLP are built of (``Dense``, ``Embedding``,
``LayerNorm``, ``Conv``, ``BatchNorm``, ``ConvBN``).

Layouts.  Dense weights follow PyTorch's ``nn.Linear`` layout ``[out,
in]``: ``dense(w, x) = x @ w.T`` (the JAX kernels are ``[in, out]``).
Convolutions take NCHW activations and OIHW weights (the JAX package's are
NHWC and HWIO); a model that takes an NHWC batch permutes it once, which
leaves the activations in ``channels_last`` memory, the layout cuDNN runs
fastest.  ``state_from_jax`` carries a JAX parameter tree over into these
layouts.

TF ``SAME`` padding is asymmetric where the total is odd (more after than
before, e.g. (0, 1) for a 3x3 at stride 2 on an even size), so ``conv``,
``maxpool`` and ``avgpool`` pad explicitly where PyTorch's symmetric
``padding=`` cannot express it; the max pool pads with ``-inf``, the
average pool divides by the count of cells inside the image.

Batch normalization computes its statistics as the JAX package does, in
fp32 as E[x^2] - E[x]^2 with the biased variance in the running average
(momentum 0.9), and normalizes with them.  Given a process group of more
than one rank, the training statistics span the global batch: one
differentiable sum-allreduce of ``[sum, sum of squares, count]`` a layer,
which gives the global variance (the reference's SyncBatchNorm; the JAX
package's ``pmean`` of local variances leaves out the variance of the
ranks' means).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

Tensor = torch.Tensor


def dense(weight: Tensor, x: Tensor, bias: Optional[Tensor] = None
          ) -> Tensor:
    return F.linear(x, weight, bias)


def embedding(table: Tensor, ids: Tensor) -> Tensor:
    return F.embedding(ids, table)


def layernorm(scale: Tensor, bias: Tensor, x: Tensor, eps: float = 1e-5
              ) -> Tensor:
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = x32.var(-1, unbiased=False, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(x.dtype)


def gelu(x: Tensor) -> Tensor:
    return F.gelu(x, approximate="tanh")


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


# ----------------------------------------------------------------------- conv
def same_pads(size: int, window: int, stride: int) -> Tuple[int, int]:
    """TF ``SAME`` padding of one spatial dim: (before, after), the odd
    cell after."""
    out = -(-size // stride)
    total = max((out - 1) * stride + window - size, 0)
    return total // 2, total - total // 2


def _pads(x: Tensor, kh: int, kw: int, stride: int,
          padding: str) -> Tuple[int, int, int, int]:
    """``(left, right, top, bottom)`` for ``F.pad`` of an NCHW ``x``."""
    if padding == "VALID":
        return 0, 0, 0, 0
    if padding != "SAME":
        raise ValueError(f"padding {padding!r}: SAME or VALID")
    (t, b), (lf, r) = (same_pads(x.shape[2], kh, stride),
                       same_pads(x.shape[3], kw, stride))
    return lf, r, t, b


def conv(weight: Tensor, x: Tensor, stride: int = 1,
         padding: str = "SAME") -> Tensor:
    """2-D convolution, NCHW ``x`` and OIHW ``weight``, TF padding."""
    lf, r, t, b = _pads(x, weight.shape[2], weight.shape[3], stride, padding)
    if lf == r and t == b:
        return F.conv2d(x, weight, stride=stride, padding=(t, lf))
    return F.conv2d(F.pad(x, (lf, r, t, b)), weight, stride=stride)


class _AllReduceSum(torch.autograd.Function):
    """Sum over ``group``; the backward sums the gradients the same way."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def batchnorm(x: Tensor, scale: Tensor, bias: Tensor, mean: Tensor,
              var: Tensor, training: bool = False, momentum: float = 0.9,
              eps: float = 1e-5, group=None) -> Tensor:
    """Batch normalization of an NCHW (or ``[N, C]``) ``x`` over every dim
    but the channels.  In training, the batch statistics normalize ``x``
    and move the running ``mean``/``var`` buffers in place; ``group``
    (a process group of more than one rank) makes them the global
    batch's."""
    shape = (1, -1) + (1,) * (x.dim() - 2)
    x32 = x.float()
    if training:
        dims = [0] + list(range(2, x.dim()))
        if group is not None and dist.get_world_size(group) > 1:
            c = x.shape[1]
            count = x32.new_full((1,), x32.numel() / c)
            stats = _AllReduceSum.apply(torch.cat(
                [x32.sum(dims), x32.square().sum(dims), count]), group)
            m = stats[:c] / stats[-1]
            v = stats[c:2 * c] / stats[-1] - m.square()
        else:
            m = x32.mean(dims)
            v = x32.square().mean(dims) - m.square()
        with torch.no_grad():
            mean.copy_(momentum * mean + (1 - momentum) * m)
            var.copy_(momentum * var + (1 - momentum) * v)
    else:
        m, v = mean, var
    y = (x32 - m.view(shape)) * torch.rsqrt(v.view(shape) + eps)
    return (y * scale.view(shape) + bias.view(shape)).to(x.dtype)


def maxpool(x: Tensor, window: int = 3, stride: int = 2,
            padding: str = "SAME") -> Tensor:
    pads = _pads(x, window, window, stride, padding)
    if any(pads):
        x = F.pad(x, pads, value=-math.inf)
    return F.max_pool2d(x, window, stride)


def avgpool(x: Tensor, window: int = 3, stride: int = 1,
            padding: str = "SAME") -> Tensor:
    """Mean over each window's cells inside the image (padding is not
    counted, as the JAX Inception's ``_pool`` divides)."""
    pads = _pads(x, window, window, stride, padding)
    ones = x.new_ones((1, 1) + tuple(x.shape[2:]))
    s, cnt = (F.avg_pool2d(F.pad(a, pads), window, stride,
                           divisor_override=1) for a in (x, ones))
    return s / cnt


def resize_linear(x: Tensor, h: int, w: int) -> Tensor:
    """``jax.image.resize(..., "linear")`` of an NCHW ``x`` to ``[h, w]``:
    half-pixel centres, a triangle kernel widened by the scale when
    downsampling (antialiasing), weights normalized per output cell."""
    def weights(n_in: int, n_out: int) -> Tensor:
        inv = n_in / n_out
        kscale = max(inv, 1.0)
        sample = (torch.arange(n_out, dtype=torch.float32,
                               device=x.device) + 0.5) * inv - 0.5
        pos = torch.arange(n_in, dtype=torch.float32, device=x.device)
        wt = (1 - (sample[None] - pos[:, None]).abs() / kscale).clamp_min(0)
        total = wt.sum(0, keepdim=True)
        wt = torch.where(total.abs() > 1000 * float(np.finfo(np.float32).eps),
                         wt / torch.where(total != 0, total, 1.0), 0.0)
        inside = (sample >= -0.5) & (sample <= n_in - 0.5)
        return torch.where(inside[None], wt, 0.0)

    wh = weights(x.shape[2], h).to(x.dtype)
    ww = weights(x.shape[3], w).to(x.dtype)
    return torch.einsum("nchw,hH,wW->ncHW", x, wh, ww)


# -------------------------------------------------------------------- modules
def _param(shape, dtype, device, fill: Optional[float] = None
           ) -> nn.Parameter:
    t = torch.empty(shape, dtype=dtype, device=device)
    if fill is not None:
        t.fill_(fill)
    return nn.Parameter(t)


class Dense(nn.Module):
    """``[out, in]`` weight and a bias; initialized N(0, ``scale``),
    default 1/sqrt(in), bias zero."""

    def __init__(self, in_dim: int, out_dim: int, dtype, device,
                 scale: Optional[float] = None):
        super().__init__()
        self.weight = _param((out_dim, in_dim), dtype, device)
        self.bias = _param((out_dim,), dtype, device, 0.0)
        self.init_scale = scale if scale is not None else 1 / math.sqrt(
            in_dim)

    def forward(self, x: Tensor) -> Tensor:
        return dense(self.weight, x, self.bias)


class Embedding(nn.Module):
    """A ``[vocab, dim]`` table, initialized N(0, 0.02)."""

    init_scale = 0.02

    def __init__(self, vocab: int, dim: int, dtype, device):
        super().__init__()
        self.table = _param((vocab, dim), dtype, device)

    def forward(self, ids: Tensor) -> Tensor:
        return embedding(self.table, ids)


class LayerNorm(nn.Module):
    def __init__(self, dim: int, device):
        super().__init__()
        self.scale = _param((dim,), torch.float32, device, 1.0)
        self.bias = _param((dim,), torch.float32, device, 0.0)

    def forward(self, x: Tensor) -> Tensor:
        return layernorm(self.scale, self.bias, x)


class Conv(nn.Module):
    """An OIHW kernel without bias, initialized N(0, 2 / fan_in) (He)."""

    def __init__(self, kh: int, kw: int, cin: int, cout: int, dtype, device):
        super().__init__()
        self.weight = _param((cout, cin, kh, kw), dtype, device)
        self.init_scale = math.sqrt(2.0 / (kh * kw * cin))

    def forward(self, x: Tensor, stride: int = 1,
                padding: str = "SAME") -> Tensor:
        return conv(self.weight, x, stride, padding)


class BatchNorm(nn.Module):
    """fp32 scale and bias, and the running ``mean``/``var`` as buffers."""

    def __init__(self, dim: int, device):
        super().__init__()
        self.scale = _param((dim,), torch.float32, device, 1.0)
        self.bias = _param((dim,), torch.float32, device, 0.0)
        self.register_buffer("mean", torch.zeros(dim, device=device))
        self.register_buffer("var", torch.ones(dim, device=device))

    def forward(self, x: Tensor, training: bool = False, group=None
                ) -> Tensor:
        return batchnorm(x, self.scale, self.bias, self.mean, self.var,
                         training, group=group)


class ConvBN(nn.Module):
    """conv -> BN -> relu, the CNN zoo's basic unit (``conv_bn_relu``)."""

    def __init__(self, kh: int, kw: int, cin: int, cout: int, dtype, device):
        super().__init__()
        self.conv = Conv(kh, kw, cin, cout, dtype, device)
        self.bn = BatchNorm(cout, device)

    def forward(self, x: Tensor, stride: int = 1, padding: str = "SAME",
                training: bool = False, group=None) -> Tensor:
        return F.relu(self.bn(self.conv(x, stride, padding), training,
                              group))


@torch.no_grad()
def init_weights(model: nn.Module,
                 generator: Optional[torch.Generator] = None) -> nn.Module:
    """Draw every ``Dense``, ``Embedding`` and ``Conv`` weight of ``model``
    from N(0, its ``init_scale``) with ``generator`` (on the model's
    device; default: one seeded 0), in the order the modules were made;
    biases and norms keep their constant fills."""
    if generator is None:
        dev = next(model.parameters()).device
        generator = torch.Generator(device=dev).manual_seed(0)
    for m in model.modules():
        if isinstance(m, (Dense, Conv)):
            m.weight.normal_(0.0, m.init_scale, generator=generator)
        elif isinstance(m, Embedding):
            m.table.normal_(0.0, m.init_scale, generator=generator)
    return model


# ------------------------------------------------------- from the JAX package
def to_tensor(a: Any) -> Tensor:
    """A writable tensor copy of a numpy array (``ml_dtypes.bfloat16``
    too, which torch cannot read directly)."""
    a = np.array(np.asarray(a), order="C")
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def state_from_jax(tree: Dict[str, Any], stacked: str = "b"
                   ) -> Dict[str, np.ndarray]:
    """A JAX zoo parameter tree (numpy leaves) as the port's state dict,
    ``{dotted name: array}``.  ``kernel`` leaves become ``weight``: a dense
    kernel ``[in, out]`` -> ``[out, in]``, a conv kernel HWIO -> OIHW.
    A list's items are numbered (``layers.3``); a key ``<p>rest`` holds
    the blocks ``<p><stacked>1``, ``<p><stacked>2``, ... stacked along
    its leading axis (ResNet's ``s0rest`` -> ``s0b1``, VGG's with
    ``stacked="c"``: ``s0c1``)."""
    out: Dict[str, np.ndarray] = {}

    def walk(node: Any, name: str) -> None:
        if isinstance(node, dict):
            for k, v in node.items():
                if k.endswith("rest"):
                    for j, block in enumerate(_unstack(v)):
                        walk(block, _join(name, f"{k[:-4]}{stacked}{j + 1}"))
                else:
                    walk(v, _join(name, k))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, _join(name, str(i)))
        else:
            a = np.asarray(node)
            head, _, leaf = name.rpartition(".")
            if leaf == "kernel":
                a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
                name = _join(head, "weight")
            out[name] = a

    walk(tree, "")
    return out


def _join(a: str, b: str) -> str:
    return f"{a}.{b}" if a else b


def _unstack(tree: Any) -> list:
    """A tree whose leaves are stacked along axis 0 -> a list of trees."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v) for k, v in tree.items()}
        n = len(next(iter(parts.values())))
        return [{k: v[i] for k, v in parts.items()} for i in range(n)]
    return list(np.asarray(tree))


@torch.no_grad()
def load_state(model: nn.Module, state: Dict[str, Any]) -> nn.Module:
    """Copy ``state`` (numpy arrays by dotted name, e.g. from
    :func:`state_from_jax`) into ``model``'s parameters and buffers, cast
    to their dtypes.  Every entry of the model's state dict must be given,
    with its shape, and nothing else."""
    own = model.state_dict()
    if set(own) != set(state):
        raise ValueError(
            f"state does not fit the model: missing "
            f"{sorted(set(own) - set(state))[:5]}, unexpected "
            f"{sorted(set(state) - set(own))[:5]}")
    for name, t in own.items():
        a = to_tensor(state[name])
        if tuple(a.shape) != tuple(t.shape):
            raise ValueError(f"{name}: shape {tuple(a.shape)} does not fit "
                             f"{tuple(t.shape)}")
        t.copy_(a.to(device=t.device, dtype=t.dtype))
    return model
