"""Sequence parallelism: Ulysses all-to-all attention and ring attention,
the port of ``horovod_tpu/parallel/sequence.py``.

Every rank of a process group (``group``; ``None``: the world) holds one
contiguous shard of the sequence, ``[B, S/n, H, D]``, rank i the positions
``[i * S/n, (i + 1) * S/n)``.  The JAX package runs these functions inside
``shard_map`` over an ``sp`` mesh axis; here a rank is a process and the
collectives are autograd ``Function``s over the group:

* :func:`all_to_all` (JAX's ``lax.all_to_all(..., tiled=True)``): split one
  axis into n chunks, send chunk j to rank j, concatenate what arrives
  along another axis in source-rank order; its backward is the inverse
  all-to-all.
* :func:`ring_shift`: send to rank ``idx + 1``, receive from ``idx - 1``
  (``lax.ppermute`` around the ring); its backward shifts the other way.

**Ulysses** (:func:`ulysses_attention`) trades the sequence shard for a head
shard with three all-to-alls, runs the plain ``layers.causal_attention``
over the whole sequence on H/n heads, and trades back with a fourth.

**Ring attention** (:func:`ring_attention`) keeps the sequence sharded: k/v
blocks travel the ring for n steps while each rank accumulates its queries'
attention with an online softmax.  ``kernel="xla"`` is the plain version
(``_block_attend``, fp32 statistics, offsets by block index, GQA repeated
up front).  ``kernel="flash"`` (causal only) runs each step through the
flash-attention kernels of ``ops/flash_attention.py`` (the Hopper kernels
on the card, their plain versions on the CPU) in one autograd ``Function``:

* the block from rank ``src`` is wholly visible (``src < idx``: the
  forward kernel with ``causal=False``), the diagonal (``src == idx``:
  ``causal=True``) or wholly masked (``src > idx``: skipped, no launch);
  partial results merge by their logsumexps in fp32;
* the backward computes ``delta = rowsum(dO * out)`` once from the global
  ``out``, and each block's dq and dk/dv kernels take the global ``lse``
  and ``delta``, so each block yields exactly its share of the gradient;
  dq accumulates locally in fp32, while the fp32 dk/dv accumulators travel
  with their k/v block and arrive home after n hops;
* GQA k/v ride the ring at their ``Hkv`` footprint.

Every rank posts the same exchanges in the same order, whether or not its
block was skipped, and the k/v shift after the last step (whose result
nothing reads) is not made.  In the flash ring the next step's k/v
exchange is posted before the current block's kernels, so the transfer
runs beside them.  The causal ring is unbalanced by design: rank r
attends r + 1 blocks.

:func:`sequence_loss_fn` is this rank's share of the global mean
next-token loss (the JAX long-context example's ``shard_loss``): summing
the ranks' gradients (``op=Sum``) gives the gradient of the global loss.
"""

from __future__ import annotations

import functools
import math
from typing import List, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from ..models import layers as L
from ..ops import flash_attention as F

Tensor = torch.Tensor


def _group(group):
    return dist.group.WORLD if group is None else group


# ----------------------------------------------------------- collectives
def _all_to_all(x: Tensor, split_axis: int, concat_axis: int, group
                ) -> Tensor:
    n = dist.get_world_size(group)
    if x.shape[split_axis] % n:
        raise ValueError(f"all_to_all: axis {split_axis} of size "
                         f"{x.shape[split_axis]} not divisible by {n}")
    send = torch.stack(x.chunk(n, dim=split_axis))
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return torch.cat(recv.unbind(0), dim=concat_axis)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_axis, concat_axis, group):
        ctx.axes, ctx.group = (split_axis, concat_axis), group
        return _all_to_all(x, split_axis, concat_axis, group)

    @staticmethod
    def backward(ctx, g):
        split_axis, concat_axis = ctx.axes
        return (_all_to_all(g.contiguous(), concat_axis, split_axis,
                            ctx.group), None, None, None)


def all_to_all(x: Tensor, split_axis: int, concat_axis: int,
               group=None) -> Tensor:
    """JAX's tiled ``all_to_all`` over ``group``: ``x`` split into n chunks
    along ``split_axis``, chunk j sent to rank j, the received chunks
    concatenated along ``concat_axis`` in source-rank order.
    Differentiable (the backward is the inverse all-to-all)."""
    g = _group(group)
    if dist.get_world_size(g) == 1:
        return x
    return _AllToAll.apply(x, split_axis, concat_axis, g)


def _post_shift(xs: Sequence[Tensor], group, back: bool = False):
    """Post one batch that sends each of ``xs`` to rank ``idx + 1`` (``idx -
    1`` when ``back``) and receives as many tensors from the other side;
    returns ``(works, received)``."""
    n, idx = dist.get_world_size(group), dist.get_rank(group)
    nxt = dist.get_global_rank(group, (idx + 1) % n)
    prv = dist.get_global_rank(group, (idx - 1) % n)
    if back:
        nxt, prv = prv, nxt
    outs, ops = [], []
    for x in xs:
        x = x.contiguous()
        out = torch.empty_like(x)
        ops += [dist.P2POp(dist.isend, x, nxt, group),
                dist.P2POp(dist.irecv, out, prv, group)]
        outs.append(out)
    return dist.batch_isend_irecv(ops), outs


def _finish(posted) -> List[Tensor]:
    works, outs = posted
    for work in works:
        work.wait()
    return outs


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        return tuple(_finish(_post_shift(xs, group)))

    @staticmethod
    def backward(ctx, *gs):
        return (None, *_finish(_post_shift(gs, ctx.group, back=True)))


def ring_shift(*xs: Tensor, group=None) -> Tuple[Tensor, ...]:
    """Each of ``xs`` sent to rank ``idx + 1`` of ``group``, what rank
    ``idx - 1`` sent received in its place (one batch of point-to-point
    operations).  Differentiable: the backward shifts to ``idx - 1``."""
    g = _group(group)
    if dist.get_world_size(g) == 1:
        return xs
    return _RingShift.apply(g, *xs)


# --------------------------------------------------------------- Ulysses
def ulysses_attention(q: Tensor, k: Tensor, v: Tensor, group=None,
                      causal: bool = True) -> Tensor:
    """Attention over sequence-sharded ``q``/``k``/``v`` (``[B, S/n, H,
    D]`` per rank): all-to-all to ``[B, S, H/n, D]``, the plain attention
    over the whole sequence on this rank's heads, and back."""
    n = dist.get_world_size(_group(group))
    H = q.shape[2]
    if H % n != 0:
        raise ValueError(f"heads {H} not divisible by sp axis size {n}")
    qh, kh, vh = (all_to_all(t, 2, 1, group) for t in (q, k, v))
    o = L.causal_attention(qh, kh, vh, causal=causal)
    return all_to_all(o, 1, 2, group)


# ------------------------------------------------------ plain ring (xla)
def _block_attend(q, k, v, q_off: int, k_off: int, causal: bool, m, l, o):
    """One online-softmax step against a k/v block.  q ``[B, Sq, H, D]``,
    k/v ``[B, Sk, H, D]``, m/l ``[B, H, Sq]`` fp32, o like q in fp32;
    returns the updated ``(m, l, o)``."""
    Sq, D = q.shape[1], q.shape[3]
    Sk = k.shape[1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * (
        1.0 / math.sqrt(D))
    if causal:
        qi = q_off + torch.arange(Sq, device=q.device)
        ki = k_off + torch.arange(Sk, device=q.device)
        keep = qi[:, None] >= ki[None, :]
        logits = torch.where(keep, logits, torch.full_like(logits, -1e30))
    m_new = torch.maximum(m, logits.amax(-1))
    p = torch.exp(logits - m_new[..., None])
    alpha = torch.exp(m - m_new)
    l_new = l * alpha + p.sum(-1)
    pv = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)
    o_new = o * alpha.transpose(1, 2)[..., None].to(o.dtype) + pv
    return m_new, l_new, o_new


def _ring_plain(q, k, v, group, causal: bool) -> Tensor:
    n, idx = dist.get_world_size(group), dist.get_rank(group)
    B, Sq, H, D = q.shape
    if k.shape[2] != H:
        rep = H // k.shape[2]
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    Sk = k.shape[1]
    m = torch.full((B, H, Sq), -math.inf, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, H, Sq), dtype=torch.float32, device=q.device)
    o = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    kk, vv = k, v
    for step in range(n):
        src = (idx - step) % n  # the block that started on rank src
        m, l, o = _block_attend(q, kk, vv, idx * Sq, src * Sk, causal, m, l,
                                o)
        if step < n - 1:
            kk, vv = ring_shift(kk, vv, group=group)
    out = o / l.clamp_min(1e-30).transpose(1, 2)[..., None]
    return out.to(q.dtype)


# ------------------------------------------------------------ flash ring
def _lse_merge(o, lse, o2, lse2):
    """Two partial attentions over disjoint key sets, combined by their
    logsumexps in fp32."""
    lse_new = torch.logaddexp(lse, lse2)
    # clamp the subtrahend so an all-masked (-inf) pair weighs 0, not nan
    safe = lse_new.clamp_min(-1e30)
    w1 = torch.exp(lse - safe).transpose(1, 2)[..., None]
    w2 = torch.exp(lse2 - safe).transpose(1, 2)[..., None]
    return o.float() * w1 + o2.float() * w2, lse_new


class _RingFlash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, group):
        n, idx = dist.get_world_size(group), dist.get_rank(group)
        o = lse = None
        kk, vv = k, v
        for step in range(n):
            src = (idx - step) % n
            posted = _post_shift([kk, vv], group) if step < n - 1 else None
            if src <= idx:  # src > idx: wholly masked, nothing to add
                o2, lse2 = F.attention_forward(q, kk, vv, causal=src == idx)
                if o is None:  # step 0, the diagonal
                    o, lse = o2.float(), lse2
                else:
                    o, lse = _lse_merge(o, lse, o2, lse2)
            if posted is not None:
                kk, vv = _finish(posted)
        out = o.to(q.dtype)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.group = group
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        group = ctx.group
        n, idx = dist.get_world_size(group), dist.get_rank(group)
        do = g.contiguous()
        # from the global out: each block's kernels rebuild p = exp(s - lse)
        # with the global lse, so a block yields exactly its share
        delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
        dq = dkk = dvv = None
        kk, vv = k, v
        for step in range(n):
            src = (idx - step) % n
            posted = _post_shift([kk, vv], group) if step < n - 1 else None
            if src <= idx:
                causal = src == idx
                dq_b = F.attention_dq(q, kk, vv, do, lse, delta, causal)
                dk_b, dv_b = F.attention_dkv(q, kk, vv, do, lse, delta,
                                             causal)
                if dq is None:  # step 0: this rank's own block
                    dq, dkk, dvv = dq_b.float(), dk_b.float(), dv_b.float()
                else:
                    dq = dq + dq_b.float()
                    dkk = dkk + dk_b.float()
                    dvv = dvv + dv_b.float()
            if n > 1:  # the accumulators travel with their block
                dkk, dvv = _finish(_post_shift([dkk, dvv], group))
            if posted is not None:
                kk, vv = _finish(posted)
        return dq.to(q.dtype), dkk.to(k.dtype), dvv.to(v.dtype), None


def ring_attention(q: Tensor, k: Tensor, v: Tensor, group=None,
                   causal: bool = True, kernel: str = "xla",
                   block_q: int = 256, block_k: int = 256) -> Tensor:
    """Ring attention over a sequence-sharded batch, ``[B, S/n, H, D]`` per
    rank.  ``kernel="flash"`` runs each step through the flash-attention
    kernels (causal only; GQA k/v ride the ring unrepeated, and S/n must
    divide ``block_q``/``block_k`` as for ``flash_attention``); the default
    ``"xla"`` is the plain online softmax with GQA repeated up front."""
    g = _group(group)
    if kernel == "flash":
        if not causal:
            raise NotImplementedError(
                "flash ring path is causal-only (the 3-way block split "
                "relies on it); use kernel='xla' for bidirectional")
        F._check_gqa(q.shape[2], k.shape[2])
        F._resolve_blocks(q.shape[1], block_q, block_k)
        return _RingFlash.apply(q.contiguous(), k.contiguous(),
                                v.contiguous(), g)
    if kernel != "xla":
        raise ValueError(f"unknown ring attention kernel {kernel!r}")
    return _ring_plain(q, k, v, g, causal)


def make_ring_attn_fn(group=None, causal: bool = True, kernel: str = "xla",
                      block_q: int = 256, block_k: int = 256):
    """The ``attn_fn`` hook of ``llama.Llama.forward`` for ring attention
    over ``group`` (``kernel="flash"``: the flash kernels per step)."""
    return functools.partial(ring_attention, group=group, causal=causal,
                             kernel=kernel, block_q=block_q,
                             block_k=block_k)


def make_ulysses_attn_fn(group=None, causal: bool = True):
    """The ``attn_fn`` hook for Ulysses attention over ``group``."""
    return functools.partial(ulysses_attention, group=group, causal=causal)


def sequence_loss_fn(model, inp: Tensor, tgt: Tensor, attn_fn=None,
                     group=None, ce_chunks: int = 0,
                     remat: bool = False) -> Tensor:
    """This rank's share of the global mean next-token loss of a
    sequence-sharded batch: ``inp``/``tgt`` ``[B, S/n]`` are this rank's
    shard of the inputs and their targets, RoPE runs at the shard's global
    offset, and the NLL sum is divided by the global count ``B * S``, so
    the ranks' losses (and gradients) sum to the global ones.
    ``ce_chunks`` runs the lm_head and the loss in chunks, as
    ``llama.loss_fn`` does."""
    from ..models import llama
    g = _group(group)
    n, idx = dist.get_world_size(g), dist.get_rank(g)
    B, S = inp.shape
    h = model(inp, attn_fn=attn_fn, remat=remat, return_hidden=True,
              pos_offset=idx * S)
    if ce_chunks:
        if S % ce_chunks:
            raise ValueError(f"seq {S} not divisible by ce_chunks="
                             f"{ce_chunks}")
        c = S // ce_chunks
        total = sum(checkpoint(llama._chunk_nll, model.lm_head.weight,
                               h[:, i * c:(i + 1) * c],
                               tgt[:, i * c:(i + 1) * c], use_reentrant=False)
                    for i in range(ce_chunks))
    else:
        total = L.softmax_cross_entropy(model.lm_head(h), tgt).sum()
    return total / (B * S * n)


__all__ = ["all_to_all", "ring_shift", "ulysses_attention", "ring_attention",
           "make_ring_attn_fn", "make_ulysses_attn_fn", "sequence_loss_fn"]
