"""Quantized ring allreduce: int8 on the wire, fp32 accumulation.  The port
of ``horovod_tpu/ops/quantized.py`` (EQuARX, arxiv 2506.17615).

The allreduce is decomposed into its ring reduce-scatter and allgather
phases, and each hop's payload is quantized to int8 with a fresh per-chunk
scale, so the wire carries a quarter of an fp32 allreduce's bytes while
the accumulation stays fp32.  A ring of n ranks makes n-1 reduce-scatter
hops (each rank adds one incoming dequantized chunk per hop) and n-1
allgather hops (the fully reduced chunks circulate, still quantized).

Where the JAX package permutes over a mesh axis (``lax.ppermute``), the
port sends point to point over a process group: each hop posts its send
to the next rank and its receive from the previous one together, in one
``dist.batch_isend_irecv``.  The chunk's fp32 scale rides in the first
four bytes of the same int8 buffer, so a hop is one message each way.
The scale stays a device tensor: the ring never makes the host wait.

Arithmetic, as XLA compiles the JAX function for the CPU: the scale is
``max|x|`` times the fp32 reciprocal of 127 (XLA folds the division by
the constant into that product), the codes are ``round(x / scale)`` by a
true division (round half to even), clamped to +-127; the mean divides
by n as a product with the fp32 reciprocal of n; the fp32 encode error
``x - q * scale`` is exact (``int8_error``), as XLA's fused multiply-add
makes it.  A reduce-scatter hop adds ``q * scale`` into its chunk with
``addcmul``: on the CPU one fused multiply-add, as XLA contracts it; the
card's ``addcmul`` rounds the product first.  So the codec is bitwise
the JAX package's on the CPU and on the card, and the ring is bitwise
the JAX package's on the CPU; on the card every rank still decodes the
same bits.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

Group = Optional[dist.ProcessGroup]
_SCALE_BYTES = 4  # one fp32 scale in front of a hop's int8 codes


def reciprocal(n: float) -> float:
    """The fp32 reciprocal of ``n``: what XLA multiplies by where the JAX
    code divides by the constant ``n``."""
    return float(np.float32(1.0) / np.float32(n))


def _quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-chunk int8 of an fp32 tensor: q = round(x/scale),
    scale = max|x|/127 (floored at 1e-30), the scale a 0-dim fp32 tensor on
    ``x``'s device."""
    scale = torch.clamp_min(x.abs().amax() * reciprocal(127.0), 1e-30)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def int8_roundtrip(x: torch.Tensor) -> torch.Tensor:
    """``dequantize(quantize(x))``: the one-shot codec model of the int8
    wire.  The wire plane's error feedback (ops/wire.py) uses ``x -
    int8_roundtrip(x)`` as the rank-local compensable encode error."""
    q, scale = _quantize(x.to(torch.float32))
    return _dequantize(q, scale).to(x.dtype)


def int8_error(x: torch.Tensor) -> torch.Tensor:
    """``x - dequantize(quantize(x))`` of an fp32 tensor, exact: the value
    XLA computes as one fused multiply-add.  The exact residual (at most
    scale/2) fits in fp32, and so do ``q * hi`` and ``q * lo`` for the
    scale split into its top 16 and low 8 significand bits, so every
    operation below is exact and the result is the same bits on the CPU
    and on the card, whichever fuses a multiply-add."""
    q, scale = _quantize(x)
    hi = (scale.reshape(1).view(torch.int32) & -256).view(
        torch.float32).reshape(())
    qf = q.to(torch.float32)
    return (x - qf * hi) - qf * (scale - hi)


def _pack(q: torch.Tensor, scale: torch.Tensor, out: torch.Tensor) -> None:
    out[:_SCALE_BYTES].copy_(scale.reshape(1).view(torch.int8))
    out[_SCALE_BYTES:].copy_(q)


def _unpack(buf: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return buf[_SCALE_BYTES:], buf[:_SCALE_BYTES].view(
        torch.float32).reshape(())


def _exchange(send: torch.Tensor, recv: torch.Tensor, nxt: int, prv: int,
              group: Group) -> None:
    """Send ``send`` to global rank ``nxt`` and receive ``recv`` from
    ``prv``, both posted together."""
    ops = [dist.P2POp(dist.isend, send, nxt, group),
           dist.P2POp(dist.irecv, recv, prv, group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()


def quantized_ring_allreduce(x: torch.Tensor,
                             group: Union[Group, Sequence[Group]] = None,
                             average: bool = True) -> torch.Tensor:
    """Allreduce ``x`` over ``group`` (default: every rank) with int8 wire
    traffic; returns the mean (``average=True``, the gradient-sync
    convention) or the sum, as a new tensor in ``x``'s dtype.  A group of
    one rank returns ``x``.

    A sequence of groups runs one ring per group, in order: on a two-level
    layout, pass ``(cross_group, local_group)`` (the JAX package's
    ``('dcn.x', 'ici.x')`` tuple), so the cross-host ring runs first and
    on the full buffer, as the JAX form with a tuple of axes does."""
    if isinstance(group, (tuple, list)):
        total = 1
        out = x.to(torch.float32)
        for g in group:
            total *= dist.get_world_size(g)
            out = quantized_ring_allreduce(out, g, average=False)
        if average:
            out = out * reciprocal(total)
        return out.to(x.dtype)

    n = dist.get_world_size(group)
    if n == 1:
        return x
    idx = dist.get_rank(group)
    ranks = (list(range(n)) if group is None
             else dist.get_process_group_ranks(group))
    nxt, prv = ranks[(idx + 1) % n], ranks[(idx - 1) % n]

    flat = x.reshape(-1).to(torch.float32)
    numel = flat.numel()
    pad = (-numel) % n
    chunks = torch.cat([flat, flat.new_zeros(pad)]).view(n, -1)
    width = chunks.shape[1]
    send = torch.empty(_SCALE_BYTES + width, dtype=torch.int8,
                       device=x.device)
    recv = torch.empty_like(send)

    # Phase 1, reduce-scatter: at hop s rank r sends its running sum of
    # chunk (r - s) mod n and adds what it receives into chunk
    # (r - s - 1) mod n; after n-1 hops it holds the full sum of chunk
    # (r + 1) mod n.
    for step in range(n - 1):
        _pack(*_quantize(chunks[(idx - step) % n]), send)
        _exchange(send, recv, nxt, prv, group)
        q, scale = _unpack(recv)
        chunks[(idx - step - 1) % n].addcmul_(q.to(torch.float32), scale)

    # Phase 2, allgather: the reduced chunks circulate, quantized on the
    # wire.  The origin keeps the dequantized copy of its own chunk, so
    # every rank decodes the same values.
    own = (idx + 1) % n
    q0, scale0 = _quantize(chunks[own])
    out = torch.zeros_like(chunks)
    out[own] = _dequantize(q0, scale0)
    _pack(q0, scale0, send)
    for step in range(n - 1):
        _exchange(send, recv, nxt, prv, group)
        out[(idx - step) % n] = _dequantize(*_unpack(recv))
        send, recv = recv, send  # pass on what arrived

    total = out.view(-1)[:numel]
    if average:
        total = total * reciprocal(n)
    return total.reshape(x.shape).to(x.dtype)
