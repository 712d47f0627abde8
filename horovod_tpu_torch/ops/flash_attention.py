"""Flash attention: the port of ``horovod_tpu/ops/flash_attention.py``.

``flash_attention(q, k, v, causal, block_q, block_k)`` keeps the JAX
function's signature and layout (``[B, S, H, D]``, grouped-query attention
when k/v carry fewer heads).  It is a ``torch.autograd.Function``: the
forward saves ``(q, k, v, out, lse)``; the backward computes
``delta = sum_d dO * O`` in plain torch, as the JAX wrapper does outside its
kernels, then runs the dq pass and the dk/dv pass.

Each of the three passes has two implementations side by side:

* a hand-written CUDA kernel for Hopper (``csrc/flash_attention.cu``;
  for bf16 all three are tensor-core kernels with register accumulators
  and pipelined loads), which replaces one Pallas TPU kernel:

  ====================  ==========================================
  ``flash_forward_cuda``  ``_attn_kernel``     (``_flash_forward``)
  ``flash_dq_cuda``       ``_bwd_dq_kernel``   (``_flash_backward``)
  ``flash_dkv_cuda``      ``_bwd_dkv_kernel``  (``_flash_backward``)
  ====================  ==========================================

* a plain PyTorch version written from the same equations
  (``attention_forward_plain``, ``attention_dq_plain``,
  ``attention_dkv_plain``): the same ``NEG_INF``, fp32 scores scaled after
  the product, ``p`` and ``ds`` rounded to the input dtype before their
  products, dk/dv summed over each GQA group in fp32.

A tensor on the CPU takes the plain version.  Any other tensor takes the
kernel, which launches or raises: there is no fallback.  Each kernel
wrapper adds one to ``LAUNCHES[name]`` where it launches.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from . import _kernels

NEG_INF = -1e30

# Launch counts of the three kernels, by kernel name.
LAUNCHES: Dict[str, int] = {"flash_fwd": 0, "flash_bwd_dq": 0,
                            "flash_bwd_dkv": 0}

Tensor = torch.Tensor


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _resolve_blocks(S: int, block_q: int, block_k: int) -> Tuple[int, int]:
    block_q = min(block_q, S)
    block_k = min(block_k, S)
    if S % block_q or S % block_k:
        raise ValueError(f"seq len {S} must divide block sizes "
                         f"({block_q}, {block_k})")
    return block_q, block_k


def _check_gqa(H: int, HK: int) -> int:
    if H % HK:
        raise ValueError(
            f"q heads ({H}) must be a multiple of kv heads ({HK}) for GQA")
    return H // HK


# ------------------------------------------------------------ plain versions
def _scores(q: Tensor, k: Tensor, causal: bool) -> Tensor:
    """Scaled fp32 scores ``[B, HK, G, S, S]`` (G = q-heads per kv-head),
    masked with NEG_INF above the diagonal when causal."""
    B, S, H, D = q.shape
    HK = k.shape[2]
    qg = q.reshape(B, S, HK, H // HK, D).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * (1.0 / D ** 0.5)
    if causal:
        keep = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, NEG_INF)
    return s


def _grouped_rows(x: Tensor, HK: int) -> Tensor:
    """``[B, H, S]`` row statistics as ``[B, HK, G, S, 1]``."""
    B, H, S = x.shape
    return x.reshape(B, HK, H // HK, S, 1)


def attention_forward_plain(q: Tensor, k: Tensor, v: Tensor,
                            causal: bool = True) -> Tuple[Tensor, Tensor]:
    """``(out [B,S,H,D] in q.dtype, lse [B,H,S] fp32)`` - what
    ``_attn_kernel`` computes, without the blockwise walk."""
    B, S, H, D = q.shape
    HK = k.shape[2]
    _check_gqa(H, HK)
    s = _scores(q, k, causal)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bhgqk,bkhd->bhgqd", p.to(q.dtype).float(), v.float()) / l
    out = o.permute(0, 3, 1, 2, 4).reshape(B, S, H, D).to(q.dtype)
    lse = (m + torch.log(l)).reshape(B, H, S)
    return out, lse


def _probs_and_ds(q, k, v, do, lse, delta, causal):
    B, S, H, D = q.shape
    HK = k.shape[2]
    _check_gqa(H, HK)
    s = _scores(q, k, causal)
    p = torch.exp(s - _grouped_rows(lse, HK))
    dog = do.reshape(B, S, HK, H // HK, D).float()
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dog, v.float())
    ds = (p * (dp - _grouped_rows(delta, HK))).to(q.dtype).float()
    return p, ds, dog


def attention_dq_plain(q: Tensor, k: Tensor, v: Tensor, do: Tensor,
                       lse: Tensor, delta: Tensor,
                       causal: bool = True) -> Tensor:
    """dq ``[B,S,H,D]`` in q.dtype - what ``_bwd_dq_kernel`` computes."""
    B, S, H, D = q.shape
    _, ds, _ = _probs_and_ds(q, k, v, do, lse, delta, causal)
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, k.float()) * (1.0 / D ** 0.5)
    return dq.reshape(B, S, H, D).to(q.dtype)


def attention_dkv_plain(q: Tensor, k: Tensor, v: Tensor, do: Tensor,
                        lse: Tensor, delta: Tensor,
                        causal: bool = True) -> Tuple[Tensor, Tensor]:
    """``(dk, dv)`` ``[B,S,HK,D]`` in the input dtype - what
    ``_bwd_dkv_kernel`` computes, with its wrapper's fp32 group sum."""
    B, S, H, D = q.shape
    HK = k.shape[2]
    p, ds, dog = _probs_and_ds(q, k, v, do, lse, delta, causal)
    qg = q.reshape(B, S, HK, H // HK, D).float()
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p.to(q.dtype).float(), dog)
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qg) * (1.0 / D ** 0.5)
    return dk.to(k.dtype), dv.to(v.dtype)


# ----------------------------------------------------------- kernel wrappers
_KERNEL_DTYPES = (torch.bfloat16, torch.float32)
_KERNEL_HEAD_DIMS = (32, 64, 128)


def kernel_tile(dtype: torch.dtype) -> int:
    """The kernels' sequence granule: S must be a multiple.  (The bf16
    forward and dk/dv kernels tile by 128 rows and mask a last tile of 64.)"""
    return 64 if dtype == torch.bfloat16 else 32


def kernel_shapes(q_shape, k_shape, v_shape,
                  dtype: torch.dtype) -> Tuple[int, int, int, int, int]:
    """The shapes the three kernels take, as a pure function of the shapes
    and the dtype: ``(B, S, H, HK, D)``, or ValueError."""
    if dtype not in _KERNEL_DTYPES:
        raise ValueError(f"flash attention kernel takes bf16 or fp32, "
                         f"not {dtype}")
    if len(q_shape) != 4 or len(k_shape) != 4 or tuple(k_shape) != tuple(
            v_shape):
        raise ValueError("flash attention kernel: q must be [B,S,H,D] and "
                         "k, v [B,S,HK,D]")
    B, S, H, D = q_shape
    HK = k_shape[2]
    if k_shape[0] != B or k_shape[1] != S or k_shape[3] != D:
        raise ValueError(f"flash attention kernel: k/v shape {tuple(k_shape)}"
                         f" does not match q {tuple(q_shape)}")
    _check_gqa(H, HK)
    if D not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"flash attention kernel: head dim {D} not in "
                         f"{_KERNEL_HEAD_DIMS}")
    tile = kernel_tile(dtype)
    if S % tile:
        raise ValueError(f"flash attention kernel: seq len {S} is not a "
                         f"multiple of its {tile}-row tile")
    return B, S, H, HK, D


def _check_kernel_inputs(q: Tensor, k: Tensor, v: Tensor,
                         *rest: Tensor) -> Tuple[int, int, int, int, int]:
    for name, t in (("q", q), ("k", k), ("v", v)) + tuple(
            (f"arg{i}", t) for i, t in enumerate(rest)):
        if not t.is_cuda:
            raise ValueError(f"flash attention kernel: {name} is on "
                             f"{t.device}, not a CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"flash attention kernel: {name} is not "
                             "contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"flash attention kernel: {name} is not 16-byte "
                             "aligned")
        if t.device != q.device:
            raise ValueError("flash attention kernel: inputs on different "
                             "devices")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("flash attention kernel: q, k, v dtypes differ")
    return kernel_shapes(q.shape, k.shape, v.shape, q.dtype)


def _check_rows(B: int, H: int, S: int, *rows: Tensor) -> None:
    for t in rows:
        if t.dtype != torch.float32 or tuple(t.shape) != (B, H, S):
            raise ValueError("flash attention kernel: lse/delta must be fp32 "
                             f"[B,H,S] = {(B, H, S)}, got {t.dtype} "
                             f"{tuple(t.shape)}")


def _stream(t: Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def flash_forward_cuda(q: Tensor, k: Tensor, v: Tensor,
                       causal: bool = True) -> Tuple[Tensor, Tensor]:
    """The forward kernel (replaces ``_attn_kernel``): ``(out, lse)``."""
    lib = _kernels.load()
    B, S, H, HK, D = _check_kernel_inputs(q, k, v)
    out = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = lib.hvd_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                out.data_ptr(), lse.data_ptr(), B, S, H, HK,
                                D, int(causal), int(q.dtype == torch.bfloat16),
                                _stream(q))
    _kernels.check(lib, err, "flash attention forward kernel")
    LAUNCHES["flash_fwd"] += 1
    return out, lse


def flash_dq_cuda(q: Tensor, k: Tensor, v: Tensor, do: Tensor, lse: Tensor,
                  delta: Tensor, causal: bool = True) -> Tensor:
    """The dq kernel (replaces ``_bwd_dq_kernel``)."""
    lib = _kernels.load()
    B, S, H, HK, D = _check_kernel_inputs(q, k, v, do, lse, delta)
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError("flash attention kernel: dO must match q")
    _check_rows(B, H, S, lse, delta)
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = lib.hvd_flash_bwd_dq(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                   do.data_ptr(), lse.data_ptr(),
                                   delta.data_ptr(), dq.data_ptr(), B, S, H,
                                   HK, D, int(causal),
                                   int(q.dtype == torch.bfloat16), _stream(q))
    _kernels.check(lib, err, "flash attention dq kernel")
    LAUNCHES["flash_bwd_dq"] += 1
    return dq


def flash_dkv_cuda(q: Tensor, k: Tensor, v: Tensor, do: Tensor, lse: Tensor,
                   delta: Tensor, causal: bool = True) -> Tuple[Tensor, Tensor]:
    """The dk/dv kernel (replaces ``_bwd_dkv_kernel`` and its wrapper's
    group sum): ``(dk, dv)`` in the input dtype."""
    lib = _kernels.load()
    B, S, H, HK, D = _check_kernel_inputs(q, k, v, do, lse, delta)
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError("flash attention kernel: dO must match q")
    _check_rows(B, H, S, lse, delta)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    with torch.cuda.device(q.device):
        err = lib.hvd_flash_bwd_dkv(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                    do.data_ptr(), lse.data_ptr(),
                                    delta.data_ptr(), dk.data_ptr(),
                                    dv.data_ptr(), B, S, H, HK, D,
                                    int(causal), int(q.dtype == torch.bfloat16),
                                    _stream(q))
    _kernels.check(lib, err, "flash attention dk/dv kernel")
    LAUNCHES["flash_bwd_dkv"] += 1
    return dk, dv


# ------------------------------------------------------------------ dispatch
def _on_cpu(t: Tensor) -> bool:
    return t.device.type == "cpu"


def attention_forward(q, k, v, causal=True):
    if _on_cpu(q):
        return attention_forward_plain(q, k, v, causal)
    return flash_forward_cuda(q, k, v, causal)


def attention_dq(q, k, v, do, lse, delta, causal=True):
    if _on_cpu(q):
        return attention_dq_plain(q, k, v, do, lse, delta, causal)
    return flash_dq_cuda(q, k, v, do, lse, delta, causal)


def attention_dkv(q, k, v, do, lse, delta, causal=True):
    if _on_cpu(q):
        return attention_dkv_plain(q, k, v, do, lse, delta, causal)
    return flash_dkv_cuda(q, k, v, do, lse, delta, causal)


# The attention leg of ``perf/costmodel.py`` ``compiled_flops``: while an
# ``AttentionTally`` is installed here, each call of the Function below
# adds its matrix-product FLOPs to it (a FLOP counter cannot see the
# kernels behind ctypes) and what the counter saw inside the call.
FLOP_TALLY = None


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal):
        tally = FLOP_TALLY
        before = tally.enter() if tally is not None else 0
        out, lse = attention_forward(q, k, v, causal)
        if tally is not None:
            tally.leave("flash_fwd", q.shape, causal, before)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        tally = FLOP_TALLY
        before = tally.enter() if tally is not None else 0
        do = g.contiguous()
        # delta_i = sum_d dO_i * O_i, the softmax-jacobian row correction
        delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
        dq = attention_dq(q, k, v, do, lse, delta, ctx.causal)
        if tally is not None:
            tally.leave("flash_bwd_dq", q.shape, ctx.causal, before)
            before = tally.enter()
        dk, dv = attention_dkv(q, k, v, do, lse, delta, ctx.causal)
        if tally is not None:
            tally.leave("flash_bwd_dkv", q.shape, ctx.causal, before)
        return dq, dk, dv, None


def flash_attention(q: Tensor, k: Tensor, v: Tensor, causal: bool = True,
                    block_q: int = 256, block_k: int = 256) -> Tensor:
    """Blockwise attention, model layout ``[B, S, H, D]`` with GQA.

    ``block_q``/``block_k`` are checked as the JAX function checks them (S
    must divide both); the Hopper kernels tile by their own sizes
    (``kernel_tile``)."""
    _check_gqa(q.shape[2], k.shape[2])
    _resolve_blocks(q.shape[1], block_q, block_k)
    return _FlashAttention.apply(q.contiguous(), k.contiguous(),
                                 v.contiguous(), causal)
