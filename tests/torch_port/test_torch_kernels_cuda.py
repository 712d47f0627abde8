"""The port's flash-attention kernels against their plain PyTorch versions
on a CUDA card.  Every case carries the ``cuda`` marker and skips without a
card.  The file imports no JAX, so on a machine without it run

    python -m pytest --noconftest -p no:cacheprovider tests/torch_port/test_torch_kernels_cuda.py
"""

import pytest
import torch

from horovod_tpu_torch.ops import flash_attention as F


def tile_rel_err(got, ref, tile=64):
    """Worst relative Frobenius error over blocks of ``tile`` sequence
    positions of one head of one batch entry (``[B, S, H, D]``): unlike an
    error scaled by the largest value, it sees a dropped or mis-masked tile
    anywhere along a causal sequence."""
    B, S, H, D = ref.shape
    r = ref.float().reshape(B, S // tile, tile, H, D)
    d = got.float().reshape(B, S // tile, tile, H, D) - r
    return (d.norm(dim=(2, 4)) / r.norm(dim=(2, 4)).clamp_min(1e-30)).max()


def _inputs(dtype, B, S, H, HK, D):
    gen = torch.Generator(device="cuda").manual_seed(0)
    mk = lambda *s: torch.randn(*s, generator=gen, device="cuda").to(dtype)
    return mk(B, S, H, D), mk(B, S, HK, D), mk(B, S, HK, D), mk(B, S, H, D)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,D,causal,H,HK,S", [
    (torch.bfloat16, 64, True, 8, 2, 512),
    (torch.bfloat16, 128, False, 4, 4, 512),
    (torch.float32, 64, False, 4, 2, 512),
    (torch.float32, 128, True, 2, 1, 512),
    # S a multiple of 64 but not of the bf16 kernels' 128-row tiles
    (torch.bfloat16, 64, True, 8, 2, 192),
    (torch.bfloat16, 64, True, 8, 4, 320),
    # GQA groups of 1 and 8
    (torch.bfloat16, 64, True, 4, 4, 512),
    (torch.bfloat16, 64, True, 16, 2, 512),
    (torch.bfloat16, 128, True, 8, 2, 1024),
])
def test_kernels_match_plain_on_card(dtype, D, causal, H, HK, S):
    """Each kernel against its plain version on the same tensors (which
    rounds p and ds to bf16 as the kernels do): the max error within 1e-2
    (bf16) or 1e-5 (fp32) of the reference's largest magnitude, and the
    relative error of every 64-position tile of every head within the same
    limit; lse to atol 1e-3 (bf16) or 1e-4 (fp32)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    q, k, v, do = _inputs(dtype, 2, S, H, HK, D)
    before = dict(F.LAUNCHES)
    out, lse = F.flash_forward_cuda(q, k, v, causal)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    dq = F.flash_dq_cuda(q, k, v, do, lse, delta, causal)
    dk, dv = F.flash_dkv_cuda(q, k, v, do, lse, delta, causal)
    torch.cuda.synchronize()
    assert all(F.LAUNCHES[n] == before[n] + 1 for n in F.LAUNCHES)
    r_out, r_lse = F.attention_forward_plain(q, k, v, causal)
    r_dk, r_dv = F.attention_dkv_plain(q, k, v, do, lse, delta, causal)
    pairs = [("out", out, r_out),
             ("dq", dq, F.attention_dq_plain(q, k, v, do, lse, delta, causal)),
             ("dk", dk, r_dk), ("dv", dv, r_dv)]
    lse_tol = 1e-3 if dtype == torch.bfloat16 else 1e-4
    assert (lse - r_lse).abs().max().item() <= lse_tol
    limit = 1e-2 if dtype == torch.bfloat16 else 1e-5
    for name, got, ref in pairs:
        err = (got.float() - ref.float()).abs().max().item()
        assert err <= limit * ref.float().abs().max().item(), (name, err)
        assert tile_rel_err(got, ref).item() <= limit, name


@pytest.mark.cuda
def test_dkv_kernel_is_deterministic():
    """dk/dv has one writer per tile and no atomics: two launches on the
    same inputs give bitwise-equal results."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    q, k, v, do = _inputs(torch.bfloat16, 2, 1024, 16, 4, 64)
    out, lse = F.flash_forward_cuda(q, k, v, True)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    first = F.flash_dkv_cuda(q, k, v, do, lse, delta, True)
    second = F.flash_dkv_cuda(q, k, v, do, lse, delta, True)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
def test_dq_kernel_is_deterministic():
    """dq has one writer per tile and no atomics: two launches on the same
    inputs give bitwise-equal results."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    q, k, v, do = _inputs(torch.bfloat16, 2, 1024, 16, 4, 64)
    out, lse = F.flash_forward_cuda(q, k, v, True)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    first = F.flash_dq_cuda(q, k, v, do, lse, delta, True)
    second = F.flash_dq_cuda(q, k, v, do, lse, delta, True)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
def test_kernel_rejects_unsupported_head_dim():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    q = torch.zeros(1, 64, 2, 48, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        F.flash_forward_cuda(q, q, q)
