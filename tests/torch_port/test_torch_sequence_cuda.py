"""The flash ring (``parallel/sequence.py``) at one rank on a CUDA card,
against ``flash_attention``.  Every case carries the ``cuda`` marker and
skips without a card.  The file imports no JAX, so on a machine without it
run

    python -m pytest --noconftest -p no:cacheprovider tests/torch_port/test_torch_sequence_cuda.py
"""

import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.ops import flash_attention as F
from horovod_tpu_torch.parallel import sequence as SP


@pytest.mark.cuda
@pytest.mark.parametrize("S,H,HK,D", [(1024, 8, 2, 64), (512, 4, 4, 128),
                                      (256, 8, 4, 32)])
def test_one_rank_flash_ring_is_flash_attention(S, H, HK, D):
    """On a one-rank NCCL group the ring is one diagonal block: the same
    three kernel launches as ``flash_attention``, and bitwise the same
    output and gradients."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = hvd.init().device
    try:
        gen = torch.Generator(device=dev).manual_seed(0)
        mk = lambda *s: torch.randn(*s, generator=gen, device=dev).to(
            torch.bfloat16)
        q, k, v, do = mk(2, S, H, D), mk(2, S, HK, D), mk(2, S, HK, D), \
            mk(2, S, H, D)
        q, k, v = (t.requires_grad_() for t in (q, k, v))
        before = dict(F.LAUNCHES)
        out = SP.ring_attention(q, k, v, kernel="flash")
        grads = torch.autograd.grad(out, (q, k, v), do)
        torch.cuda.synchronize()
        assert all(F.LAUNCHES[n] == before[n] + 1 for n in F.LAUNCHES)
        ref = F.flash_attention(q, k, v)
        ref_grads = torch.autograd.grad(ref, (q, k, v), do)
        assert torch.equal(out, ref)
        for a, b in zip(grads, ref_grads):
            assert torch.equal(a, b)
    finally:
        hvd.shutdown()
