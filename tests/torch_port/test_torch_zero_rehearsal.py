"""The ``--ranks N`` rehearsal's ZeRO loss checks on the CPU
(``chip_smoke.rank_zero``): the microbatched configurations are held to
the bound ``zero_cpu_bound`` measures from bf16 rounding at this depth,
and level 2 at k=2 is held in fp32 to k=1 within ``ZERO_FP32_K_TOL``.

Why (measured on the four-rank rehearsal, ``tiny``, 4 x 32 a rank): level
2 at k=2 in bf16 compute read up to 1.17e-3 off the none wire
configuration's k=1 losses, above the card's 1e-3, while it was bitwise
equal to ``DistributedOptimizer`` at k=2 and, in fp32, within 4.8e-7 (one
ulp of a loss near 6) of level 2 at k=1.  The JAX chain holds the port's
level 2 at k=2 on the same weights and tokens
(``test_torch_zero_gloo.py::test_tiny_llama_microbatched_matches_jax``).

Here, on one rank in this process: the checks pass on the port's k=2 path
and fail on two broken copies of it, one that drops the second
microbatch (the first seen twice) and one that counts the first
microbatch twice; each broken copy fails both the fp32 check and the
bf16 bound."""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import horovod_tpu_torch as hvd  # noqa: E402
from horovod_tpu_torch.models import llama  # noqa: E402
from horovod_tpu_torch.ops import flash_attention as F  # noqa: E402
from horovod_tpu_torch.parallel import zero as Z  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)
import chip_smoke as C  # noqa: E402

ROWS, SEQ = 4, 32


@pytest.fixture
def rank():
    hvd.shutdown()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    dev = hvd.init(device="cpu").device
    try:
        yield dev
    finally:
        hvd.shutdown()
        torch.set_num_threads(threads)


def _tokens():
    cfg = llama.CONFIGS["tiny"]
    return cfg, C.zero_tokens(np, cfg.vocab, ROWS, SEQ,
                              C.WARMUP_STEPS + C.TIMED_STEPS + 1)


def _ref(dev):
    return C.rank_wire(torch, np, hvd, llama, F, 0, 1, dev, "tiny", ROWS,
                       SEQ, "none", 1, dict(wire_policy="none",
                                            error_feedback=True), None)


def _l2_k2(dev, cfg, tokens):
    return C.zero_run(torch, np, hvd, llama, F, dev, 0, 1, cfg, tokens, ROWS,
                      2, k=2, warmup=C.WARMUP_STEPS, profile=True)["losses"]


def _broken(monkeypatch, how):
    """Level 2's step built to drop microbatch 1 (its ids replaced by
    microbatch 0's) or to count microbatch 0 twice."""
    real = Z.make_zero_train_step

    def make(model, loss_fn, state, **kw):
        k = kw.get("backward_passes_per_step", 1)
        if k == 1:
            return real(model, loss_fn, state, **kw)
        calls = [0]

        def counted(m, ids):
            first = calls[0] % k == 0
            calls[0] += 1
            loss = loss_fn(m, ids)
            return loss * 2 if how == "double" and first else loss

        step = real(model, counted, state, **kw)
        if how == "drop":
            return lambda ids: step(torch.stack([ids[0]] * k))
        return step

    monkeypatch.setattr(Z, "make_zero_train_step", make)


def test_the_checks_pass_on_the_k2_path(rank):
    cfg, tokens = _tokens()
    ref = _ref(rank)
    tol = C.zero_cpu_bound(torch, np, hvd, llama, F, rank, 0, 1, cfg, tokens,
                           ROWS, ref)
    assert tol >= C.ZERO_LOSS_TOL
    C.zero_gaps("L2 k=2", _l2_k2(rank, cfg, tokens), ref, tol)


@pytest.mark.parametrize("how", ["drop", "double"])
def test_the_checks_catch_a_broken_k2_path(rank, monkeypatch, how):
    cfg, tokens = _tokens()
    ref = _ref(rank)
    tol = C.zero_cpu_bound(torch, np, hvd, llama, F, rank, 0, 1, cfg, tokens,
                           ROWS, ref)
    _broken(monkeypatch, how)
    with pytest.raises(RuntimeError, match=r"zero \[L2 k=2 fp32\]"):
        C.zero_cpu_bound(torch, np, hvd, llama, F, rank, 0, 1, cfg, tokens,
                         ROWS, ref)
    with pytest.raises(RuntimeError, match=r"zero \[L2 k=2\]: losses"):
        C.zero_gaps("L2 k=2", _l2_k2(rank, cfg, tokens), ref, tol)
