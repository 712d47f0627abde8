"""``chip_smoke.py`` phase 20 (``phase_scenario``) rehearsed on the CPU at
one gloo rank with ``tiny`` in place of ``1b`` and ``mini``
(``TUNE_CPU``): the committed ``storm-under-load`` spec replayed twice on
``ServeEngine`` (byte-identical rows, the CPU's digest, the engine-down
alert, every request finished, no token lost or repeated across the
redrive, no attention kernel launched), the grid trial at phase 5's rate
bitwise phase 5's losses (computed here as phase 5 computes them), the
loguniform run through the native GP, one ``distributed_trainable``
trial through the launcher, and ``probe_backend``'s reasons.  A failed
check raises."""

import os
import sys

import numpy as np
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch import serve
from horovod_tpu_torch.models import llama
from horovod_tpu_torch.ops import flash_attention as F

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402


def _phase5_losses(sz):
    """Phase 5's first steps (``phase_train``'s recipe) at the rehearsal's
    sizes."""
    hvd.init(device="cpu")
    cfg = llama.CONFIGS[sz["cfg"]]
    model = llama.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=0.01),
        named_parameters=model.named_parameters())
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    hvd.broadcast_optimizer_state(opt, root_rank=0)
    step = hvd.make_train_step(model, lambda m, ids: llama.loss_fn(
        m, ids, attn_fn=hvd.flash_attention, ce_chunks=8), opt)
    rng = np.random.RandomState(0)
    losses = [float(step(torch.from_numpy(rng.randint(
        0, cfg.vocab, (sz["batch"], sz["seq"] + 1), dtype=np.int32))))
        for _ in range(chip_smoke.TUNE_STEPS)]
    hvd.shutdown()
    return losses


def test_chip_smoke_scenario_phase_on_cpu():
    sz = chip_smoke.TUNE_CPU
    ref = _phase5_losses(sz)
    out = chip_smoke.phase_scenario(torch, np, hvd, llama, serve, F, "cpu",
                                    ref, 1.0, device_type="cpu", sizes=sz)
    assert out["launches_scenario"] == {n: 0 for n in chip_smoke.REPLACES}
    # the CPU runs each kernel's plain version, which counts no launch
    assert out["launches_tune"] == {n: 0 for n in chip_smoke.REPLACES}
    assert out["ticks"] > 0 and len(out["recovery"]) == 3
    assert not hvd.is_initialized()
