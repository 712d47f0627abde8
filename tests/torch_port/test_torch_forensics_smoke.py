"""``chip_smoke.py``'s forensics phases rehearsed on the CPU, every check of
the card's run with ``tiny`` standing in for ``1b``: phase 17
(``phase_forensics``: the sentinel-wrapped step under ``--postmortem
--alerts`` against phase 5's losses, ``GET /health``, the ``.nan`` dump,
``sentinel-nonfinite`` at ``GET /alerts``, ``launch doctor --watch``; the
chaos kill and its postmortem) and ``--ranks 4 --parts postmortem``
(``rank_postmortem`` on four gloo ranks: the kill, the stall on the
hook-driven step with its flight record, the straggler alert in flight,
the stall on the direct step, the sentinel's reduction on the direct and
the hook-driven step), in a subprocess with a hard deadline."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import signal  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

import pytest  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

_REHEARSAL = """
import sys
import numpy as np
import torch
sys.path.insert(0, {repo!r})
import chip_smoke as C
import horovod_tpu_torch as hvd
from horovod_tpu_torch.models import llama
torch.set_num_threads(1)
if {part!r} == "phase":
    # phase 5's losses on this small configuration, as the reference
    hvd.init(device="cpu")
    cfg = llama.CONFIGS["tiny"]
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
        0, cfg.vocab, (2, 65), dtype=np.int32))))
        for _ in range(C.WARMUP_STEPS + C.TIMED_STEPS + 1)]
    hvd.shutdown()
    out = C.phase_forensics(torch, "CPU", losses, 1.0, device_type="cpu",
                            cfg_name="tiny", batch=2, seq=64,
                            kill_layers=1)
    assert out == {{name: 0 for name in C.REPLACES}}, out
elif {part!r} == "ranks":
    # (c) at a slower pace than the card's, and with enough ticks (17 a
    # step, 102 a rank) that a peer's p99 is not its single slowest op:
    # on a loaded CPU one op of every peer (the first) reads 33-66 ms,
    # which alone pulled the skew of a 200 ms stall down to the rule's 4;
    # so the stall is 400 ms (its p99 bucket 0.52 s, the rule's 4 at any
    # peer p99 up to 0.13 s).  The heartbeat patience is the card's 20 s:
    # under load a rank's heartbeat thread went 6 s unheard, the launcher
    # aborted it, and (b) or (d) ended before rank 1's step 3
    C.rank_postmortem(torch, 4, "CPU", device_type="cpu", cfg_name="tiny",
                      batch=1, seq=64, timeout_s=C.POSTMORTEM_TIMEOUT,
                      tick_s=0.5, stall_ms=400, tags="abcd", ticks=17)
else:
    # (e) and (f) stall nothing: the card's heartbeat patience, and up to
    # 200 s for every rank's alert, so a loaded CPU reads no stale rank
    C.SENTINEL_VIEW_S = 200
    C.rank_postmortem(torch, 4, "CPU", device_type="cpu", cfg_name="tiny",
                      batch=1, seq=64, timeout_s=C.POSTMORTEM_TIMEOUT,
                      tags="ef")
print("REHEARSAL-OK", flush=True)
"""


@pytest.mark.parametrize("part", ["phase", "ranks", "ranks-sentinel"])
def test_chip_smoke_forensics_rehearsal_on_cpu(part):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    p = subprocess.Popen([sys.executable, "-c", _REHEARSAL.format(
        repo=REPO, part=part)], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, start_new_session=True)
    try:
        out, err = p.communicate(timeout=300)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        out, err = p.communicate()
        pytest.fail(f"the rehearsal did not end in 300 s: "
                    f"{out.decode()[-3000:]} {err.decode()[-3000:]}")
    out, err = out.decode(), err.decode()
    assert p.returncode == 0 and "REHEARSAL-OK" in out, (out[-4000:],
                                                         err[-4000:])
    if part == "phase":
        assert "bitwise equal: True" in out
        assert "GET /alerts sentinel-nonfinite" in out
        assert "ROOT CAUSE: rank 0" not in err
        assert '"classification": "kill"' in out
    elif part == "ranks":
        for tag in "abcd":
            assert f"({tag})" in out
        assert "the monitor's verdicts (recorded, not required)" in out
    else:
        for tag in "ef":
            assert f"({tag})" in out


@pytest.mark.parametrize("ticks_a_step,want", [(5, 4.0), (17, 32.0)])
def test_ranks_rehearsal_straggler_margin_on_a_loaded_host(ticks_a_step,
                                                          want):
    """(c)'s skew from the histograms a loaded six-worker run gives: rank
    1's 200 ms stalls in the 262 ms bucket, its peers' ops at 2-8 ms but
    one of each (the first negotiated op) at 50 ms.  At 5 ticks a step (30
    ops a rank) that one op is every peer's p99 and the skew sits on the
    rule's 4 (the run that failed read below it); at the rehearsal's 17
    (102 ops) the p99 drops it and the skew reads 32."""
    from horovod_tpu_torch.utils.metrics import Histogram
    from horovod_tpu_torch.watch.rules import straggler_verdict
    n = 6 * ticks_a_step
    p99 = {}
    for rank in range(4):
        h = Histogram("ages", "")
        for k in range(n):
            h.observe(0.2 + 0.001 * (k % 20) if rank == 1 else
                      0.05 if k == 0 else 0.002 + 0.006 * (k % 2))
        p99[rank] = h.quantile(0.99)
    v = straggler_verdict(p99)
    assert v is not None and v["rank"] == 1 and v["ratio"] == want
