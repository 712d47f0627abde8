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
    # (c) at a slower pace than the card's: on a loaded CPU a peer's
    # ages may reach the 65.5 ms bucket, and a 200 ms stall still reads
    # four buckets above that
    C.rank_postmortem(torch, 4, "CPU", device_type="cpu", cfg_name="tiny",
                      batch=1, seq=64, timeout_s="6", tick_s=0.5,
                      stall_ms=200, tags="abcd")
else:
    C.rank_postmortem(torch, 4, "CPU", device_type="cpu", cfg_name="tiny",
                      batch=1, seq=64, timeout_s="6", tags="ef")
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
