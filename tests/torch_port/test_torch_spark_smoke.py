"""``chip_smoke.py`` phase 22 and ``--ranks N --parts estimator``
rehearsed on the CPU, every check of the card's run, with the ``tiny``
Llama standing in for ``1b`` in (c) (``ESTIMATOR_CPU``): (a) the MNIST
example's ``TorchEstimator`` at one task, its holdout check, its history
and its resume through ``fit_on_parquet`` bitwise the first fit's epochs;
(b) ``spark_estimator.py``'s ``LinearEstimator`` workflow against a
float64 numpy replay within 1e-10; (c) ``TorchEstimator`` over phase 5's
first 4 batches from parquet, epoch 0's mean loss against phase 5's (here
``cluster_task`` run in the rehearsal's own process, as phase 5 runs in
the script's), the driver's ``EstimatorModel`` to finite logits; then the
ranks part on two gloo tasks: (a) MNIST at two tasks, (b) ``w_sum``
bitwise equal on both, (c) the elastic shrink after rank 1's fault, (d)
the Lightning MNIST example at two tasks, its stop and ``state_dict``
alike on both and its logger written by rank 0 alone.  Each rehearsal is
a subprocess in a session of its own, one thread a process, killed at its
time limit; alone here each takes 30-45 s."""

import os
import signal
import subprocess
import sys

import pytest

from torch_port_ports import hold_ports

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

_REHEARSAL = """
import sys
import numpy as np
import torch
sys.path.insert(0, {repo!r})
torch.set_num_threads(1)
from horovod_tpu_torch.utils import platform
platform.force_cpu()
import chip_smoke as C
if __name__ == "__main__":
    if {part!r} == "phase":
        cpu = C.ESTIMATOR_CPU
        ref = C.cluster_task(dict(device="cpu", cfg=cpu["cfg_name"],
                                  batch=cpu["batch"], seq=cpu["seq"],
                                  steps=C.ESTIMATOR_LLAMA_BATCHES))
        out = C.phase_estimator(torch, np, "CPU", ref["losses"],
                                device_type="cpu", **cpu)
        assert out["launches"] == {{n: 0 for n in C.REPLACES}}, out
    else:
        C.rank_estimator(torch, 2, "CPU", device_type="cpu")
    print("REHEARSAL-OK", flush=True)
"""


@pytest.mark.parametrize("part", ["phase", "ranks"])
def test_chip_smoke_estimator_rehearsal_on_cpu(part):
    env = dict(os.environ, OMP_NUM_THREADS="1",
               HOROVOD_CONTROLLER_PORT=str(hold_ports(1).release()[0]))
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
        assert "its first 4 epochs bitwise the first fit's: True" in out
        assert "w, b dtype float64" in out
        assert "the driver's EstimatorModel on cpu" in out
        for label in ("mnist", "mnist-resume", "linear", "linear-resume",
                      "llama"):
            assert f"estimator [{label}] cpu: " in out, label
    else:
        assert "bitwise equal on all 2 ranks: True" in out
        assert "placements at np [2, 2, 1]" in out
        assert "stop and epoch by rank [(True, 0), (True, 0)]" in out
        assert "state_dict bitwise equal on all 2 ranks: True" in out
        assert "the logger written by ranks ['0']" in out
