"""``chip_smoke.py`` phase 21 and ``--ranks N --parts cluster`` rehearsed
on the CPU with the ``tiny`` Llama (``CLUSTER_CPU``), every check of the
card's run: (a) ``spark.run`` and (b) ``RayExecutor`` of one task each,
losses and parameter checksums bitwise the reference step's (here the
same task function run in the rehearsal's own process, as phase 5 runs in
the script's); (c) ``spark.run_elastic`` whose first task dies after step
2, one reset; (d) ``ElasticRayExecutor`` over ``FixedHosts(localhost:1)``;
(e) ``hvd.run`` and a ``tune.distributed_trainable`` trial placed through
``LocalTaskExecutor``; then the ranks part on two gloo tasks against the
dp part's direct step started by the launcher, and ``run_elastic`` with
rank 1 killed, placed again at one task.  Each rehearsal is a subprocess
in a session of its own, killed at its time limit."""

import os
import signal
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

_REHEARSAL = """
import sys
import torch
sys.path.insert(0, {repo!r})
import chip_smoke as C
if {part!r} == "phase":
    spec = dict(device="cpu", cfg=C.CLUSTER_CPU["cfg_name"],
                batch=C.CLUSTER_CPU["batch"], seq=C.CLUSTER_CPU["seq"],
                steps=C.WARMUP_STEPS + C.TIMED_STEPS + 1)
    ref = C.cluster_task(spec)
    timed = ref["step_ms"][C.WARMUP_STEPS:-1]
    out = C.phase_cluster(torch, "CPU", ref["losses"], ref["sums"],
                          sum(timed) / len(timed), device_type="cpu",
                          **C.CLUSTER_CPU)
    assert out["launches"] == {{name: 0 for name in C.REPLACES}}, out
else:
    C.rank_cluster(torch, 2, "CPU", device_type="cpu", **C.CLUSTER_CPU)
print("REHEARSAL-OK", flush=True)
"""


@pytest.mark.parametrize("part", ["phase", "ranks"])
def test_chip_smoke_cluster_rehearsal_on_cpu(part):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    p = subprocess.Popen([sys.executable, "-c", _REHEARSAL.format(
        repo=REPO, part=part)], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, start_new_session=True)
    try:
        out, err = p.communicate(timeout=240)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        out, err = p.communicate()
        pytest.fail(f"the rehearsal did not end in 240 s: "
                    f"{out.decode()[-3000:]} {err.decode()[-3000:]}")
    out, err = out.decode(), err.decode()
    assert p.returncode == 0 and "REHEARSAL-OK" in out, (out[-4000:],
                                                         err[-4000:])
    if part == "phase":
        for label in ("spark.run num_proc=1", "RayExecutor num_workers=1",
                      "spark.run_elastic, second attempt",
                      "ElasticRayExecutor min_np=max_np=1", "hvd.run np=1"):
            assert f"cluster [{label}]: losses" in out, label
        assert out.count("bitwise phase 5's: True") == 9  # 7 parts, 2 sums
        assert out.count("parameter checksums bitwise phase 5's: True") == 2
        assert "attempts at np [1, 1]" in out
    else:
        assert out.count("bitwise the reference's: True") == 2
        assert "attempts at np [2, 1]" in out
