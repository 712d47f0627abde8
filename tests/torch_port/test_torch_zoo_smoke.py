"""``chip_smoke.py``'s zoo, rehearsed on the CPU: phase 19 (``phase_zoo``)
at one gloo rank with the CPU sizes (``ZOO_CPU``: the four CNN families
at their CPU sizes, 2 images, one warm-up and one timed step; ResNet-50
fp32 at 32 px; BERT ``tiny``; the MNIST example launched with ``--cpu``),
and ``--parts zoo`` (``rank_zoo``) on four gloo ranks started as
``--ranks 4`` starts them: sync-BN ResNet-50 bitwise equal across ranks,
the four-against-one fp32 step within phase 19 (b)'s limits, Ulysses
BERT against one rank's loss.  A failed check raises."""

import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.models import layers as L
from horovod_tpu_torch.ops import flash_attention as F

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402


def test_chip_smoke_zoo_phase_on_cpu():
    out = chip_smoke.phase_zoo(torch, np, hvd, F, L, "cpu",
                               device_type="cpu", sizes=chip_smoke.ZOO_CPU)
    assert sorted(out["families"]) == ["inception3", "resnet101",
                                       "resnet50", "vgg16"]
    assert all(r["img_s_card"] > 0 for r in out["families"].values())
    assert out["bert_tok_s"] > 0 and out["mnist"] > 0
    assert not hvd.is_initialized()


def test_chip_smoke_zoo_ranks_on_cpu():
    argv = chip_smoke.ranks_argv(4, ("zoo",), "tiny", "cpu", 4, 32)
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    proc = subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.runner.launch"] + argv,
        cwd=REPO, env=env, start_new_session=True, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT)
    try:
        out, _ = proc.communicate(timeout=170)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        pytest.fail("gloo ranks did not finish in 170 s")
    out = out.decode()
    assert proc.returncode == 0, out[-4000:]
    for line in ("zoo [resnet50]: weights and BN statistics bitwise equal",
                 "zoo fp32 [resnet50", "zoo [bert tiny 2 layers fp32",
                 "zoo [bert tiny]: parameters bitwise"):
        assert line in out, (line, out[-4000:])
