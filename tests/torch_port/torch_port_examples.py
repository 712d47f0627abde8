"""Running the port's examples (examples/torch_port/) the way a user
starts them: ``python -m horovod_tpu_torch.runner.launch -np N ... --cpu``
on gloo ranks, each launch in its own session and killed with its workers
at its deadline."""

from __future__ import annotations

import os
import re
import signal
import subprocess
import sys

import pytest

from torch_port_ports import hold_ports

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def launch_example(np_: int, script: str, *args: str,
                   deadline: float = 240) -> str:
    """Rank 0's output of one launch that must exit 0."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    coord, ctrl = hold_ports(2).release()
    p = subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.runner.launch", "-np",
         str(np_), "--coordinator-port", str(coord), "--controller-port",
         str(ctrl), sys.executable,
         os.path.join(REPO, "examples", "torch_port", script), "--cpu",
         *args], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, start_new_session=True)
    try:
        out, err = p.communicate(timeout=deadline)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        p.communicate()
        pytest.fail(f"{script} did not end in {deadline} s")
    out, err = out.decode(), err.decode()
    assert p.returncode == 0, f"{script}: rc {p.returncode}\n{out[-2000:]}" \
                              f"\n{err[-3000:]}"
    return out


def losses(out: str, pattern: str) -> dict:
    """``{step: loss}`` of the lines ``pattern`` (groups: step, loss)."""
    return {int(s): float(v) for s, v in re.findall(pattern, out)}
