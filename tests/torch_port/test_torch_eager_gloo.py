"""The eager API on two gloo ranks, negotiated through the port's native
controller over TCP: one spawned run (``torch_port_eager_worker.py``) whose
checks each rank records, read here by topic.  Oracles: numpy on both
ranks' inputs, a plain optimizer and BatchNorm on the full batch in the
same process, and the root rank's optimizer state."""

import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch.multiprocessing as tmp

import torch_port_eager_worker
from torch_port_ports import hold_ports

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _free_port() -> int:
    """A port below the ephemeral range, free when taken (``hold_ports``)."""
    return hold_ports(1).release()[0]


@pytest.fixture(scope="module")
def checks(tmp_path_factory):
    out_dir = str(tmp_path_factory.mktemp("eager"))
    ctx = tmp.spawn(torch_port_eager_worker.run,
                    args=(_free_port(), _free_port(), out_dir),
                    nprocs=torch_port_eager_worker.SIZE, join=False)
    deadline = time.monotonic() + 180
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.terminate()
            pytest.fail("gloo ranks did not finish in 180 s")
    return [np.load(os.path.join(out_dir, f"rank{r}.npy"),
                    allow_pickle=True).item()
            for r in range(torch_port_eager_worker.SIZE)]


def _assert(checks, prefix):
    names = [n for n in checks[0] if n.startswith(prefix)]
    assert names, f"no check named {prefix!r}: {sorted(checks[0])}"
    failed = {f"rank{r} {n}": c[n][1] for r, c in enumerate(checks)
              for n in names if not c[n][0]}
    assert not failed, failed


def test_no_part_of_the_run_raised(checks):
    for c in checks:
        crashed = {n: v[1] for n, v in c.items() if n.startswith("_")}
        assert not crashed, crashed


@pytest.mark.parametrize("prefix", [
    "allreduce SUM", "allreduce AVERAGE", "allreduce MIN", "allreduce MAX",
    "allreduce PRODUCT", "allreduce scaled", "allreduce int", "allreduce bf16",
    "allreduce_async_", "grouped_allreduce", "allgather", "broadcast",
    "alltoall", "reducescatter", "barrier", "allreduce grad",
    "sparse_allreduce_async"])
def test_eager_op_matches_numpy(checks, prefix):
    _assert(checks, prefix)


@pytest.mark.parametrize("prefix", ["data plane ", "engine mixed scales",
                                    "engine wait(submit(op))"])
def test_data_plane_and_engine(checks, prefix):
    _assert(checks, prefix)


def test_opposite_submission_orders(checks):
    _assert(checks, "opposite submission orders")


def test_join_with_uneven_batches(checks):
    _assert(checks, "join uneven batches")


def test_hook_optimizer_matches_full_batch_step(checks):
    _assert(checks, "optimizer ")


def test_sync_batch_norm_matches_full_batch(checks):
    _assert(checks, "SyncBatchNorm")


def test_broadcast_optimizer_state_creates_missing_state(checks):
    _assert(checks, "broadcast_optimizer_state")


def test_ops_were_negotiated(checks):
    _assert(checks, "negotiated through the controller")


def test_chip_smoke_ranks_mode_on_cpu():
    """``chip_smoke.py --ranks N``'s per-rank path, rehearsed on four gloo
    ranks with the ``tiny`` config: every eager op against the all-rank
    oracle within its rounding bound, the hook-driven optimizer's losses
    against the root package's optimizer's on the same batches, and every
    wire configuration, flat and on two hosts of two ranks, with the
    parameters bitwise equal across the ranks, the ZeRO chain, and the 3D
    layouts and FSDP (``rank_layout``, the full model being ``tiny`` at
    its depth).  A failed check raises in its rank."""
    _rehearse(("dp",))


def test_chip_smoke_ranks_sequence_expert_adasum_on_cpu():
    """``chip_smoke.py --ranks N``'s parts (d)-(f), rehearsed on four gloo
    ranks: the ``tiny`` Llama's flash ring over 64 tokens and Ulysses and
    the plain ring over 32 against one rank's full-sequence step (loss and
    every gradient), the bf16 ring training steps with the first loss
    against the no-grad forward and parameters bitwise equal across ranks;
    the MoE ``mini`` and ``mixtral-tiny`` expert-parallel path against the
    dense one and three training steps; Adasum over the ``tiny`` buckets
    against the float64 model, the root and eager delta optimizers, and the
    two-level layout.  A failed check raises in its rank."""
    _rehearse(("sequence", "expert", "adasum"))


def _rehearse(parts):
    """Four gloo ranks of ``chip_smoke.py --rank-worker``, started as
    ``--ranks 4`` starts them: through the port's launcher, here a
    subprocess in a session of its own, killed with its ranks at 115 s."""
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    import chip_smoke
    argv = chip_smoke.ranks_argv(4, parts, "tiny", "cpu", 4, 32)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    proc = subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.runner.launch"] + argv,
        cwd=REPO, env=env, start_new_session=True)
    try:
        rc = proc.wait(timeout=115)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
        pytest.fail("gloo ranks did not finish in 115 s")
    assert rc == 0, f"a rank failed: the launcher returned {rc}"
