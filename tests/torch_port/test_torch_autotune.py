"""The port's autotuning (``horovod_tpu_torch/utils/autotune.py`` over the
native optimizers of ``csrc/core/optim.cc``, bound in
``common/basics.py``) against the JAX package's, on the same inputs made
from a seed with numpy: the GP's mean and variance, the BO's proposals,
the parameter manager's and the bandits' trajectories bitwise equal
through the two bindings of the same C++ source; ``Autotuner.record``'s
threshold, cycle and arm trajectory and its log; the runtime's tunables
following the tuner; two gloo ranks holding equal thresholds at every
step while the fused sync re-plans its buckets, and failing fast when one
skips a ``record()``; the launcher's ``--timeline-merge`` and
``--metrics-port`` over two ranks; and the CPU rehearsals of
``chip_smoke.py``'s phase 15 and its ``--ranks 4 --parts measure``."""

import json
import os
import signal
import subprocess
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch.multiprocessing as tmp  # noqa: E402

from horovod_tpu.common import basics as JB  # noqa: E402
from horovod_tpu.utils import autotune as JA  # noqa: E402

import horovod_tpu_torch as hvd  # noqa: E402
from horovod_tpu_torch.common import basics as TB  # noqa: E402
from horovod_tpu_torch.utils import autotune as TA  # noqa: E402

import torch_port_measure_worker as W  # noqa: E402
from torch_port_ports import hold_ports  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _free_port() -> int:
    """A port below the ephemeral range, free when taken (``hold_ports``)."""
    return hold_ports(1).release()[0]


# ------------------------------------------------- the native optimizers
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gp_mean_and_variance_bitwise_equal(seed):
    rng = np.random.RandomState(seed)
    X = rng.rand(9, 2)
    y = np.sin(3 * X[:, 0]) + X[:, 1] ** 2
    kw = dict(length=float(rng.uniform(0.1, 1.0)), sigma_f=1.0,
              noise=float(rng.uniform(1e-6, 1e-2)))
    port, jax_ = TB.GaussianProcess(**kw), JB.GaussianProcess(**kw)
    port.fit(X, y)
    jax_.fit(X, y)
    for q in rng.rand(12, 2):
        assert port.predict(q) == jax_.predict(q)


@pytest.mark.parametrize("seed,dims", [(0, 1), (1, 2), (2, 2)])
def test_bo_proposals_bitwise_equal(seed, dims):
    rng = np.random.RandomState(seed)
    port = TB.BayesianOptimizer(dims=dims, seed=seed + 7)
    jax_ = JB.BayesianOptimizer(dims=dims, seed=seed + 7)
    x = rng.rand(dims).tolist()
    for _ in range(15):
        y = -float(np.sum((np.asarray(x) - 0.3) ** 2))
        port.add_sample(x, y)
        jax_.add_sample(x, y)
        x = port.next_sample()
        assert x == jax_.next_sample()
    assert port.best_x == jax_.best_x and port.best_y == jax_.best_y


@pytest.mark.parametrize("seed", [0, 1])
def test_parameter_manager_trajectory_bitwise_equal(seed):
    rng = np.random.RandomState(seed)
    kw = dict(initial_threshold=64 << 20, initial_cycle_ms=1.0,
              warmup_samples=2, steps_per_sample=3, max_samples=8,
              gp_noise=0.8)
    port = TB.NativeParameterManager(**kw)
    jax_ = JB.NativeParameterManager(**kw)
    steps = 0
    while not port.done and steps < 400:
        nbytes = int(rng.randint(1 << 20, 1 << 28))
        secs = float(rng.uniform(0.01, 0.5))
        assert port.update(nbytes, secs) == jax_.update(nbytes, secs)
        assert (port.threshold, port.cycle_ms, port.done) == \
            (jax_.threshold, jax_.cycle_ms, jax_.done)
        steps += 1
    assert port.done and port.best_score == jax_.best_score


@pytest.mark.parametrize("arms", [(3,), (2, 3)])
def test_bandit_trajectories_bitwise_equal(arms):
    rng = np.random.RandomState(len(arms))
    if len(arms) == 1:
        port = TB.NativeArmBandit(arms[0], steps_per_sample=2, max_pulls=12)
        jax_ = JB.NativeArmBandit(arms[0], steps_per_sample=2, max_pulls=12)
        state = ("arm", "done", "pulls")
    else:
        port = TB.NativeProductBandit(*arms, steps_per_sample=2,
                                      max_pulls=24)
        jax_ = JB.NativeProductBandit(*arms, steps_per_sample=2,
                                      max_pulls=24)
        state = ("arm_a", "arm_b", "done", "pulls")
    for _ in range(60):
        score = float(rng.uniform(1e8, 1e9))
        assert port.update(score) == jax_.update(score)
        assert [getattr(port, k) for k in state] == \
            [getattr(jax_, k) for k in state]


# ------------------------------------------------------------ Autotuner
def _knobs(log=""):
    return {"HOROVOD_FUSION_THRESHOLD": 32 << 20, "HOROVOD_CYCLE_TIME": 1.0,
            "HOROVOD_AUTOTUNE_WARMUP_SAMPLES": 1,
            "HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE": 2,
            "HOROVOD_AUTOTUNE_BAYES_OPT_MAX_SAMPLES": 6,
            "HOROVOD_AUTOTUNE_GAUSSIAN_PROCESS_NOISE": 0.8,
            "HOROVOD_AUTOTUNE_LOG": log}


def _trajectory(tuner, seq):
    out = []
    for nbytes, secs in seq:
        changed = tuner.record(nbytes, secs)
        out.append((changed, tuner.fusion_threshold, tuner.cycle_ms,
                    tuner.done, tuner.wire_policy, tuner.overlap_depth,
                    tuner.best_score))
    return out


@pytest.mark.parametrize("policy,depth", [
    (None, None), (["auto", "none", "bf16", "int8_ring"], None),
    (None, [1, 2, 4]), (["auto", "none", "bf16"], [1, 2])])
def test_autotuner_record_trajectory_matches_jax(tmp_path, policy, depth):
    rng = np.random.RandomState(5)
    seq = [(int(rng.randint(1 << 22, 1 << 28)), float(rng.uniform(0.05, 1)))
           for _ in range(80)]
    logs = [str(tmp_path / "port.csv"), str(tmp_path / "jax.csv")]
    port = TA.Autotuner(_knobs(logs[0]), policy_arms=policy,
                        depth_arms=depth)
    jax_ = JA.Autotuner(_knobs(logs[1]), policy_arms=policy,
                        depth_arms=depth)
    got, want = _trajectory(port, seq), _trajectory(jax_, seq)
    port.close()
    jax_.close()
    assert got == want
    assert len({g[1] for g in got}) >= 2 and got[-1][3]
    with open(logs[0]) as f, open(logs[1]) as g:
        assert f.read() == g.read()


def test_measure_times_a_blocking_step():
    tuner = TA.Autotuner(_knobs())
    with tuner.measure(nbytes=1 << 20):
        time.sleep(0.01)
    assert tuner._records == 1 and tuner._pm is not None


def test_runtime_tunables_follow_the_tuner(monkeypatch):
    """Under HOROVOD_AUTOTUNE the runtime's fusion threshold is the
    tuner's, and 'auto' wire policy, the overlap depth and the ZeRO-3
    prefetch depth follow its arms."""
    monkeypatch.setenv("HOROVOD_AUTOTUNE", "1")
    monkeypatch.setenv("HOROVOD_WIRE_POLICY", "auto")
    monkeypatch.setenv("HOROVOD_OVERLAP", "1")
    monkeypatch.setenv("HOROVOD_OVERLAP_DEPTH", "2")
    monkeypatch.setenv("HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE", "1")
    rt = hvd.init(device="cpu")
    try:
        tuner = hvd.autotuner()
        assert tuner._arms == ("auto", "none", "bf16", "int8_ring")
        assert tuner._depths == (1, 2, 4)
        seen = set()
        for secs in np.linspace(0.2, 0.9, 30):
            tuner.record(1 << 24, float(secs))
            assert rt.fusion_threshold() == tuner.fusion_threshold
            assert rt.wire_policy() == tuner.wire_policy
            assert rt.overlap_depth() == tuner.overlap_depth
            assert rt.zero_ag_prefetch() == tuner.overlap_depth
            seen.add((rt.wire_policy(), rt.overlap_depth()))
        assert len(seen) >= 2
        from horovod_tpu_torch.parallel.zero import resolve_ag_prefetch
        assert resolve_ag_prefetch() == tuner.overlap_depth
    finally:
        hvd.shutdown()


# ------------------------------------------------------- two gloo ranks
def _spawn(fn, out_dir, deadline=90):
    ctx = tmp.spawn(fn, args=(2, _free_port(), out_dir), nprocs=2,
                    join=False)
    end = time.monotonic() + deadline
    while not ctx.join(timeout=2):
        if time.monotonic() > end:
            for p in ctx.processes:
                p.terminate()
            pytest.fail(f"gloo ranks did not finish in {deadline} s")


def test_two_ranks_hold_equal_thresholds_and_replan(tmp_path):
    """Rank 0 tunes and every record() gives rank 1 its values: equal
    thresholds and cycles at every step, equal to one process's JAX
    Autotuner on the same (nbytes, seconds); the fused sync re-plans its
    buckets when the threshold changes and its result stays the mean."""
    _spawn(W.tune, str(tmp_path))
    rows = [json.load(open(tmp_path / f"tune.{r}.json")) for r in (0, 1)]
    assert rows[0] == rows[1]
    knobs = dict(_knobs(), HOROVOD_FUSION_THRESHOLD=1 << 20,
                 HOROVOD_AUTOTUNE_BAYES_OPT_MAX_SAMPLES=20)
    jax_ = JA.Autotuner(knobs)
    want = []
    for secs in W.SECONDS:
        before = jax_.fusion_threshold
        jax_.record(W.NBYTES, secs)
        want.append((before, jax_.fusion_threshold, jax_.cycle_ms))
    assert [(r["threshold"], r["after"], r["cycle"]) for r in rows[0]] == \
        want
    assert all(r["ok"] for r in rows[0])
    thresholds = [r["threshold"] for r in rows[0]]
    assert len(set(thresholds)) >= 2
    for prev, cur in zip(rows[0], rows[0][1:]):
        if cur["threshold"] != prev["threshold"]:
            assert cur["misses"] > prev["misses"]  # a new plan was made
    assert len({r["buckets"] for r in rows[0]}) >= 2


def test_a_rank_that_skips_record_fails_fast(tmp_path):
    """record() is collective: when a rank skips it, the others' exchange
    raises instead of hanging (here at once, the peer's connection
    closing; a live peer doing other work is bounded by the exchange's
    timeout)."""
    _spawn(W.skip, str(tmp_path))
    got = json.load(open(tmp_path / "skip.0.json"))
    assert got["error"] is not None and got["seconds"] < 30


# --------------------------------------------------------- the launcher
def _launch(argv, deadline=120, **env_extra):
    env = dict(os.environ, OMP_NUM_THREADS="1", **env_extra)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    p = subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.runner.launch",
         "--coordinator-port", str(_free_port()),
         "--controller-port", str(_free_port())] + argv,
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        start_new_session=True)
    try:
        out, err = p.communicate(timeout=deadline)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        p.communicate()
        pytest.fail(f"launch {argv} did not end in {deadline} s")
    return p.returncode, out.decode(), err.decode()


def test_launcher_merges_two_ranks_and_scrapes_both(tmp_path):
    """``-np 2 --timeline-merge OUT --metrics-port P`` on gloo ranks: the
    merged trace has a lane per rank with its clock offset and each
    rank's negotiated phases; ``/metrics`` shows both ranks and the
    driver; the launcher prints the straggler report."""
    from horovod_tpu_torch.utils import metrics as TM
    merged_path = str(tmp_path / "merged.json")
    worker = os.path.join(REPO, "tests", "torch_port",
                          "torch_port_measure_worker.py")
    rc, out, err = _launch(
        ["-np", "2", "--timeline-merge", merged_path, "--metrics-port",
         str(_free_port()), sys.executable, worker, "trace",
         str(tmp_path)], HOROVOD_CONTROLLER="tcp",
        HOROVOD_TIMELINE_MERGE_INTERVAL="0.5")
    assert rc == 0, err[-3000:]
    merged = json.load(open(merged_path))
    lanes = sorted(e["args"]["name"] for e in merged["traceEvents"]
                   if e.get("name") == "process_name")
    assert lanes == ["rank 0", "rank 1"]
    assert sorted(merged["metadata"]["clock_sync"]) == ["0", "1"]
    assert all(c["synced"] for c in merged["metadata"]["clock_sync"]
               .values())
    for pid in (0, 1):
        names = {e["name"] for e in merged["traceEvents"]
                 if e.get("pid") == pid and e["ph"] != "M"}
        assert {"NEGOTIATE", "QUEUE", "EXEC"} <= names
    for r in (0, 1):
        assert os.path.exists(f"{merged_path}.rank.{r}.json")
    text = open(tmp_path / "metrics.txt").read()
    assert TM.lint_exposition(text) == []
    for label in ('rank="0"', 'rank="1"', 'rank="driver"'):
        assert label in text
    assert "[hvd] straggler report" in err and "merged timeline" in err


# ------------------------------------------------ chip_smoke's rehearsal
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
        for _ in range(C.MEASURE_STEPS)]
    hvd.shutdown()
    out = C.phase_measure(torch, "CPU", losses, 1.0, 1.0,
                          device_type="cpu", cfg_name="tiny", batch=2,
                          seq=64)
    assert out == {{name: 0 for name in C.REPLACES}}, out
else:
    C.rank_measure(torch, 4, "CPU", device_type="cpu", cfg_name="tiny",
                   batch=1, seq=64)
print("REHEARSAL-OK", flush=True)
"""


@pytest.mark.parametrize("part", ["phase", "ranks"])
def test_chip_smoke_measure_rehearsal_on_cpu(part):
    """``chip_smoke.py`` phase 15 (the one-rank launch with the plane's
    flags: the hook-driven and the direct step, the trace, the tuner, the
    scrape) and ``--ranks 4 --parts measure`` (four gloo ranks: merged
    lanes, equal thresholds, equal parameters, four rank labels, the
    straggler report), with ``tiny`` standing in for ``1b``: every check
    of the card's run."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    p = subprocess.Popen([sys.executable, "-c", _REHEARSAL.format(
        repo=REPO, part=part)], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, start_new_session=True)
    try:
        out, err = p.communicate(timeout=150)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        out, err = p.communicate()
        pytest.fail(f"the rehearsal did not end in 150 s: "
                    f"{err.decode()[-3000:]}")
    out, err = out.decode(), err.decode()
    assert p.returncode == 0 and "REHEARSAL-OK" in out, (out[-3000:],
                                                         err[-3000:])
    if part == "phase":
        assert "gradient buckets x 8 steps with NEGOTIATE" in out
        assert "lint clean, rank 0 controller cycles" in out
    else:
        assert "lanes ['rank 0', 'rank 1', 'rank 2', 'rank 3']" in out
        assert "straggler report" in out
