"""The forensics planes end to end under the port's launcher, on two gloo
ranks (``python -m horovod_tpu_torch.runner.launch -np 2``, without
``--gpu``, as a subprocess in a session of its own with a hard deadline),
the experiments of the JAX package's integration tests
(tests/integration/test_postmortem_integration.py and
test_watch_integration.py):

  (a) a chaos kill of rank 1 at step 2 of the hook-driven two-layer Llama
      step: postmortem.json names rank 1, ``kill``; rank 0's exit is
      collateral; ``launch doctor DIR`` prints the root cause;
  (b) a chaos stall of rank 1 at step 3: the supervision aborts rank 1
      (``stall``), whose flight record is complete, ``signal:SIGABRT``,
      with native spans, and whose last heartbeat has nothing pending;
  (c) a NaN in rank 1's step-3 input under ``hvd.sentinel.wrap``:
      ``sentinel-nonfinite`` fires at ``GET /alerts`` naming rank 1 and
      the step, and the ``.nan`` dump parses;
  (d) a 40 ms stall at ``complete``: ``straggler-suspect`` names rank 1
      at ``GET /alerts`` while the job runs;

and the sentinel's reduction over the ranks (``wrap(axis_name="hvd")``)
on the direct step and on the hook-driven one, whose gradients'
negotiated allreduces are still in flight when it reduces.

Every port is a free one, the heartbeat patience is a few seconds, and no
assertion rests on a single tick: the workers poll ``GET /alerts`` until a
deadline.  The worker is ``torch_port_forensics_worker.py``."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import json  # noqa: E402
import math  # noqa: E402
import signal  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

import pytest  # noqa: E402
from torch_port_ports import hold_ports  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_port_forensics_worker.py")
LAUNCH = [sys.executable, "-m", "horovod_tpu_torch.runner.launch"]
USER_RULES = {"rules": [{"name": "forensics-test-user-rule",
                         "family": "hvd_controller_cycles_total",
                         "kind": "threshold", "op": ">=", "value": 1e18,
                         "severity": "info"}]}


def _free_port() -> int:
    """A port below the ephemeral range, free when taken (``hold_ports``)."""
    return hold_ports(1).release()[0]


def _env(extra):
    env = dict(os.environ, HOROVOD_CONTROLLER="tcp", OMP_NUM_THREADS="1",
               PYTHONUNBUFFERED="1", **extra)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    for name in ("HOROVOD_POSTMORTEM_DIR", "HOROVOD_ALERTS",
                 "HOROVOD_CHAOS_SPEC"):
        env.pop(name, None)
    return env


def _launch(flags, mode, out_dir, extra_env, deadline=150):
    """``(rc, stdout, stderr)`` of one ``-np 2`` launch of the worker; at
    ``deadline`` the launcher's session, workers included, is killed and
    the test fails."""
    p = subprocess.Popen(
        LAUNCH + ["-np", "2", "--coordinator-port", str(_free_port()),
                  "--controller-port", str(_free_port())] + flags
        + [sys.executable, WORKER, mode, str(out_dir)],
        cwd=REPO, env=_env(extra_env), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, start_new_session=True)
    try:
        out, err = p.communicate(timeout=deadline)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        out, err = p.communicate()
        pytest.fail(f"launch {flags} {mode} did not end in {deadline} s:"
                    f"\n{err.decode()[-4000:]}")
    return p.returncode, out.decode(), err.decode()


def _spec(tmp_path, events, seed):
    path = tmp_path / "chaos.json"
    path.write_text(json.dumps({"seed": seed, "events": events}))
    return str(path)


def _rules(tmp_path):
    path = tmp_path / "rules.json"
    path.write_text(json.dumps(USER_RULES))
    return str(path)


def _doctor(pm_dir):
    return subprocess.run(LAUNCH + ["doctor", str(pm_dir)],
                          capture_output=True, text=True, timeout=60,
                          env=_env({}), cwd=REPO)


def _logs(pm_dir, out=""):
    for rank in (0, 1):
        for stream in ("stdout", "stderr"):
            p = pm_dir / "logs" / f"rank.{rank}" / stream
            if p.exists():
                out += p.read_text()
    return out


_PM_ENV = {"HOROVOD_HEARTBEAT_INTERVAL": "0.3",
           "HOROVOD_HEARTBEAT_TIMEOUT": "4"}


def test_chaos_kill_is_attributed_to_its_rank(tmp_path):
    """(a) rank 1 dies at step 2: the postmortem names rank 1 / kill,
    orders the last events on the fleet clock, and the doctor renders the
    root cause."""
    pm_dir = tmp_path / "pm"
    spec = _spec(tmp_path, [{"kill": {"rank": 1, "step": 2,
                                      "exit_code": 1}}], 23)
    rc, out, err = _launch(["--postmortem", str(pm_dir), "--chaos", spec],
                           "train", tmp_path, _PM_ENV)
    assert rc != 0, out + err
    assert "postmortem:" in err, err[-4000:]
    pm = json.loads((pm_dir / "postmortem.json").read_text())
    assert pm["first_failure"]["rank"] == 1, pm["first_failure"]
    assert pm["first_failure"]["classification"] == "error:1"
    assert pm["suspect"]["rank"] == 1
    assert pm["suspect"]["classification"] == "kill", pm["suspect"]
    assert pm["ranks"]["0"]["exit"]["classification"] in (
        "terminated", "error:1")
    assert "chaos: killing rank 1 at step 2" in \
        (pm["ranks"]["1"]["log_tail"] or "")
    ts = [e["t"] for e in pm["events"]]
    assert ts == sorted(ts) and len(ts) >= 3
    assert {"exit", "heartbeat"} <= {e["kind"] for e in pm["events"]}
    doc = _doctor(pm_dir)
    assert doc.returncode == 0, doc.stderr
    assert "ROOT CAUSE: rank 1 — kill" in doc.stdout, doc.stdout


def test_chaos_stall_is_aborted_with_a_complete_flight_record(tmp_path):
    """(b) rank 1 freezes at step 3 while rank 0 waits inside the step's
    negotiation: the supervision aborts rank 1 (nothing pending on it) and
    the postmortem carries its flight record with native spans."""
    pm_dir = tmp_path / "pm"
    spec = _spec(tmp_path, [{"stall": {"rank": 1, "step": 3,
                                       "duration_ms": 600000}}], 29)
    rc, out, err = _launch(["--postmortem", str(pm_dir), "--chaos", spec],
                           "train", tmp_path, _PM_ENV)
    assert rc != 0, out + err
    assert "stall beyond" in err, err[-4000:]
    pm = json.loads((pm_dir / "postmortem.json").read_text())
    assert pm["first_failure"]["rank"] == 1, pm["first_failure"]
    assert pm["suspect"] == {
        "rank": 1, "classification": "stall",
        "evidence": ["supervision verdict: stall beyond the heartbeat "
                     "timeout"]}, pm["suspect"]
    assert pm["ranks"]["1"]["exit"]["classification"] == "stall"
    assert pm["ranks"]["0"]["exit"]["classification"] == "terminated"
    fr = pm["ranks"]["1"]["flight_record"]
    assert fr is not None, "flight record not collected"
    assert fr["reason"] == "signal:SIGABRT"
    assert fr["complete"] is True
    assert fr["trace"], "the flight record carries no native spans"
    hb = pm["ranks"]["1"]["heartbeat"]
    assert hb["step"] == 3 and hb["pending_collectives"] == 0, hb
    assert pm["ranks"]["0"]["heartbeat"]["pending_collectives"] > 0
    doc = _doctor(pm_dir)
    assert doc.returncode == 0, doc.stderr
    assert "ROOT CAUSE: rank 1 — stall" in doc.stdout, doc.stdout
    assert "flight record: reason=signal:SIGABRT" in doc.stdout


def test_sentinel_nan_fires_critical_and_dumps_flight(tmp_path):
    """(c) a NaN gradient on rank 1: the critical alert names rank 1 and
    the step at GET /alerts, and the reason-nan flight dump parses."""
    pm_dir = tmp_path / "pm"
    rc, out, err = _launch(
        ["--postmortem", str(pm_dir), "--alerts", _rules(tmp_path)], "nan",
        tmp_path, {"HOROVOD_METRICS": "1", "HOROVOD_METRICS_INTERVAL": "0.3",
                   "HOROVOD_SERIES_RESOLUTION": "0.2"})
    logs = _logs(pm_dir, out + err)
    assert rc == 0, logs[-6000:]
    assert logs.count("FORENSICS-NAN-OK") == 2, logs[-6000:]
    assert (pm_dir / "flight.rank.1.nan").exists()
    assert not (pm_dir / "flight.rank.0.nan").exists()
    assert "ALERT critical sentinel-nonfinite: rank 1" in err, err[-4000:]


def test_straggler_alert_fires_in_flight(tmp_path):
    """(d) the stall -> skew series -> threshold rule -> /alerts and
    timeline-instant chain, read from inside the running fleet."""
    spec = _spec(tmp_path, [{"stall": {"rank": 1, "point": "complete",
                                       "duration_ms": 40}}], 23)
    logs = tmp_path / "logs"
    rc, out, err = _launch(
        ["--output-filename", str(logs), "--chaos", spec, "--alerts",
         _rules(tmp_path)], "straggler", tmp_path,
        {"HOROVOD_METRICS": "1", "HOROVOD_METRICS_INTERVAL": "0.3",
         "HOROVOD_SERIES_RESOLUTION": "0.2",
         "HOROVOD_SERIES_RETENTION": "120", "HOROVOD_MEM": "0"})
    text = out + err + _logs(tmp_path)
    assert rc == 0, text[-6000:]
    assert text.count("FORENSICS-STRAGGLER-OK") == 2, text[-6000:]
    assert "ALERT warning straggler-suspect: rank 1" in err, err[-4000:]


def test_sentinel_reduces_over_both_step_paths(tmp_path):
    """``wrap(axis_name="hvd")`` on the direct step (one dist.all_reduce)
    and on the hook-driven step (negotiated through the engine beside the
    gradients' allreduces): every rank records the same scalars, the sums
    of the ranks' own square-sums and nonfinite counts and the mean of
    their losses, and rank 1's NaN is every rank's nonfinite step."""
    rc, out, err = _launch([], "reduce", tmp_path, {
        "HOROVOD_SENTINEL_INTERVAL": "1"})
    assert rc == 0, (out + err)[-6000:]
    assert out.count("FORENSICS-REDUCE-OK") == 2, (out + err)[-6000:]
    rows = [json.loads((tmp_path / f"reduce.{r}.json").read_text())
            for r in (0, 1)]
    assert len(rows[0]) == len(rows[1]) == 8
    nonfinite = 0
    for k, (a, b) in enumerate(zip(*rows)):
        assert (a["path"], a["step"]) == (b["path"], b["step"])
        for key in ("loss", "grad_norm", "nonfinite_total",
                    "last_nonfinite_step"):
            assert a[key] == b[key], (k, key, a, b)
        sq = a["local"][0] + b["local"][0]
        assert math.isclose(a["grad_norm"] ** 2, sq, rel_tol=1e-6), (k, a, b)
        mean = (a["local"][2] + b["local"][2]) / 2
        assert math.isclose(a["loss"], mean, rel_tol=1e-6), (k, a, b)
        bad = a["local"][1] + b["local"][1]
        assert bad == (1.0 if b["local"][1] else 0.0), (k, a, b)
        assert a["local"][1] == 0.0 and (b["local"][1] == 1.0) == (
            a["step"] == 2), (k, a, b)
        nonfinite += bad > 0
        assert a["nonfinite_total"] == nonfinite, (k, a)
        if bad:
            assert a["last_nonfinite_step"] == k, (k, a)
    assert nonfinite == 2
    # on the hook path rank 0 had run every gradient allreduce before it
    # reduced, rank 1 none of them
    assert [r["pending"] for r in rows[0][4:]] == [0] * 4, rows[0]
    assert all(r["pending"] for r in rows[1][4:]), rows[1]
