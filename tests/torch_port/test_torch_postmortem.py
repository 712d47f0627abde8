"""The port's postmortem plane against the JAX package's, on the same
inputs: flight records written by each package's native core (parsed to
equal dicts by both parsers, a torn record too), the port's fatal-signal
recorder (a complete record, chained to the handler installed before
it), ``classify_exit`` and ``classify_suspect`` over the taxonomy's whole
grid, ``build_postmortem`` JSON for hand-built jobs, and the doctor's
postmortem text.  The forensics modules import nothing of JAX or
``horovod_tpu`` (read from their sources)."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import ast  # noqa: E402
import copy  # noqa: E402
import json  # noqa: E402
import signal  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

import pytest  # noqa: E402

from horovod_tpu import postmortem as JPM  # noqa: E402
from horovod_tpu.common import basics as JB  # noqa: E402
from horovod_tpu.runner import doctor as JD  # noqa: E402
from horovod_tpu_torch import postmortem as TPM  # noqa: E402
from horovod_tpu_torch.common import basics as TB  # noqa: E402
from horovod_tpu_torch.runner import doctor as TD  # noqa: E402
from horovod_tpu_torch.runner import launch as TL  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
FORENSICS = ("horovod_tpu_torch/postmortem.py",
             "horovod_tpu_torch/utils/health.py",
             "horovod_tpu_torch/chaos/__init__.py",
             "horovod_tpu_torch/chaos/injector.py",
             "horovod_tpu_torch/chaos/spec.py",
             "horovod_tpu_torch/watch/__init__.py",
             "horovod_tpu_torch/watch/rules.py",
             "horovod_tpu_torch/watch/series.py",
             "horovod_tpu_torch/watch/sentinel.py")


@pytest.mark.parametrize("path", FORENSICS)
def test_forensics_module_imports_no_jax(path):
    with open(os.path.join(REPO, path)) as f:
        tree = ast.parse(f.read(), path)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    assert not [n for n in names
                if n.split(".")[0] in ("jax", "jaxlib", "horovod_tpu")]


# ------------------------------------------------------------ flight record
def _record(basics, tmp_path, name, reason):
    """One explicit flight dump of a one-rank loopback core of ``basics``
    after one negotiated response."""
    hub = basics.LoopbackHub(1)
    core = basics.CoordinationCore.loopback(hub, rank=0)
    try:
        path = str(tmp_path / name)
        core.flight_enable(path)
        core.submit("t0", "f32:4", basics.OP_ALLREDUCE, 16)
        assert core.wait(5.0) is not None
        assert core.flight_dump(path, reason)
        health = core.health()
    finally:
        core.shutdown()
        core.close()
        hub.close()
    return path, health


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_flight_records_parse_equal(tmp_path, writer):
    path, health = _record(TB if writer == "port" else JB, tmp_path,
                           f"flight.{writer}", "round-trip")
    got, want = TPM.parse_flight_record(path), JPM.parse_flight_record(path)
    assert got == want
    assert got["reason"] == "explicit:round-trip" and got["complete"]
    assert got["rank"] == 0 and got["size"] == 1
    assert "cycle.negotiate" in [e[3] for e in got["trace"]]
    assert set(health) == {"version", "now_us", "cycles",
                           "last_progress_age_us", "queue_depth",
                           "responses_pending", "transport_healthy",
                           "shutdown"}


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_torn_flight_records_parse_equal(tmp_path, writer):
    path, _ = _record(TB if writer == "port" else JB, tmp_path,
                      f"flight.{writer}", "torn")
    text = open(path).read()
    torn = text[:text.index("[end]")].rstrip("\n")[:-7]
    got, want = TPM.parse_flight_record(torn), JPM.parse_flight_record(torn)
    assert got == want and got["complete"] is False and got["health"]
    for bad in ("not a record\nat all\n", "hvd_flight_vX\n"):
        for parse in (TPM.parse_flight_record, JPM.parse_flight_record):
            with pytest.raises(ValueError):
                parse(bad)


_SIGNAL_SCRIPT = """
import faulthandler, os, signal, sys
from horovod_tpu_torch.common import basics as m
chained = {chained}
if chained:
    faulthandler.enable(file=sys.stderr)
hub = m.LoopbackHub(1)
core = m.CoordinationCore.loopback(hub, rank=0)
core.flight_enable({path!r})
core.submit("t0", "f32:4", m.OP_ALLREDUCE, 16)
core.wait(5.0)
os.kill(os.getpid(), signal.{sig})
"""


@pytest.mark.parametrize("sig,chained", [("SIGSEGV", False),
                                         ("SIGABRT", False),
                                         ("SIGABRT", True)])
def test_fatal_signal_writes_record_and_chains(tmp_path, sig, chained):
    """A fatal signal leaves a complete record with native spans, and the
    process still dies of the signal through the handler that was there
    before the recorder (Python's faulthandler prints its traceback)."""
    path = str(tmp_path / "flight.sig")
    res = subprocess.run(
        [sys.executable, "-c", _SIGNAL_SCRIPT.format(
            path=path, sig=sig, chained=chained)],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=REPO))
    assert res.returncode == -getattr(signal, sig), (res.returncode,
                                                     res.stderr)
    fr = TPM.parse_flight_record(path)
    assert fr == JPM.parse_flight_record(path)
    assert fr["reason"] == f"signal:{sig}" and fr["complete"] is True
    assert any(e[3].startswith("cycle.") for e in fr["trace"])
    assert ("Fatal Python error" in res.stderr) == chained, res.stderr


# ------------------------------------------------------------ exit taxonomy
_RCS = (None, 0, 1, 2, 42, 137, -9, -6, -11, -15, -250)
_HEARTBEATS = (None, {}, {"mem": {"watermark": 0.5}},
               {"mem": {"watermark": 0.95}}, {"mem": {"watermark": 0.9}},
               {"mem": {"watermark": "junk"}})


@pytest.mark.parametrize("rc", _RCS)
def test_classify_exit_grid_matches_jax(rc):
    for by_launcher in (False, True):
        for cause in (None, "stall", "heartbeat-lost"):
            for hb in _HEARTBEATS:
                args = (rc, by_launcher, cause)
                assert TPM.classify_exit(*args, heartbeat=hb) == \
                    JPM.classify_exit(*args, heartbeat=hb), (args, hb)


def test_classify_exit_follows_the_watermark_knob(monkeypatch):
    monkeypatch.setenv("HOROVOD_MEM_HIGH_WATERMARK", "0.4")
    hb = {"mem": {"watermark": 0.5}}
    assert TPM.classify_exit(-9, heartbeat=hb) == \
        JPM.classify_exit(-9, heartbeat=hb) == "oom"


_TAILS = ("", "chaos: crashing rank 0 at fastcommit.pre_marker",
          "urllib.error.URLError: chaos: injected KV blackout",
          "controller transport failure (peer died?)",
          "chaos: killing rank 1 at step 2", "Traceback: boom")
_CLASSES = ("error:1", "stall", "heartbeat-lost", "oom", "signal:SIGKILL",
            "terminated", "clean", "unknown")
_EXTRAS = (
    {},
    {"flight_record": {"metrics": {"transport_reconnect_failures": 2},
                       "health": {}}},
    {"flight_record": {"metrics": {}, "health": {"transport_healthy": 0}}},
    {"metrics": {"chaos_injections": {"kill": 1}}},
    {"metrics": {"chaos_injections": {"kv_blackout": 3}}},
    {"metrics": {"chaos_injections": {"crash_commit": 1}}},
    {"heartbeat": {"mem": {"watermark": 0.97}}},
)


@pytest.mark.parametrize("cls", _CLASSES)
def test_classify_suspect_grid_matches_jax(cls):
    for tail in _TAILS:
        for extra in _EXTRAS:
            info = dict(copy.deepcopy(extra),
                        exit={"classification": cls}, log_tail=tail)
            assert TPM.classify_suspect(info) == \
                JPM.classify_suspect(info), info


# ---------------------------------------------------------------- builder
def _view(now, ranks):
    return {"now": now, "stale_after_s": 10.0, "ranks": ranks}


def _snapshot(kills: int):
    return {"families": {
        "hvd_chaos_injections_total": {"kind": "counter", "samples": [
            {"labels": {"kind": "kill"}, "value": kills},
            {"labels": {"kind": "stall"}, "value": 0}]},
        "hvd_transport_reconnects_total": {"kind": "counter", "samples": [
            {"labels": {}, "value": 2}]},
        "hvd_stall_warnings_total": {"kind": "counter", "samples": []}}}


def _job(case):
    """(job, exits, health view, flight records, log tails, snapshots) of
    one hand-built job."""
    job = {"np": 2, "command": ["python", "train.py"]}
    flight = {"version": 1, "reason": "signal:SIGABRT", "rank": 1,
              "size": 2, "now_us": 800_000, "complete": True,
              "health": {"cycles": 9, "last_progress_age_us": 12,
                         "queue_depth": 0, "transport_healthy": 1},
              "metrics": {"responses": 4}, "trace_dropped": 0,
              "trace": [(600_000 + i, "i", "t", "tcp.gather.send", 33)
                        for i in range(12)]}
    hb = {"rank": 1, "time": 1000.2, "step": 2, "step_time": 1000.1,
          "pending_collectives": 0, "core": {"now_us": 700_000}}
    if case == "kill":
        return (job, {0: {"rc": -15, "time": 1000.9, "by_launcher": True},
                      1: {"rc": 1, "time": 1000.5}},
                _view(1000.9, {"1": {"age_s": 0.4, "heartbeat": hb}}),
                {1: flight}, {1: "chaos: killing rank 1 at step 2\n"},
                {0: _snapshot(0), 1: _snapshot(1)})
    if case == "stall":
        return (job, {0: {"rc": -15, "time": 1010.0, "by_launcher": True},
                      1: {"rc": -6, "time": 1009.0, "cause": "stall"}},
                _view(1010.0, {
                    "0": {"age_s": 0.3, "heartbeat": dict(
                        hb, rank=0, pending_collectives=1)},
                    "1": {"age_s": 0.3, "heartbeat": hb}}),
                {1: flight}, {}, None)
    if case == "oom":
        return (dict(job, np=3),
                {0: {"rc": -9, "time": 1000.4}, 1: {"rc": -9, "time": 1000.3},
                 2: {"rc": 137, "time": 1000.6}},
                _view(1000.9, {
                    "0": {"age_s": 1.0, "heartbeat": {
                        "rank": 0, "time": 1000.0,
                        "mem": {"watermark": 0.99}}},
                    "1": {"age_s": 1.0, "heartbeat": {
                        "rank": 1, "time": 1000.1,
                        "mem": {"watermark": 0.93}}},
                    "2": {"age_s": 1.0, "heartbeat": {
                        "rank": 2, "time": 1000.2,
                        "mem": {"watermark": 0.2}}}}),
                None, None, None)
    return (job, {0: {"rc": 0, "time": 1000.0}, 1: {"rc": 0, "time": 1000.1}},
            None, None, None, None)


@pytest.mark.parametrize("case", ["kill", "stall", "oom", "clean"])
def test_build_postmortem_matches_jax(case):
    inputs = _job(case)
    got = TPM.build_postmortem(*copy.deepcopy(inputs))
    want = JPM.build_postmortem(*copy.deepcopy(inputs))
    assert got.pop("created") <= want.pop("created") + 60
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                         sort_keys=True)
    expect = {"kill": (1, "kill"), "stall": (1, "stall"),
              "oom": (0, "oom"), "clean": (None, "unknown")}[case]
    assert (got["suspect"]["rank"], got["suspect"]["classification"]) == \
        expect


@pytest.mark.parametrize("kills", [0, 1, 3])
def test_condense_metrics_matches_jax(kills):
    snap = _snapshot(kills)
    assert TPM._condense_metrics(snap) == JPM._condense_metrics(snap)


def test_postmortem_json_round_trip_across_packages(tmp_path):
    pm = TPM.build_postmortem(*_job("kill"))
    path = TPM.write_postmortem(pm, str(tmp_path / "postmortem.json"))
    assert JPM.load_postmortem(path) == TPM.load_postmortem(str(tmp_path))
    bad = tmp_path / "bad"
    bad.mkdir()
    (bad / "postmortem.json").write_text(json.dumps({"schema": "nope"}))
    for load in (TPM.load_postmortem, JPM.load_postmortem):
        with pytest.raises(ValueError, match="schema"):
            load(str(bad))


# ------------------------------------------------------------------ doctor
@pytest.mark.parametrize("case", ["kill", "stall", "oom", "clean"])
@pytest.mark.parametrize("events", [25, 3])
def test_doctor_postmortem_text_matches_jax(case, events):
    pm = TPM.build_postmortem(*_job(case))
    assert TD.render_postmortem(pm, max_events=events) == \
        JD.render(pm, max_events=events)


@pytest.mark.parametrize("argv", [[], ["--events", "4"], ["--json"]])
def test_launch_doctor_dir_prints_what_hvdrun_doctor_prints(tmp_path, argv,
                                                            capsys):
    pm = TPM.build_postmortem(*_job("stall"))
    TPM.write_postmortem(pm, str(tmp_path / "postmortem.json"))
    assert TL.run_commandline(["doctor", str(tmp_path)] + argv) == 0
    got = capsys.readouterr().out
    assert JD.main([str(tmp_path)] + argv) == 0
    assert got == capsys.readouterr().out
    if not argv:
        assert got.splitlines()[1].startswith("ROOT CAUSE: rank 1 — stall")


def test_launch_doctor_rejects_a_missing_postmortem(tmp_path, capsys):
    assert TL.run_commandline(["doctor", str(tmp_path / "nope")]) == 2
    assert "No such file" in capsys.readouterr().err
