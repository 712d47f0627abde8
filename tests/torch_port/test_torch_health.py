"""The port's health plane against the JAX package's: ``heartbeat_payload``
(time fields removed) for the same progress, clock, core and memory row,
``fleet_health`` and ``HealthMonitor.verdicts`` over a schedule of
heartbeats (a lost heartbeat, a stall with one idle rank, the whole fleet
frozen), ``GET /health`` on both rendezvous servers, and the runtime's
heartbeat publisher and flight recorder under their knobs."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import json  # noqa: E402
import time  # noqa: E402
import urllib.request  # noqa: E402

import pytest  # noqa: E402

from horovod_tpu.perf import memstats as JMS  # noqa: E402
from horovod_tpu.runner.http_server import \
    RendezvousServer as JServer  # noqa: E402
from horovod_tpu.utils import health as JH  # noqa: E402
import horovod_tpu_torch as hvd  # noqa: E402
from horovod_tpu_torch import postmortem as TPM  # noqa: E402
from horovod_tpu_torch.perf import memstats as TMS  # noqa: E402
from horovod_tpu_torch.runner.http_server import \
    RendezvousServer as TServer  # noqa: E402
from horovod_tpu_torch.utils import health as TH  # noqa: E402
from torch_port_ports import hold_ports  # noqa: E402

_TIME_FIELDS = ("time", "step_time")


class _Clock:
    offset = 12.5


class _Core:
    _h = 1

    def __init__(self, fail=False):
        self.fail = fail

    def health(self):
        if self.fail:
            raise RuntimeError("closing")
        return {"version": 1, "now_us": 123, "cycles": 7,
                "transport_healthy": 1}


@pytest.fixture
def fresh():
    for mod in (TH, JH):
        mod.reset_step()
    TMS.reset()
    JMS.reset()
    yield
    for mod in (TH, JH):
        mod.reset_step()
    TMS.reset()
    JMS.reset()


def _row():
    return {"watermark": 0.42, "bytes_in_use": 420, "cap_bytes": 1000,
            "source": "device", "planes": {}}


@pytest.mark.parametrize("step", [None, 0, 17])
@pytest.mark.parametrize("clock", [None, _Clock()])
@pytest.mark.parametrize("core", [None, _Core(), _Core(fail=True)])
@pytest.mark.parametrize("mem", [False, True])
def test_heartbeat_payload_matches_jax(fresh, step, clock, core, mem):
    if step is not None:
        TH.record_step(step)
        JH.record_step(step)
    if mem:
        TMS.GLOBAL.last = _row()
        JMS.GLOBAL.last = _row()
    got = TH.heartbeat_payload(3, clock=clock, core=core,
                               pending_collectives=2)
    want = JH.heartbeat_payload(3, clock=clock, core=core,
                                pending_collectives=2)
    for hb in (got, want):
        assert abs(hb["time"] - time.time() - (12.5 if clock else 0)) < 5
        if step is not None:
            assert hb["step_time"] - hb["time"] <= 0.0
    assert {k: v for k, v in got.items() if k not in _TIME_FIELDS} == \
        {k: v for k, v in want.items() if k not in _TIME_FIELDS}
    assert ("mem" in got) == mem and ("core" in got) == (
        core is not None and not core.fail)


def test_record_step_is_the_postmortem_hook(fresh):
    TPM.record_step(4)
    assert TH.last_step()[0] == 4


def _beats(schedule):
    """(heartbeats, receipt times) of ``{rank: (hb dict, receipt)}``."""
    beats = {f"rank.{r}": json.dumps(hb).encode()
             for r, (hb, _) in schedule.items()}
    beats["rank.9"] = b"{torn"
    beats["junk"] = b"{}"
    return beats, {f"rank.{r}": t for r, (_, t) in schedule.items()}


# rank -> (heartbeat, server receipt time), judged at now = 100 with a 5 s
# patience
_SCHEDULES = {
    "healthy": {0: ({"rank": 0, "step_time": 99.0,
                     "pending_collectives": 0}, 99.5),
                1: ({"rank": 1, "step_time": 98.0,
                     "pending_collectives": 1}, 99.7)},
    "heartbeat-lost": {0: ({"rank": 0, "step_time": 99.0}, 99.0),
                       1: ({"rank": 1, "step_time": 80.0}, 80.0)},
    "stall-one-idle": {0: ({"rank": 0, "step_time": 90.0,
                            "pending_collectives": 1}, 99.8),
                       1: ({"rank": 1, "step_time": 90.5,
                            "pending_collectives": 0}, 99.8)},
    "fleet-frozen": {0: ({"rank": 0, "step_time": 88.0,
                          "pending_collectives": 1}, 99.8),
                     1: ({"rank": 1, "step_time": 91.0,
                          "pending_collectives": 2}, 99.8)},
    "no-step": {0: ({"rank": 0}, 99.8)},
}


@pytest.mark.parametrize("case", sorted(_SCHEDULES))
@pytest.mark.parametrize("stale_after", [5.0, 10.0])
def test_fleet_health_matches_jax(case, stale_after):
    beats, times = _beats(_SCHEDULES[case])
    got = TH.fleet_health(beats, times, now=100.0, stale_after=stale_after)
    assert got == JH.fleet_health(beats, times, now=100.0,
                                  stale_after=stale_after)
    assert "9" not in got["ranks"]


@pytest.mark.parametrize("case", sorted(_SCHEDULES))
@pytest.mark.parametrize("live", [(0, 1), (0, 1, 2), (1,)])
def test_monitor_verdicts_match_jax(case, live):
    beats, times = _beats(_SCHEDULES[case])

    def view(H):
        return lambda: H.fleet_health(beats, times, now=100.0,
                                      stale_after=5.0)
    got = TH.HealthMonitor(view(TH), timeout=5.0).verdicts(list(live))
    assert got == JH.HealthMonitor(view(JH), timeout=5.0).verdicts(
        list(live))
    expect = {"healthy": {}, "heartbeat-lost": {1: "heartbeat-lost"},
              "stall-one-idle": {1: "stall"},
              "fleet-frozen": {0: "stall"}, "no-step": {}}[case]
    if live == (0, 1):
        assert got == expect


def test_monitor_survives_a_failing_view():
    def boom():
        raise OSError("rendezvous gone")
    assert TH.HealthMonitor(boom).verdicts([0]) == {}


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=5) as r:
        return json.loads(r.read())


@pytest.mark.parametrize("query", ["", "?stale_after=0", "?stale_after=x"])
def test_health_route_matches_jax(fresh, query):
    """Both servers render the same /health for the same heartbeats,
    published by each package's HeartbeatPublisher into the other's
    server too (``now`` and the ages differ by the reading's instant)."""
    servers = [TServer(host="127.0.0.1"), JServer(host="127.0.0.1")]
    ports = [s.start() for s in servers]
    try:
        TH.record_step(5)
        JH.record_step(5)
        payload = {"rank": 0, "step": 5, "pid": os.getpid()}
        for H, port in zip((TH, JH), ports):
            for rank in (0, 1):
                pub = H.HeartbeatPublisher(
                    "127.0.0.1", port, rank=rank,
                    payload_fn=lambda r=rank: dict(payload, rank=r))
                assert pub.publish_now()
                pub.close()
        views = [_get(p, "/health" + query) for p in ports]
        for v in views:
            v.pop("now")
            for info in v["ranks"].values():
                assert info.pop("age_s") < 5.0
        assert views[0] == views[1]
        assert views[0]["ranks"]["1"]["heartbeat"]["step"] == 5
        assert views[0]["ranks"]["0"]["stale"] is (query ==
                                                    "?stale_after=0")
    finally:
        for s in servers:
            s.stop()


def _free_port() -> int:
    """A port below the ephemeral range, free when taken (``hold_ports``)."""
    return hold_ports(1).release()[0]


def test_runtime_publishes_heartbeats_under_the_knob(fresh, monkeypatch):
    server = TServer(host="127.0.0.1")
    port = server.start()
    monkeypatch.setenv("HOROVOD_HEARTBEAT", "1")
    monkeypatch.setenv("HOROVOD_HEARTBEAT_INTERVAL", "0.1")
    monkeypatch.setenv("HOROVOD_RENDEZVOUS_ADDR", "127.0.0.1")
    monkeypatch.setenv("HOROVOD_RENDEZVOUS_PORT", str(port))
    try:
        rt = hvd.init(device="cpu")
        assert rt.heartbeat is not None and rt.clock_sync is not None
        hvd.postmortem.record_step(11)
        deadline = time.time() + 10
        step = None
        while time.time() < deadline and step != 11:
            info = _get(port, "/health")["ranks"].get("0")
            step = info and info["heartbeat"]["step"]
            time.sleep(0.05)
        assert step == 11
        assert info["heartbeat"]["pending_collectives"] == 0
    finally:
        hvd.shutdown()
        server.stop()


def test_runtime_arms_the_flight_recorder(fresh, monkeypatch, tmp_path):
    """HOROVOD_FLIGHT_RECORD arms the core's recorder when it comes up:
    the span ring records, and an explicit dump there parses complete."""
    path = str(tmp_path / "flight.rank.0")
    monkeypatch.setenv("HOROVOD_CONTROLLER", "tcp")
    monkeypatch.setenv("HOROVOD_CONTROLLER_PORT", str(_free_port()))
    monkeypatch.setenv("HOROVOD_FLIGHT_RECORD", path)
    try:
        rt = hvd.init(device="cpu")
        assert rt.core is not None
        assert rt.core.flight_dump(path, "probe")
        fr = TPM.parse_flight_record(path)
        assert fr["complete"] and fr["reason"] == "explicit:probe"
        assert rt.core.health()["transport_healthy"] == 1
    finally:
        hvd.shutdown()
