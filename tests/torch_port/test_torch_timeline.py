"""The port's timeline and clock sync (``horovod_tpu_torch/utils/
timeline.py``, ``utils/clocksync.py``) against the JAX package's, on the
same inputs: the same call sequence gives the same events up to
timestamps, ``collapse_name``, ``best_offset`` on a synthetic skew, the
fleet merge of the same chunks, crash safety, incremental publishing, the
rendezvous routes, the native drainer over the port's core, the deferred
device spans (start/done events resolved by the writer thread), and the
negotiated path's NEGOTIATE, QUEUE and EXEC lifecycle on the CPU."""

import json
import math
import os
import time
import urllib.request

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from horovod_tpu.utils import clocksync as JCS  # noqa: E402
from horovod_tpu.utils import timeline as JT  # noqa: E402

import horovod_tpu_torch as hvd  # noqa: E402
from horovod_tpu_torch.common import basics as TB  # noqa: E402
from horovod_tpu_torch.runner.http_server import \
    RendezvousServer  # noqa: E402
from horovod_tpu_torch.utils import clocksync as TCS  # noqa: E402
from horovod_tpu_torch.utils import timeline as TT  # noqa: E402
from torch_port_ports import hold_ports  # noqa: E402


def _drive(mod, path, mark_cycles=True):
    """The same call sequence on a timeline of ``mod``."""
    tl = mod.Timeline(path, mark_cycles=mark_cycles)
    tl.begin("grad/w", "NEGOTIATE")
    tl.end("grad/w", "NEGOTIATE")
    tl.begin("grad/w", "QUEUE")
    tl.end("grad/w", "QUEUE")
    tl.record_op("grad/w", "EXEC", 1024, duration_us=500.0)
    tl.record_op("x.noname.7", "ALLREDUCE", 8)
    tl.instant("chaos", "chaos.stall.complete", args={"duration_ms": 40})
    tl.mark_cycle()
    tl.record_span("serve", "PREFILL", 250.0, args={"rid": "r0"})
    tl.native_event(tl.now_us(), "B", "c", "cycle.negotiate", 2)
    tl.native_event(tl.now_us(), "E", "c", "cycle.negotiate", 0)
    tl.native_event(tl.now_us(), "i", "t", "frame.resent", 3)
    tl.close()
    return mod.load_trace_events(path)


def _untimed(events):
    return [{k: v for k, v in e.items() if k != "ts"} for e in events]


@pytest.mark.parametrize("mark_cycles", [True, False])
def test_same_calls_give_the_same_events(tmp_path, mark_cycles):
    got = _drive(TT, str(tmp_path / "t.json"), mark_cycles)
    want = _drive(JT, str(tmp_path / "j.json"), mark_cycles)
    assert _untimed(got) == _untimed(want)
    x = [e for e in got if e.get("name") == "EXEC"][0]
    assert x["ph"] == "X" and x["dur"] == 500.0
    assert x["args"] == {"size": 1024}
    assert any(e.get("name") == "CYCLE" for e in got) == mark_cycles


@pytest.mark.parametrize("name", ["g.noname.12", "bcast.tfneg.3", "plain",
                                  "a.noname.b.noname.c", ""])
def test_collapse_name_matches_jax(name):
    assert TT.collapse_name(name) == JT.collapse_name(name)


def test_best_offset_synthetic_skew():
    """A server 2.5 s ahead probed with symmetric 10 ms RTT: +2.5 s with
    5 ms uncertainty, the min-RTT probe winning (tests/test_tracing.py's
    case, within its tolerance), and the JAX function's result."""
    t = 1000.0
    samples = [(t, t + 2.5 + 0.050, t + 0.100),
               (t, t + 2.5 + 0.005, t + 0.010),
               (t + 1, t + 0.5, t)]  # clock stepped mid-probe: dropped
    offset, unc = TCS.best_offset(samples)
    assert (offset, unc) == JCS.best_offset(samples)
    assert abs(offset - 2.5) < 1e-9 and abs(unc - 0.005) < 1e-9
    assert TCS.best_offset([]) == JCS.best_offset([]) == (0.0, math.inf)


@pytest.mark.parametrize("seed", [0, 1])
def test_best_offset_matches_jax_on_random_probes(seed):
    rng = np.random.RandomState(seed)
    t0 = rng.uniform(1e9, 2e9, 12)
    rtt = rng.exponential(0.01, 12)
    skew = rng.normal(0, 3)
    samples = [(a, a + skew + r * rng.rand(), a + r)
               for a, r in zip(t0, rtt)]
    assert TCS.best_offset(samples) == JCS.best_offset(samples)


def _chunks(seed):
    rng = np.random.RandomState(seed)
    now = 1.7e15
    items = {}
    for rep in (0, 1):
        for r in range(3):
            events = []
            for i in range(5):
                lane = ["grad/w", "controller", "serve"][rng.randint(3)]
                ph = ["X", "B", "E", "i"][rng.randint(4)]
                ev = {"lane": lane, "name": f"ev{i}", "ph": ph,
                      "ts": now + float(rng.randint(0, 10 ** 6))}
                if ph == "X":
                    ev["dur"] = float(rng.randint(1, 1000))
                events.append(ev)
            chunk = {"rank": r, "seq": 0, "events": events,
                     "clock": {"offset": float(rng.normal()),
                               "uncertainty": 1e-4, "synced": True}}
            key = f"rank.{r}.000000"
            if rep:
                chunk["replica"] = rep
                key = f"r{rep:02d}.{key}"
            items[key] = json.dumps(chunk).encode()
    items["garbage"] = b"not json{"
    return items


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merge_timeline_chunks_matches_jax(seed):
    items = _chunks(seed)
    got = TT.merge_timeline_chunks(items)
    assert got == JT.merge_timeline_chunks(items)
    procs = {e["pid"]: e["args"]["name"] for e in got["traceEvents"]
             if e.get("name") == "process_name"}
    assert procs[0] == "rank 0" and procs[10002] == "replica1.rank2"
    ts = [e["ts"] for e in got["traceEvents"] if e["ph"] != "M"]
    assert ts == sorted(ts) and ts[0] == 0.0


def test_unclosed_timeline_is_loadable(tmp_path):
    path = str(tmp_path / "tl.json")
    tl = TT.Timeline(path, flush_interval=0.05)
    for i in range(5):
        tl.record_op(f"t{i}", "EXEC", 8, duration_us=10.0)
    tl.flush()  # a rank killed after a periodic flush: no close()
    raw = open(path).read()
    assert not raw.rstrip().endswith("]")
    events = TT.load_trace_events(path)
    assert sum(1 for e in events if e.get("ph") == "X") == 5
    assert _untimed(events) == _untimed(JT.load_trace_events(path))
    tl.close()


def test_timeline_close_is_idempotent(tmp_path):
    path = str(tmp_path / "tl.json")
    tl = TT.Timeline(path)
    tl.record_op("t", "EXEC", 8)
    tl.close()
    tl.close()
    tl.record_op("t2", "EXEC", 8)  # after close: no raise
    assert json.load(open(path))


class _FakeEvent:
    """A CUDA event stand-in: completes after ``ready_after`` queries."""

    def __init__(self, ms: float = 0.0, ready_after: int = 0):
        self.ms, self.left, self.synced = ms, ready_after, False

    def query(self) -> bool:
        self.left -= 1
        return self.left < 0

    def synchronize(self) -> None:
        self.synced = True
        self.left = -1

    def elapsed_time(self, done) -> float:
        return done.ms - self.ms


def test_device_spans_resolve_in_the_writer_thread(tmp_path):
    """``record_op(events=(start, done))`` never waits in the caller: the
    writer thread polls the done event and writes the span with the
    events' elapsed time, anchored at the enqueue time, in record order;
    close() waits for any still pending."""
    path = str(tmp_path / "tl.json")
    tl = TT.Timeline(path)
    tl.enable_publish()
    ts = tl.now_us()
    start, done = _FakeEvent(1.0), _FakeEvent(3.5, ready_after=5)
    t0 = time.perf_counter()
    tl.record_op("grad/w", "EXEC", 64, ts_us=ts, events=(start, done))
    never = _FakeEvent(10.0, ready_after=10 ** 9)
    tl.record_op("grad/v", "EXEC", 32, ts_us=ts + 5.0,
                 events=(_FakeEvent(9.0), never))
    assert time.perf_counter() - t0 < 0.05  # no wait in the caller
    deadline = time.time() + 5
    while time.time() < deadline and not tl._chunk:
        time.sleep(0.01)
    chunk = tl.drain_chunk()
    assert [(e["lane"], e["dur"], e["ts"]) for e in chunk] == [
        ("grad/w", 2500.0, ts)]
    tl.close()
    assert never.synced
    x = [e for e in TT.load_trace_events(path) if e.get("ph") == "X"]
    assert [e["dur"] for e in x] == [2500.0, 1000.0]
    assert x[1]["ts"] - x[0]["ts"] == 5.0


def test_publisher_chunks_are_incremental(tmp_path):
    srv = RendezvousServer(host="127.0.0.1")
    port = srv.start()
    try:
        tl = TT.Timeline(str(tmp_path / "tl.json"))
        pub = TT.TimelinePublisher("127.0.0.1", port, rank=3, timeline=tl,
                                   interval=60.0)
        tl.instant("steps", "a")
        assert pub.publish_now()
        tl.instant("steps", "b")
        pub.close()  # the final publish carries the tail
        keys = sorted(srv.scope_items("timeline"))
        assert keys == ["rank.3.000000", "rank.3.000001"]
        merged = TT.merge_timeline_chunks(srv.scope_items("timeline"))
        assert [e["name"] for e in merged["traceEvents"]
                if e["ph"] == "i"] == ["a", "b"]
        assert merged == JT.merge_timeline_chunks(
            srv.scope_items("timeline"))
        tl.close()
    finally:
        srv.stop()


def test_clock_sync_and_routes_on_the_port_server(tmp_path):
    """``ClockSync`` against the port's ``GET /clock``, and ``GET
    /timeline`` serving the merge of what a publisher put."""
    srv = RendezvousServer(host="127.0.0.1")
    port = srv.start()
    try:
        clock = TCS.ClockSync("127.0.0.1", port)
        assert clock.synced and abs(clock.offset) < 0.5
        assert clock.meta()["uncertainty"] is not None
        jclock = JCS.ClockSync("127.0.0.1", port)
        assert jclock.synced
        tl = TT.Timeline(str(tmp_path / "tl.json"), clock=clock, rank=0)
        pub = TT.TimelinePublisher("127.0.0.1", port, rank=0, timeline=tl,
                                   interval=60.0, clock=clock)
        tl.record_op("g", "EXEC", 8, duration_us=5.0)
        assert pub.publish_now()
        merged = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{port}/timeline", timeout=10).read())
        assert any(e.get("name") == "EXEC" for e in merged["traceEvents"])
        assert merged["metadata"]["clock_sync"]["0"]["synced"] is True
        pub.close()
        tl.close()
        dead = TCS.ClockSync("127.0.0.1", _free_port(), samples=2,
                             timeout=0.2)
        assert not dead.synced and dead.meta()["uncertainty"] is None
    finally:
        srv.stop()


def _free_port() -> int:
    """A port below the ephemeral range, free when taken (``hold_ports``)."""
    return hold_ports(1).release()[0]


def test_native_drainer_over_the_port_core(tmp_path):
    hub = TB.LoopbackHub(2)
    cores = [TB.CoordinationCore.loopback(hub, r) for r in range(2)]
    path = str(tmp_path / "tl.json")
    tl = TT.Timeline(path)
    try:
        drainer = TT.NativeTraceDrainer(cores[0], tl, interval=30.0)
        for c in cores:
            c.submit("g", "f32:4:allreduce:1", TB.OP_ALLREDUCE, 16)
        for c in cores:
            assert c.wait(5.0) is not None
        time.sleep(0.05)
        assert drainer.drain_once() >= 6
        drainer.close()
    finally:
        for c in cores:
            c.shutdown()
        for c in cores:
            c.close()
        hub.close()
    tl.close()
    events = TT.load_trace_events(path)
    cyc = {(e["name"], e["ph"]) for e in events
           if str(e.get("name", "")).startswith("cycle.")}
    for phase in ("cycle.negotiate", "cycle.fuse", "cycle.respond"):
        assert (phase, "B") in cyc and (phase, "E") in cyc
    lanes = {e["args"]["name"] for e in events
             if e.get("name") == "process_name"}
    assert "controller" in lanes


def test_negotiated_lifecycle_on_the_cpu(monkeypatch, tmp_path):
    """The eager API under HOROVOD_TIMELINE: every name's NEGOTIATE, QUEUE
    and EXEC phases in that order on its lane, a cycle mark per response,
    the native core's spans on the controller lane, and the ages and
    collective counts in the registry."""
    from horovod_tpu_torch.utils import metrics as TM
    import horovod_tpu_torch.torch as ht
    path = str(tmp_path / "tl.json")
    monkeypatch.setenv("HOROVOD_CONTROLLER", "tcp")
    monkeypatch.setenv("HOROVOD_CONTROLLER_PORT", str(_free_port()))
    monkeypatch.setenv("HOROVOD_TIMELINE", path)
    monkeypatch.setenv("HOROVOD_TIMELINE_MARK_CYCLES", "1")
    ages0 = TM.NEGOTIATION_AGE.to_family()["samples"][0]["count"]
    ops0 = TM.COLLECTIVE_OPS.value(op="allreduce")
    hvd.init(device="cpu")
    try:
        for i in range(3):
            ht.allreduce(torch.ones(8) * i, name="grad.a")
            ht.grouped_allreduce([torch.ones(2), torch.ones(3)],
                                 name="grad.b")
        snap = hvd.metrics_snapshot()
    finally:
        hvd.shutdown()
    assert TM.NEGOTIATION_AGE.to_family()["samples"][0]["count"] == \
        ages0 + 6
    assert TM.COLLECTIVE_OPS.value(op="allreduce") == ops0 + 6
    assert snap["families"]["hvd_controller_cycles_total"][
        "samples"][0]["value"] > 0
    events = TT.load_trace_events(path)
    lanes = {e["pid"]: e["args"]["name"] for e in events
             if e.get("name") == "process_name"}
    for name in ("grad.a", "grad.b"):
        pid = next(p for p, n in lanes.items() if n == name)
        seq = [(e["name"], e["ph"]) for e in sorted(
            (e for e in events if e.get("pid") == pid and e["ph"] != "M"),
            key=lambda e: (e["ts"], e["ph"] == "X"))]
        assert seq == [("NEGOTIATE", "B"), ("NEGOTIATE", "E"),
                       ("QUEUE", "B"), ("QUEUE", "E"), ("EXEC", "X")] * 3
        assert all(e["dur"] > 0 for e in events
                   if e.get("pid") == pid and e["ph"] == "X")
    assert sum(e.get("name") == "CYCLE" for e in events) == 6
    assert any(str(e.get("name", "")).startswith("cycle.")
               for e in events)
