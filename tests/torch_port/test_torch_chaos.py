"""The port's chaos plane against the JAX package's: ``parse_spec`` accepts
and rejects the same specs with the same messages, ``merge_specs`` and
``transport_env`` give equal results, the injector draws the same
schedule for the same seed and rank (its random stream, its kills,
stalls and crashes, its ``maybe_fail_kv`` verdicts over a run of KV
operations), and the port's hooks fire: the KV client rides a blackout,
the negotiated path and the stall inspector stall at their points, and the
runtime installs the injector from a spec file or the rendezvous."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import dataclasses  # noqa: E402
import json  # noqa: E402
import urllib.error  # noqa: E402

import pytest  # noqa: E402

from horovod_tpu import chaos as JC  # noqa: E402
from horovod_tpu.chaos import injector as JI  # noqa: E402
import horovod_tpu_torch as hvd  # noqa: E402
from horovod_tpu_torch import chaos as TC  # noqa: E402
from horovod_tpu_torch.chaos import injector as TI  # noqa: E402
from horovod_tpu_torch.common.knobs import KNOBS  # noqa: E402
from horovod_tpu_torch.runner import http_client as THC  # noqa: E402
from horovod_tpu_torch.runner.http_server import \
    RendezvousServer as TServer  # noqa: E402
from torch_port_ports import hold_ports  # noqa: E402


@pytest.fixture(autouse=True)
def no_injector():
    TC.uninstall()
    JC.uninstall()
    yield
    TC.uninstall()
    JC.uninstall()


_SPECS = [
    {"seed": 42, "state_dir": "/tmp/x",
     "transport": {"close_after": 5, "rank": 1},
     "events": [{"kill": {"rank": 1, "step": 2, "exit_code": 1}},
                {"stall": {"rank": 1, "point": "negotiate",
                           "duration_ms": 30}},
                {"kv_blackout": {"op": "put", "count": 2}},
                {"kv_blackout": {"op": "get", "scope": "serve_plan",
                                 "count": 3}},
                {"kv_blackout": {"shard": 1, "step": 12, "count": 6}},
                {"crash_commit": {"rank": 0, "step": 3,
                                  "point": "pre_marker"}},
                {"kind": "stall", "rank": 0, "step": 4,
                 "duration_ms": 100}]},
    {"seed": 9, "transport": {"dup_rate": 0.5, "delay_ms": 3},
     "events": [{"kind": "kv_blackout", "op": "put", "count": 2}]},
    {}, {"events": None}, {"events": [{"stall": None}]},
    {"events": [{"kind": "explode"}]},
    {"events": [{"kill": {"rank": 0}, "stall": {}}]},
    {"transport": {"nuke_rate": 1.0}},
    {"events": [{"kind": "kill", "blast_radius": 2}]},
    {"chaos": True}, [1, 2], "spec",
    {"events": [{"kind": "kill", "rank": "one"}]},
    {"events": [{"kind": "kill"}, {"stall": {"duration_ms": "long"}}]},
    {"events": [{"kv_blackout": {"op": 3}}]},
    {"events": [{"kind": "kill", "rank": True}]},
    {"events": [{"kill": "rank 1"}]},
    {"events": ["kill"]},
    {"events": [{"stall": {"duration_ms": 1.5, "rank": 2}}]},
]


def _parsed(C, doc):
    try:
        spec = C.parse_spec(doc)
    except ValueError as e:
        return ("error", str(e))
    return ("ok", spec.to_json(), spec.transport_env(),
            [dataclasses.asdict(e) for e in spec.events])


@pytest.mark.parametrize("doc", range(len(_SPECS)))
def test_parse_spec_matches_jax(doc):
    assert _parsed(TC, _SPECS[doc]) == _parsed(JC, _SPECS[doc])


@pytest.mark.parametrize("doc", [0, 1])
def test_spec_wire_format_round_trips_across_packages(doc, tmp_path):
    text = TC.parse_spec(_SPECS[doc]).to_json()
    assert JC.loads_spec(text).to_json() == text
    path = tmp_path / "spec.json"
    path.write_text(text)
    assert TC.load_spec(str(path)).to_json() == \
        JC.load_spec(str(path)).to_json()


def test_transport_env_names_registered_knobs():
    env = TC.parse_spec(_SPECS[0]).transport_env()
    assert env == {"HOROVOD_CHAOS_TCP_CLOSE_AFTER": "5",
                   "HOROVOD_CHAOS_TCP_RANK": "1",
                   "HOROVOD_CHAOS_SEED": "42"}
    for name in list(TC.spec.TRANSPORT_ENV.values()) + [
            "HOROVOD_CHAOS", "HOROVOD_CHAOS_SPEC", "HOROVOD_CHAOS_SEED"]:
        assert name in KNOBS


_MERGES = [
    ({"seed": 9, "events": [{"kind": "stall", "rank": 0, "step": 1}]},
     {"state_dir": "/tmp/st", "transport": {"dup_rate": 0.25},
      "events": [{"kill": {"rank": 1, "step": 5}}]}),
    ({"seed": 9}, {"seed": 9}),
    ({"seed": 9}, {"seed": 10}),
    ({"state_dir": "/a"}, {"state_dir": "/b"}),
    ({"transport": {"dup_rate": 0.1}}, {"transport": {"dup_rate": 0.2}}),
    ({"transport": {"dup_rate": 0.1}}, {"transport": {"drop_rate": 0.2}}),
]


@pytest.mark.parametrize("case", range(len(_MERGES)))
def test_merge_specs_matches_jax(case):
    def run(C):
        base, extra = (C.parse_spec(d) for d in _MERGES[case])
        try:
            return ("ok", C.merge_specs(base, extra).to_json())
        except ValueError as e:
            return ("error", str(e))
    assert run(TC) == run(JC)


@pytest.mark.parametrize("seed", [0, 7, 1234, 2 ** 63 + 5])
@pytest.mark.parametrize("rank", [0, 1, 3])
def test_injector_stream_matches_jax(seed, rank):
    assert TI.rank_stream_seed(seed, rank) == JI.rank_stream_seed(seed,
                                                                  rank)
    spec = {"seed": seed}
    a = TI.ChaosInjector(TC.parse_spec(spec), rank).rng
    b = JI.ChaosInjector(JC.parse_spec(spec), rank).rng
    assert [a.random() for _ in range(64)] == [b.random() for _ in range(64)]


def _schedule(C, I, rank, tmp_path):
    """Everything one injector does over steps 0-5, the named points and
    a fastcommit crash window, as a list of (what, value)."""
    log = []
    doc = json.loads(json.dumps(_SPECS[0]))
    doc["state_dir"] = str(tmp_path / f"state.{C.__name__}")

    def exit_fn(code):
        log.append(("exit", code))

    inj = I.ChaosInjector(C.parse_spec(doc), rank, exit_fn=exit_fn,
                          sleep_fn=lambda s: log.append(("sleep", s)))
    for step in range(6):
        inj.on_step(step)
        inj.on_step(step)  # the kill is one-shot under a state_dir
    for point in ("negotiate", "complete", "serve_tick"):
        inj.maybe_stall(point)
    for step in (2, 3, 3):
        for point in ("fastcommit.pre_marker", "fastcommit.pre_manifest"):
            inj.crash_point(point, step)
    return log


@pytest.mark.parametrize("rank", [0, 1, 2])
def test_injector_schedule_matches_jax(rank, tmp_path):
    got = _schedule(TC, TI, rank, tmp_path)
    assert got == _schedule(JC, JI, rank, tmp_path)
    # rank 1 is killed at step 2, rank 0 crashes inside a fastcommit
    assert (("exit", 1) in got) == (rank in (0, 1))


_KV_OPS = [("put", "metrics"), ("get", "serve_plan"), ("put", "serve_plan"),
           ("get", "health"), ("put", "rank"), ("get", "serve_plan"),
           ("get", "serve_plan"), ("put", "chaos")] * 4


@pytest.mark.parametrize("shards", ["1", "3"])
@pytest.mark.parametrize("rank", [0, 1])
def test_maybe_fail_kv_verdicts_match_jax(monkeypatch, shards, rank):
    monkeypatch.setenv("HOROVOD_KV_SHARDS", shards)

    def verdicts(C, I):
        inj = I.ChaosInjector(C.parse_spec(_SPECS[0]), rank)
        out = []
        for op, scope in _KV_OPS:
            try:
                inj.maybe_fail_kv(op, scope)
                out.append("ok")
            except urllib.error.URLError as e:
                out.append(str(e.reason))
        return out
    got = verdicts(TC, TI)
    assert got == verdicts(JC, JI)
    assert got.count("ok") < len(got)


def test_put_kv_rides_out_an_injected_blackout():
    server = TServer(host="127.0.0.1")
    port = server.start()
    TC.install(TC.parse_spec({"events": [
        {"kind": "kv_blackout", "op": "put", "count": 2}]}), rank=0)
    try:
        THC.put_kv("127.0.0.1", port, "s", "k", b"v", retries=3)
        assert THC.get_kv("127.0.0.1", port, "s", "k", timeout=2) == b"v"
        TC.install(TC.parse_spec({"events": [
            {"kind": "kv_blackout", "op": "put", "count": 9}]}), rank=0)
        with pytest.raises(urllib.error.URLError, match="blackout"):
            THC.put_kv("127.0.0.1", port, "s", "k", b"v", retries=2)
    finally:
        server.stop()


def test_hook_points_stall_on_the_port(monkeypatch):
    """``maybe_stall`` at the stall inspector's complete and the module
    hooks: an injector whose sleeps are recorded sees each named point."""
    slept = []
    inj = TC.install(TC.parse_spec({"events": [
        {"kind": "stall", "point": p, "duration_ms": 5}
        for p in ("negotiate", "complete")]}), rank=0)
    monkeypatch.setattr(inj, "_sleep", slept.append)
    from horovod_tpu_torch.utils.stall import StallInspector
    si = StallInspector(poll_interval=60.0)
    try:
        si.record_submit("t")
        si.record_complete("t")
    finally:
        si.close()
    TC.maybe_stall("negotiate")
    TC.step(3)
    TC.crash_point("fastcommit.pre_marker", 1)
    assert slept == [0.005, 0.005]


def _free_port() -> int:
    """A port below the ephemeral range, free when taken (``hold_ports``)."""
    return hold_ports(1).release()[0]


def test_negotiated_ops_stall_at_negotiate(monkeypatch):
    import torch
    import horovod_tpu_torch.torch as ht
    monkeypatch.setenv("HOROVOD_CONTROLLER", "tcp")
    monkeypatch.setenv("HOROVOD_CONTROLLER_PORT", str(_free_port()))
    slept = []
    inj = TC.install(TC.parse_spec({"events": [
        {"kind": "stall", "point": "negotiate", "duration_ms": 7}]}),
        rank=0)
    monkeypatch.setattr(inj, "_sleep", slept.append)
    ht.init(device="cpu")
    try:
        out = ht.allreduce(torch.ones(3), name="x", op=hvd.Sum)
        assert out.tolist() == [1.0, 1.0, 1.0]
    finally:
        ht.shutdown()
    assert slept == [0.007]


def test_runtime_installs_the_spec_file(monkeypatch, tmp_path):
    path = tmp_path / "spec.json"
    path.write_text(json.dumps({"seed": 5, "events": [
        {"stall": {"duration_ms": 1}}]}))
    monkeypatch.setenv("HOROVOD_CHAOS_SPEC", str(path))
    hvd.init(device="cpu")
    try:
        inj = TC.active()
        assert inj is not None and inj.rank == 0 and inj.spec.seed == 5
    finally:
        hvd.shutdown()


def test_ensure_installed_from_the_rendezvous(monkeypatch):
    spec = TC.parse_spec({"seed": 21, "events": [
        {"kind": "stall", "rank": 0, "point": "x", "duration_ms": 1}]})
    server = TServer(host="127.0.0.1")
    port = server.start()
    server.put(TC.KV_SCOPE, TC.KV_KEY, spec.to_json().encode())
    monkeypatch.setenv("HOROVOD_CHAOS", "1")
    monkeypatch.setenv("HOROVOD_RENDEZVOUS_ADDR", "127.0.0.1")
    monkeypatch.setenv("HOROVOD_RENDEZVOUS_PORT", str(port))
    monkeypatch.setenv("HOROVOD_RANK", "1")
    try:
        inj = TC.ensure_installed()
        assert inj is not None and inj.spec.seed == 21 and inj.rank == 1
        assert TC.ensure_installed() is inj
    finally:
        server.stop()


def test_ensure_installed_survives_a_bad_spec(monkeypatch, tmp_path):
    path = tmp_path / "bad.json"
    path.write_text(json.dumps({"events": [{"kind": "explode"}]}))
    monkeypatch.setenv("HOROVOD_CHAOS_SPEC", str(path))
    assert TC.ensure_installed() is None and TC.active() is None
