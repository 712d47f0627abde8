"""The port's watch plane against the JAX package's, fed the same seeded
snapshot stream: ``SeriesStore.query`` (the derived negotiation-age p99,
straggler skew and serve-component p99 series included) and
``AlertEngine.evaluate``/``view`` at every tick, ``parse_rules`` with its
rejections, ``merge_rules``, ``straggler_verdict``, the knob checks,
``GET /series`` and ``GET /alerts`` on both rendezvous servers, and the
doctor's ``--watch`` frame."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import json  # noqa: E402
import time  # noqa: E402
import urllib.request  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from horovod_tpu import watch as JW  # noqa: E402
from horovod_tpu.runner import doctor as JD  # noqa: E402
from horovod_tpu.runner.http_server import \
    RendezvousServer as JServer  # noqa: E402
from horovod_tpu.utils import metrics as JM  # noqa: E402
from horovod_tpu_torch import watch as TW  # noqa: E402
from horovod_tpu_torch.runner import doctor as TD  # noqa: E402
from horovod_tpu_torch.runner.http_server import \
    RendezvousServer as TServer  # noqa: E402
from horovod_tpu_torch.utils import metrics as TM  # noqa: E402


def _dump(x):
    return json.dumps(x, sort_keys=True)


def _hist(counts, bounds):
    return {"kind": "histogram", "help": "h", "bounds": list(bounds),
            "samples": [{"labels": {}, "counts": [int(c) for c in counts],
                         "sum": float(np.dot(counts, bounds[:len(counts)])),
                         "count": int(sum(counts))}]}


def _stream(seed: int, ranks: int = 3, ticks: int = 24):
    """[(t, rank, snapshot)]: rank 2 straggles from tick 8, rank 1's
    nonfinite counter moves at tick 12 and its loss goes NaN at tick 15,
    rank 0's memory watermark climbs, every rank serves."""
    rng = np.random.RandomState(seed)
    bounds = TM.BUCKET_BOUNDS
    ages = {r: np.zeros(len(bounds), int) for r in range(ranks)}
    comp = {r: np.zeros(len(bounds), int) for r in range(ranks)}
    out = []
    for k in range(ticks):
        t = 1000.0 + 0.5 * k
        for r in range(ranks):
            slow = r == 2 and k >= 8
            ages[r][16 if slow else 11] += int(rng.randint(3, 9))
            comp[r][int(rng.randint(8, 14))] += 1
            loss = float(3.0 - 0.05 * k + 0.01 * rng.randn())
            if r == 1 and k >= 15:
                loss = float("nan")
            fams = {
                "hvd_negotiation_age_seconds": _hist(ages[r], bounds),
                "hvd_serve_component_seconds": dict(
                    _hist(comp[r], bounds), samples=[
                        dict(_hist(comp[r], bounds)["samples"][0],
                             labels={"component": "handoff"})]),
                "hvd_sentinel_nonfinite_total": {
                    "kind": "counter", "help": "h", "samples": [
                        {"labels": {}, "value": int(r == 1 and k >= 12)}]},
                "hvd_sentinel_last_nonfinite_step": {
                    "kind": "gauge", "help": "h", "samples": [
                        {"labels": {}, "value": 12 if r == 1 else -1}]},
                "hvd_sentinel_loss": {"kind": "gauge", "help": "h",
                                      "samples": [{"labels": {},
                                                   "value": loss}]},
                "hvd_mem_watermark": {"kind": "gauge", "help": "h",
                                      "samples": [{"labels": {}, "value":
                                                   min(1.0, 0.05 * k)
                                                   if r == 0 else 0.3}]},
                "hvd_serve_sheds_total": {"kind": "counter", "help": "h",
                                          "samples": [{"labels": {},
                                                       "value": k // 6}]},
            }
            out.append((t + 0.01 * r, r, {"rank": r, "families": fams}))
    return out


_USER = [{"name": "loss-mad", "family": "hvd_sentinel_loss", "kind": "mad",
          "value": 3.0, "window": 20, "zero_band": 0.5},
         {"name": "sheds-info", "family": "hvd_serve_sheds_total",
          "kind": "roc", "op": ">=", "value": 0.0, "window": 5,
          "severity": "info", "rank": 0},
         {"name": "straggler-suspect", "family": "hvd_straggler_skew",
          "kind": "threshold", "op": ">=", "value": 8.0, "for": 1.0}]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("user", [False, True])
def test_series_and_alerts_match_jax_tick_by_tick(seed, user):
    stores = [TW.SeriesStore(retention_s=6.0, resolution_s=0.4),
              JW.SeriesStore(retention_s=6.0, resolution_s=0.4)]
    rules = [W.parse_rules(_USER) if user else None for W in (TW, JW)]
    engines = [W.AlertEngine(s, rules=r)
               for W, s, r in zip((TW, JW), stores, rules)]
    fired = set()
    for t, rank, snap in _stream(seed):
        got = [s.ingest_snapshot(rank, snap, t) for s in stores]
        assert got[0] == got[1]
        now = t + 0.05
        firing = [e.evaluate(now) for e in engines]
        assert _dump(firing[0]) == _dump(firing[1])
        fired |= {(f["rule"], f["rank"]) for f in firing[0]}
        for q in ({}, {"family": "hvd_straggler_skew"}, {"rank": 1},
                  {"window_s": 2.0}):
            assert _dump(stores[0].query(now=now, **q)) == \
                _dump(stores[1].query(now=now, **q))
    views = [e.view(now=now + 1.0) for e in engines]
    assert _dump(views[0]) == _dump(views[1])
    assert {("straggler-suspect", 2), ("sentinel-nonfinite", 1),
            ("sentinel-loss-nonfinite", 1)} <= fired
    assert stores[0].families() == stores[1].families()
    assert "hvd_serve_handoff_p99_seconds" in stores[0].families()


def test_watch_state_ingest_matches_jax():
    states = [TW.WatchState(retention_s=60, resolution_s=0.2),
              JW.WatchState(retention_s=60, resolution_s=0.2)]
    for t, rank, snap in _stream(3, ticks=10):
        body = json.dumps(snap).encode()
        got = [s.ingest_metrics(f"rank.{rank}", body, t) for s in states]
        assert got[0] == got[1]
        for s in states:
            s.note_heartbeat(f"rank.{rank}", t)
    for s in states:
        assert not s.ingest_metrics("rank.0", b"{torn", 5000.0)
    assert _dump(states[0].store.query(now=1010.0)) == \
        _dump(states[1].store.query(now=1010.0))


_RULE_DOCS = [
    {"rules": [{"name": "a", "family": "f", "kind": "roc", "for": 3,
                "window": 10},
               {"name": "b", "family": "f", "kind": "mad-anomaly"}]},
    [{"name": "a", "family": "f", "kind": "rate-of-change"}],
    None, [], {"rules": None},
    [{"name": "a", "family": "f", "kind": "treshold"}],
    [{"name": "a", "family": "f", "kind": "threshold", "treshold": 4}],
    [{"name": "a", "family": "f", "kind": "threshold", "op": "=="}],
    [{"name": "a", "family": "f", "kind": "threshold",
      "severity": "panic"}],
    [{"name": "a", "family": "f", "kind": "threshold"},
     {"name": "a", "family": "g", "kind": "absence"}],
    [{"family": "f", "kind": "threshold"}],
    {"rule": []}, "rules", 7, ["x"],
    [{"name": "a", "family": "f", "kind": "threshold", "for": -1}],
    [{"name": "a", "family": "f", "kind": "absence", "window": 0}],
    [{"name": "a", "family": "f", "kind": "threshold", "value": "9",
      "window": 4, "zero_band": 1, "rank": 2, "context_family": "g"}],
]


@pytest.mark.parametrize("doc", range(len(_RULE_DOCS)))
def test_parse_rules_matches_jax(doc):
    def run(W):
        try:
            return ("ok", [r.describe() for r in W.parse_rules(
                _RULE_DOCS[doc])])
        except ValueError as e:
            return ("error", str(e))
    assert run(TW) == run(JW)


def test_loads_rules_and_wire_format_match_jax(tmp_path):
    text = json.dumps({"rules": _USER})
    for W in (TW, JW):
        path = tmp_path / "rules.json"
        path.write_text(text)
        assert [r.describe() for r in W.load_rules(str(path))] == \
            [r.describe() for r in JW.loads_rules(text)]
    assert TW.rules_to_json(TW.loads_rules(text)) == \
        JW.rules_to_json(JW.loads_rules(text))


@pytest.mark.parametrize("user", [None, [], _USER])
def test_merge_rules_matches_jax(user):
    got = TW.merge_rules(TW.parse_rules(user) if user else user)
    want = JW.merge_rules(JW.parse_rules(user) if user else user)
    assert [r.describe() for r in got] == [r.describe() for r in want]
    assert [r.describe() for r in TW.DEFAULT_RULES] == \
        [r.describe() for r in JW.DEFAULT_RULES]


_P99S = [{}, {0: 0.064}, {0: 0.001, 1: 0.064}, {0: 0.001, 1: 0.0011},
         {0: 1e-6, 1: 1e-4}, {0: 0.002, 1: 0.002, 2: 0.05, 3: 0.003},
         {0: 0.01, 1: 0.04, 2: 0.01}]


@pytest.mark.parametrize("case", range(len(_P99S)))
def test_straggler_verdict_matches_jax(case):
    p99 = _P99S[case]
    for ratio in (2.0, 4.0, 8.0):
        assert TW.straggler_verdict(p99, skew_ratio=ratio) == \
            JW.straggler_verdict(p99, skew_ratio=ratio)
    assert TW.straggler_skew(p99) == JW.straggler_skew(p99)
    # the metrics plane's straggler check is the watch plane's function
    assert TM.straggler_verdict is TW.straggler_verdict


def test_detect_straggler_matches_jax():
    snaps = {t_rank: snap for _, t_rank, snap in _stream(0, ticks=12)}
    assert TM.detect_straggler(snaps) == JM.detect_straggler(snaps)
    assert TM.detect_straggler(snaps)["rank"] == 2


_KNOB_CASES = [
    {"HOROVOD_SERIES_RETENTION": 600.0, "HOROVOD_SERIES_RESOLUTION": 5.0,
     "HOROVOD_SENTINEL_INTERVAL": 1, "HOROVOD_ALERTS": ""},
    {"HOROVOD_SERIES_RETENTION": 0.0},
    {"HOROVOD_SERIES_RESOLUTION": -1.0},
    {"HOROVOD_SERIES_RETENTION": 10.0, "HOROVOD_SERIES_RESOLUTION": 60.0},
    {"HOROVOD_SENTINEL_INTERVAL": 0},
    {"HOROVOD_ALERTS": "MISSING"},
    {"HOROVOD_ALERTS": "BAD"},
    {"HOROVOD_ALERTS": "GOOD"},
]


@pytest.mark.parametrize("case", range(len(_KNOB_CASES)))
def test_validate_watch_knobs_matches_jax(tmp_path, case):
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps([{"name": "a", "family": "f",
                                "kind": "nope"}]))
    good = tmp_path / "good.json"
    good.write_text(json.dumps([{"name": "a", "family": "f",
                                 "kind": "threshold"}]))
    files = {"MISSING": str(tmp_path / "no.json"), "BAD": str(bad),
             "GOOD": str(good)}
    knobs = {k: files.get(v, v) if isinstance(v, str) else v
             for k, v in _KNOB_CASES[case].items()}

    def run(W):
        try:
            W.validate_watch_knobs(knobs)
            return "ok"
        except ValueError as e:
            return str(e)
    assert run(TW) == run(JW)


def test_init_refuses_bad_watch_knobs(monkeypatch):
    import horovod_tpu_torch as hvd
    monkeypatch.setenv("HOROVOD_SENTINEL_INTERVAL", "0")
    with pytest.raises(ValueError, match="SENTINEL_INTERVAL"):
        hvd.init(device="cpu")
    assert not hvd.is_initialized()


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=10) as r:
        return json.loads(r.read())


def _put(port, scope, key, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/{scope}/{key}",
                                 data=body, method="PUT")
    urllib.request.urlopen(req, timeout=10).close()


def test_series_and_alerts_routes_match_jax(monkeypatch):
    """The same PUTs into both servers: the user rule merged over the
    defaults fires at GET /alerts on both, /series serves the same
    history, the merged ruleset sits at alerts/rules, the firing lands on
    rank 1's timeline lane and heartbeats feed the absence series."""
    monkeypatch.setenv("HOROVOD_SERIES_RESOLUTION", "0.01")
    servers = [TServer(host="127.0.0.1"), JServer(host="127.0.0.1")]
    ports = [s.start() for s in servers]
    try:
        for srv, W in zip(servers, (TW, JW)):
            srv.install_alert_rules(W.parse_rules([
                {"name": "queue-deep", "family": "hvd_serve_queue_depth",
                 "kind": "threshold", "value": 10,
                 "severity": "critical"}]))
        snap = {"rank": 1, "families": {"hvd_serve_queue_depth": {
            "kind": "gauge", "help": "h",
            "samples": [{"labels": {}, "value": 42}]}}}
        for port in ports:
            _put(port, "metrics", "rank.1", json.dumps(snap).encode())
            _put(port, "health", "rank.1", json.dumps({"rank": 1}).encode())
        views = []
        for srv, port in zip(servers, ports):
            deadline = time.time() + 10
            while True:  # ingest runs after the PUT's answer: poll
                alerts = _get(port, "/alerts")
                if (alerts["firing"] and srv.watch_state.store.latest(
                        1, "heartbeat") is not None) \
                        or time.time() > deadline:
                    break
                time.sleep(0.02)
            views.append(alerts)
        for v in views:
            assert [(f["rule"], f["rank"], f["severity"])
                    for f in v["firing"]] == [("queue-deep", 1, "critical")]
            for key in ("now", "history", "firing"):
                v.pop(key)
        assert views[0] == views[1]
        series = [_get(p, "/series?family=hvd_serve_queue_depth")
                  for p in ports]
        for s in series:
            assert [x["rank"] for x in s["series"]] == [1]
            assert {p[1] for p in s["series"][0]["points"]} == {42.0}
            assert _get(ports[0], "/series?rank=7")["series"] == []
        assert [_get(p, "/alerts/rules") for p in ports][0] == \
            _get(ports[1], "/alerts/rules")
        merged = _get(ports[0], "/timeline")
        lanes = [e["pid"] for e in merged["traceEvents"]
                 if e.get("name") == "alert.queue-deep"]
        assert lanes == [1]
    finally:
        for s in servers:
            s.stop()


_VIEW = {
    "alerts": {
        "now": 1000.0,
        "firing": [
            {"rule": "sentinel-nonfinite", "severity": "critical",
             "kind": "rate_of_change",
             "family": "hvd_sentinel_nonfinite_total", "rank": 1,
             "since": 990.0, "value": 0.2,
             "context": {"hvd_sentinel_last_nonfinite_step": 7.0}},
            {"rule": "straggler-suspect", "severity": "warning",
             "kind": "threshold", "family": "hvd_straggler_skew",
             "rank": 1, "since": 995.0, "value": 5.25}],
        "rules": [{"name": f"r{i}"} for i in range(9)],
        "user_rules": ["r8"],
        "fired_total": [{"rule": "sentinel-nonfinite",
                         "severity": "critical", "count": 1},
                        {"rule": "straggler-suspect",
                         "severity": "warning", "count": 3}]},
    "series": {
        "now": 1000.0,
        "series": [
            {"rank": 1, "family": "hvd_straggler_skew",
             "points": [[996.0, 1.0], [998.0, 3.0], [1000.0, 5.25]]},
            {"rank": 0, "family": "hvd_controller_cycle_rate",
             "points": [[998.0, 100.0], [1000.0, 100.0]]},
            {"rank": 0, "family": "hvd_sentinel_loss",
             "points": [[999.0, float("nan")], [1000.0, 2.5]]},
            {"rank": 0, "family": "hvd_unrelated",
             "points": [[1000.0, 1.0]]}]},
}


@pytest.mark.parametrize("case", ["golden", "quiet", "bare-alerts"])
def test_doctor_watch_frame_matches_jax(tmp_path, case, capsys):
    view = json.loads(json.dumps(_VIEW))
    if case == "quiet":
        view["alerts"]["firing"] = []
    if case == "bare-alerts":
        view = view["alerts"]
    path = tmp_path / "watch.json"
    path.write_text(json.dumps(view))
    assert TD.main(["--watch", str(path), "--once"]) == 0
    got = capsys.readouterr().out
    assert JD.main(["--watch", str(path), "--once"]) == 0
    assert got == capsys.readouterr().out
    assert got.startswith("== hvdrun doctor --watch: fleet alerts")
    if case != "bare-alerts":
        assert TD.render_watch(view) == JD.render_watch(view)
    assert TD.main(["--watch", str(tmp_path / "nope.json"), "--once"]) == 2


def test_doctor_watch_reads_a_live_server(capsys):
    srv = TServer(host="127.0.0.1")
    port = srv.start()
    try:
        assert TD.main(["--watch", f"127.0.0.1:{port}", "--once"]) == 0
        out = capsys.readouterr().out
        assert "FIRING (0): fleet quiet" in out
        assert f"rules: {len(TW.DEFAULT_RULES)} active" in out
    finally:
        srv.stop()


def test_serve_stats_carry_the_firing_alerts(monkeypatch):
    """``GET /serve/stats`` carries the watch plane's firing alerts beside
    the admission state, as the JAX router's view does."""
    monkeypatch.setenv("HOROVOD_SERIES_RESOLUTION", "0.01")
    srv = TServer(host="127.0.0.1")
    port = srv.start()
    try:
        srv.install_alert_rules(TW.parse_rules([
            {"name": "queue-deep", "family": "hvd_serve_queue_depth",
             "kind": "threshold", "value": 10, "severity": "critical"}]))
        snap = {"rank": 0, "families": {"hvd_serve_queue_depth": {
            "kind": "gauge", "help": "h",
            "samples": [{"labels": {}, "value": 42}]}}}
        _put(port, "metrics", "rank.0", json.dumps(snap).encode())
        deadline = time.time() + 10
        while True:
            alerts = _get(port, "/serve/stats").get("alerts")
            if (alerts and alerts["firing"]) or time.time() > deadline:
                break
            time.sleep(0.02)
        assert alerts == {"firing": 1, "critical": 1,
                          "rules": ["queue-deep"]}
    finally:
        srv.stop()
