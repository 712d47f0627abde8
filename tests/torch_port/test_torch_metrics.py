"""The port's metrics registry (``horovod_tpu_torch/utils/metrics.py``),
stall inspector (``utils/stall.py``) and logging
(``common/hvdlogging.py``) against the JAX package's, on the same inputs
made from a seed with numpy: the standard family sets, byte-identical
expositions of equal values, the exposition linter's verdicts, the native
core's metrics import, the straggler report and verdict, the stall
inspector's warn and shutdown behaviour, the log level and timestamp
handling, and the serving engine's families after the same plan."""

import dataclasses
import json
import logging
import os
import socket
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from horovod_tpu.common import basics as JB  # noqa: E402
from horovod_tpu.common import hvdlogging as JLOG  # noqa: E402
from horovod_tpu.common.exceptions import StallError as JStallError  # noqa
from horovod_tpu.utils import metrics as JM  # noqa: E402
from horovod_tpu.utils import stall as JS  # noqa: E402

from horovod_tpu_torch.common import basics as TB  # noqa: E402
from horovod_tpu_torch.common import hvdlogging as TLOG  # noqa: E402
from horovod_tpu_torch.common.exceptions import StallError  # noqa: E402
from horovod_tpu_torch.runner.http_server import \
    RendezvousServer  # noqa: E402
from horovod_tpu_torch.utils import metrics as TM  # noqa: E402
from horovod_tpu_torch.utils import stall as TS  # noqa: E402


def _families(mod):
    snap = mod.REGISTRY.snapshot()
    return {(name, f["kind"], f["help"], tuple(f.get("bounds", ())))
            for name, f in snap["families"].items()}


# ------------------------------------------------------------- families
def test_standard_families_equal_jax():
    """Every standard family, its type, help text and buckets, letter for
    letter: a scrape from either package reads the same."""
    port, jax_ = _families(TM), _families(JM)
    assert port == jax_
    assert len(port) == 123
    assert TM.BUCKET_BOUNDS == JM.BUCKET_BOUNDS
    assert TM.SNAPSHOT_VERSION == JM.SNAPSHOT_VERSION


def _record(mod, rng):
    """One registry of each kind of family, filled by the same seeded
    operations (counters with labels, gauges, histograms with default and
    custom bounds, native imports)."""
    r = mod.MetricsRegistry()
    c = r.counter("hvd_collective_ops_total", "Eager collective calls.")
    g = r.gauge("hvd_serve_batch_fill", "Fill.")
    h = r.histogram("hvd_collective_latency_seconds", "Latency.")
    hb = r.histogram("hvd_fusion_bucket_bytes", "Bytes.",
                     bounds=tuple(float(1 << b) for b in range(28)))
    ops = ("allreduce", "allgather", "broadcast")
    for _ in range(40):
        op = ops[rng.randint(3)]
        c.inc(float(rng.randint(1, 5)), op=op)
        h.observe(float(rng.exponential(1e-3)), op=op)
        hb.observe(float(rng.randint(1, 1 << 26)))
        g.set(float(rng.rand()), slot=str(rng.randint(2)))
    c.set_total(7.0, op="barrier")
    h.set_native([int(x) for x in rng.randint(0, 9, 28)], 1.25, 11,
                 op="native")
    return r


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_exposition_of_equal_values_is_byte_identical(seed):
    port = _record(TM, np.random.RandomState(seed))
    jax_ = _record(JM, np.random.RandomState(seed))
    for labels in ({}, {"rank": "3"}):
        got = TM.render_prometheus([(labels, port.snapshot())])
        want = JM.render_prometheus([(labels, jax_.snapshot())])
        assert got == want
        assert TM.lint_exposition(got) == []
    h = port.get("hvd_collective_latency_seconds")
    hj = jax_.get("hvd_collective_latency_seconds")
    for q in (0.5, 0.99):
        assert h.quantile(q, op="allreduce") == hj.quantile(q,
                                                           op="allreduce")


def test_full_standard_registry_renders_alike_and_lint_clean():
    snap = TM.REGISTRY.snapshot()
    got = TM.render_prometheus([({"rank": "0"}, snap), ({"rank": "1"},
                                                        snap)])
    assert got == JM.render_prometheus([({"rank": "0"}, snap),
                                        ({"rank": "1"}, snap)])
    assert TM.lint_exposition(got) == []


def _golden():
    r = JM.MetricsRegistry()
    r.counter("demo_ops_total", "Ops processed.").inc(3, op="allreduce")
    r.gauge("demo_temp", "Current temperature.").set(1.5)
    h = r.histogram("demo_latency_seconds", "Latency.", bounds=(1.0, 2.0))
    for v in (0.5, 0.5, 2.5):
        h.observe(v)
    return JM.render_prometheus([({"rank": "0"}, r.snapshot())])


_LINT_CASES = {
    "golden": lambda g: g,
    "no TYPE": lambda g: "nope_total 1\n",
    "non-numeric": lambda g: g.replace('demo_temp{rank="0"} 1.5',
                                       'demo_temp{rank="0"} x'),
    "missing +Inf": lambda g: g.replace(
        'demo_latency_seconds_bucket{le="+Inf",rank="0"} 3\n', ""),
    "duplicate series": lambda g: g + 'demo_temp{rank="0"} 2\n',
    "malformed label": lambda g: g.replace('op="allreduce"', 'op=allreduce'),
    "bare histogram": lambda g: g + 'demo_latency_seconds{rank="0"} 1\n',
}


@pytest.mark.parametrize("case", sorted(_LINT_CASES))
def test_lint_verdicts_match_jax(case):
    text = _LINT_CASES[case](_golden())
    got = TM.lint_exposition(text)
    assert got == JM.lint_exposition(text)
    assert (got == []) == (case == "golden")


# ------------------------------------------------------- the native core
def _drive(B, n_ops=6):
    hub = B.LoopbackHub(2)
    cores = [B.CoordinationCore.loopback(hub, r, cycle_ms=1.0)
             for r in range(2)]
    try:
        for i in range(n_ops):
            for c in cores:
                c.submit(f"t{i}", f"f32:{i + 1}:allreduce:1",
                         B.OP_ALLREDUCE, 4 * (i + 1))
            for c in cores:
                assert c.wait(timeout_s=10.0) is not None
        return [c.metrics() for c in cores], cores[0].metrics_window()
    finally:
        for c in cores:
            c.shutdown()
        for c in cores:
            c.close()
        hub.close()


def test_import_core_metrics_from_the_port_core():
    """The port's core exports the JAX core's metrics schema (the same C++
    source), and ``import_core_metrics``/``import_window_rates`` map it
    onto the registry as the JAX functions do."""
    port, window = _drive(TB)
    jax_, jwindow = _drive(JB)
    assert port[0]["version"] == jax_[0]["version"] == 1
    assert set(port[0]["counters"]) == set(jax_[0]["counters"])
    assert set(port[0]["histograms"]) == set(jax_[0]["histograms"])
    assert set(window) == set(jwindow)
    for m in port:
        assert m["counters"]["cycles"] > 0
        assert m["counters"]["tensors_negotiated"] >= 6
        for h in m["histograms"].values():
            assert sum(h["buckets"]) == h["count"]
    TM.import_core_metrics(port[0])
    JM.import_core_metrics(port[0])
    TM.import_window_rates(window)
    JM.import_window_rates(window)
    names = [n for n in TM.REGISTRY.snapshot()["families"]
             if n.startswith(("hvd_controller_", "hvd_transport_"))]
    assert len(names) > 20
    tsnap = TM.REGISTRY.snapshot()["families"]
    jsnap = JM.REGISTRY.snapshot()["families"]
    for n in names:
        assert tsnap[n] == jsnap[n], n


# ---------------------------------------------------- straggler report
def _age_snapshots(seed, n_ranks, slow):
    rng = np.random.RandomState(seed)
    snaps = {}
    for r in range(n_ranks):
        reg = TM.MetricsRegistry()
        h = reg.histogram("hvd_negotiation_age_seconds", "age")
        scale = 0.2 if r == slow else 2e-3
        for v in rng.exponential(scale, 50):
            h.observe(float(v))
        snaps[r] = reg.snapshot()
    return snaps


@pytest.mark.parametrize("seed,n_ranks,slow", [
    (0, 4, 2), (1, 2, 0), (2, 4, None), (3, 1, None), (4, 8, 7)])
def test_straggler_report_and_verdict_match_jax(seed, n_ranks, slow):
    snaps = _age_snapshots(seed, n_ranks, slow)
    assert TM.straggler_report(snaps) == JM.straggler_report(snaps)
    got = TM.detect_straggler(snaps)
    assert got == JM.detect_straggler(snaps)
    if slow is not None and n_ranks > 1:
        assert got is not None and got["rank"] == slow
    else:
        assert got is None
    from horovod_tpu.watch.rules import straggler_skew
    p99 = {r: JM._age_rows(snaps)[i][2] for i, r in enumerate(sorted(snaps))}
    assert TM.straggler_skew(p99) == straggler_skew(p99)


def test_straggler_monitor_sets_the_gauge_and_warns_once():
    logs = []
    snaps = _age_snapshots(0, 4, 1)
    mon = TM.StragglerMonitor(lambda: snaps, interval=60.0,
                              log_fn=logs.append)
    assert mon.check_once()["rank"] == 1
    assert mon.check_once()["rank"] == 1
    assert TM.STRAGGLER_SUSPECT.value() == 1
    assert len(logs) == 1 and "rank 1" in logs[0]
    mon = TM.StragglerMonitor(lambda: _age_snapshots(0, 4, None), 60.0,
                              log_fn=logs.append)
    assert mon.check_once() is None
    assert TM.STRAGGLER_SUSPECT.value() == -1


def test_metrics_publisher_reaches_the_fleet_view():
    server = RendezvousServer(host="127.0.0.1")
    port = server.start()
    try:
        pub = TM.MetricsPublisher("127.0.0.1", port, rank=3,
                                  snapshot_fn=TM.REGISTRY.snapshot,
                                  interval=60.0)
        pub.close()
        snap = json.loads(server.get("metrics", "rank.3"))
        assert snap["rank"] == 3 and "hvd_runtime_size" in snap["families"]
        import urllib.request
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                    timeout=10) as resp:
            text = resp.read().decode()
        assert TM.lint_exposition(text) == []
        assert 'rank="3"' in text and 'rank="driver"' in text
    finally:
        server.stop()


# ------------------------------------------------------- stall inspector
@pytest.mark.parametrize("mod,err", [(TS, StallError), (JS, JStallError)])
def test_stall_inspector_warns_then_shuts_down(mod, err, caplog):
    """Both inspectors: a name pending past the warning threshold warns
    once (and counts), past the shutdown threshold raises; completion
    clears it and observes its age."""
    reg = TM if mod is TS else JM
    insp = mod.StallInspector(warn_seconds=0, shutdown_seconds=0,
                              poll_interval=3600.0)
    try:
        warned0 = reg.STALL_WARNINGS.value()
        insp.record_submit("grad.w")
        time.sleep(0.01)
        insp.check()
        insp.check()
        assert reg.STALL_WARNINGS.value() == warned0 + 1
        assert insp.pending_count() == 1
        insp.shutdown_seconds = 1e-3
        with pytest.raises(err, match="grad.w stalled"):
            insp.check()
        ages0 = reg.NEGOTIATION_AGE.to_family()["samples"][0]["count"]
        insp.record_complete("grad.w")
        assert insp.pending_count() == 0
        assert reg.NEGOTIATION_AGE.to_family()["samples"][0]["count"] == \
            ages0 + 1
        insp.check()  # nothing pending: quiet
    finally:
        insp.close()


def test_stall_messages_match_jax():
    msgs = []
    for mod in (TS, JS):
        insp = mod.StallInspector(warn_seconds=0, shutdown_seconds=1,
                                  poll_interval=3600.0)
        insp._pending["t"] = time.monotonic() - 5.0
        try:
            insp.check()
        except Exception as e:  # noqa: BLE001 - compared below
            msgs.append((type(e).__name__, str(e)))
        insp.close()
    assert msgs[0] == msgs[1]
    assert msgs[0][1].endswith("HOROVOD_STALL_SHUTDOWN_TIME_SECONDS=1")


# ------------------------------------------------------------- logging
@pytest.mark.parametrize("level,hide", [("debug", "1"), ("trace", "0"),
                                        ("fatal", ""), ("bogus", "yes")])
def test_logging_level_and_hide_time_match_jax(monkeypatch, level, hide):
    monkeypatch.setenv("HOROVOD_LOG_LEVEL", level)
    monkeypatch.setenv("HOROVOD_LOG_HIDE_TIME", hide)
    monkeypatch.setenv("HOROVOD_RANK", "5")
    got = []
    for mod, name in ((TLOG, "horovod_tpu_torch"), (JLOG, "horovod_tpu")):
        monkeypatch.setattr(mod, "_logger", None)
        logger = logging.getLogger(name)
        old = list(logger.handlers)
        logger.handlers.clear()
        try:
            lg = mod.get_logger()
            fmt = lg.handlers[0].formatter._fmt
            rec = logging.LogRecord(name, logging.WARNING, __file__, 1,
                                    "msg %d", (7,), None)
            lg.handlers[0].filter(rec)
            got.append((lg.level, fmt, rec.hvd_rank,
                        logging.Formatter(fmt.replace("%(asctime)s ", ""))
                        .format(rec)))
        finally:
            logger.handlers[:] = old
    assert got[0] == got[1]
    assert got[0][2] == "5"
    assert ("%(asctime)s" in got[0][1]) == (hide not in ("1", "yes"))
    assert got[0][3] == "[5]<WARNING> msg 7"


# ------------------------------------------------- serving engine families
_SERVE_FAMILIES = ("hvd_serve_requests_total", "hvd_serve_tokens_total",
                   "hvd_serve_prefix_hits_total",
                   "hvd_serve_prefix_blocks_shared_total",
                   "hvd_serve_prefill_chunks_total",
                   "hvd_serve_spec_drafted_tokens_total",
                   "hvd_serve_spec_accepted_tokens_total")


def _serve_counts(mod):
    snap = mod.REGISTRY.snapshot()["families"]
    out = {}
    for name in _SERVE_FAMILIES:
        for s in snap[name]["samples"]:
            out[(name, tuple(sorted(s["labels"].items())))] = s["value"]
    for name in ("hvd_serve_ttft_seconds", "hvd_serve_tpot_seconds"):
        out[(name, "count")] = sum(s["count"]
                                   for s in snap[name]["samples"])
    return out


def _delta(after, before):
    return {k: v - before.get(k, 0.0) for k, v in after.items()
            if v - before.get(k, 0.0)}


def test_serve_families_equal_the_jax_engine_on_the_same_plan():
    """Four requests (two sharing a prefix) through the port's engine on
    the CPU and the JAX engine on the same weights: the requests, tokens
    by phase, prefix hits, chunks and drafts they count are equal (times
    differ and are not compared)."""
    import jax
    from horovod_tpu.models import llama as JL
    from horovod_tpu.serve import engine as JE
    from horovod_tpu.serve.config import ServeConfig as JServeConfig
    from horovod_tpu_torch.models import llama as TLL
    from horovod_tpu_torch.serve.config import ServeConfig
    from horovod_tpu_torch.serve.engine import ServeEngine
    cfg = JL.CONFIGS["tiny"]
    params = JL.init(jax.random.PRNGKey(0), cfg)
    model = TLL.params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                                TLL.CONFIGS["tiny"], device="cpu")
    scfg = ServeConfig(max_slots=1, block_size=4, cache_blocks=32,
                       max_seq_len=40, max_batch_tokens=16, prefill_chunk=8)
    rng = np.random.RandomState(3)
    system = rng.randint(0, cfg.vocab, 9).tolist()
    prompts = [system + [11, 12, 11, 12], system + [11, 12, 11, 99],
               rng.randint(0, cfg.vocab, 6).tolist(),
               rng.randint(0, cfg.vocab, 11).tolist()]
    before = _serve_counts(TM)
    port = ServeEngine(model, scfg, device="cpu")
    for i, p in enumerate(prompts):
        port.submit(p, 6, req_id=f"r{i}")
    port.flush()
    got = _delta(_serve_counts(TM), before)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("hvd",))
    jeng = JE.ServeEngine(JL, cfg, params,
                          JServeConfig(**dataclasses.asdict(scfg)),
                          mesh=mesh)
    before = _serve_counts(JM)
    for i, p in enumerate(prompts):
        jeng.submit(p, 6, req_id=f"r{i}")
    jeng.flush()
    want = _delta(_serve_counts(JM), before)
    assert port.sched_digest == jeng.sched_digest
    assert got == want
    assert got[("hvd_serve_requests_total",
                (("outcome", "completed"),))] == 4
    assert got[("hvd_serve_ttft_seconds", "count")] == 4
    assert got[("hvd_serve_prefix_hits_total", ())] >= 1
    st = port.stats()
    assert got[("hvd_serve_tokens_total", (("phase", "decode"),))] == \
        st["tokens_decode"]
    assert got[("hvd_serve_tokens_total", (("phase", "prefill"),))] == \
        st["tokens_prefill"]
    # the first token of each request comes off its last prefill chunk:
    # decode counts the rest
    assert st["tokens_decode"] == 4 * 6 - 4


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_kv_shard_unavailable_counts_per_attempt():
    """A transient failure against a shard of a sharded KV counts into
    hvd_kv_shard_unavailable_total{shard} per attempt, as in the JAX
    client."""
    from horovod_tpu_torch.runner import http_client as TC
    dead = ("127.0.0.1", _free_port())
    addrs = [("127.0.0.1", _free_port()), dead]
    from horovod_tpu_torch.runner.kvshard import shard_for_scope
    scope = next(s for s in ("a", "b", "c", "d", "e", "f", "g")
                 if shard_for_scope(s, 2) == 1)
    TC.install_shard_map(addrs)
    try:
        before = TM.KV_SHARD_UNAVAILABLE.value(shard="1")
        with pytest.raises(Exception):
            TC.put_kv(addrs[0][0], addrs[0][1], scope, "k", b"v",
                      retries=2)
        assert TM.KV_SHARD_UNAVAILABLE.value(shard="1") == before + 3
    finally:
        TC.install_shard_map(None)
