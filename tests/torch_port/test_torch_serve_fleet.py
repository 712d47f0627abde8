"""The port's serving fleet (``horovod_tpu_torch.serve`` ``replica``,
``trace``, ``journal``, ``router``, ``stream``, ``worker`` and the serve
routes of ``runner/http_server.py``): the host-only modules against their
JAX twins on the same inputs, then the cases of ``tests/test_serve_ft.py``,
``test_serve_replica.py`` and ``test_serve_trace.py`` that need no absent
plane, in-process over the port's ``RendezvousServer`` with a scripted
deterministic engine (and the port's ``tiny`` engine), and one cross-check
of the wire format: the JAX ``FleetFrontend`` on a JAX engine driving the
port's router gives the JAX router's records."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import dataclasses  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import random  # noqa: E402
import threading  # noqa: E402
import time  # noqa: E402
import types  # noqa: E402
import urllib.error  # noqa: E402
import urllib.request  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from horovod_tpu.common import knobs as JK  # noqa: E402
from horovod_tpu.common import util as JU  # noqa: E402
from horovod_tpu.serve import config as JC  # noqa: E402
from horovod_tpu.serve import engine as JE  # noqa: E402
from horovod_tpu.serve import journal as JJ  # noqa: E402
from horovod_tpu.serve import replica as JR  # noqa: E402
from horovod_tpu.serve import router as JRT  # noqa: E402
from horovod_tpu.serve import trace as JT  # noqa: E402
from horovod_tpu_torch.common import knobs as TK  # noqa: E402
from horovod_tpu_torch.common import util as TU  # noqa: E402
from horovod_tpu_torch.runner import http_server as THS  # noqa: E402
from horovod_tpu_torch.runner.http_server import (  # noqa: E402
    RendezvousServer, add_stream_waiter, drop_stream_waiter, wake_stream)
from horovod_tpu_torch.serve import config as TC  # noqa: E402
from horovod_tpu_torch.serve import engine as TE  # noqa: E402
from horovod_tpu_torch.serve import journal as TJ  # noqa: E402
from horovod_tpu_torch.serve import replica as TR  # noqa: E402
from horovod_tpu_torch.serve import router as TRT  # noqa: E402
from horovod_tpu_torch.serve import trace as TT  # noqa: E402
from horovod_tpu_torch.serve import worker as TW  # noqa: E402
from horovod_tpu_torch.serve.router import (  # noqa: E402
    DRAIN_KEY, DRAINED_KEY, OUT_SCOPE, PLAN_SCOPE, REQ_SCOPE, STATS_SCOPE,
    RouterState, req_key)
from horovod_tpu_torch.serve.worker import FleetFrontend, plan_key  # noqa
from torch_port_ports import hold_ports  # noqa: E402


# ----------------------------------------------------------- replica.py
def _bs4_caches(E):
    """The same radix tree built through ``E``'s PrefixCache: three
    prompts sharing a block, one partial tail."""
    alloc = E.BlockAllocator(32)
    cache = E.PrefixCache(4, alloc)
    for prompt in ([1, 2, 3, 4, 5, 6, 7, 8, 9],
                   [1, 2, 3, 4, 9, 9, 9, 9],
                   [5, 5, 5, 5, 6, 6, 6, 6, 7, 7, 7, 7]):
        blocks = alloc.alloc(-(-len(prompt) // 4))
        cache.insert(prompt, blocks)
    return cache


def test_replica_fingerprints_and_digests_equal_jax():
    for rid in (0, 1, 7, 12):
        assert TR.scoped("serve_out", rid) == JR.scoped("serve_out", rid)
        assert TR.replica_key(rid) == JR.replica_key(rid)
    rng = np.random.RandomState(0)
    for n in (3, 8, 17, 40, 200):
        toks = rng.randint(0, 1000, n).tolist()
        for bs in (4, 16):
            assert TR.prompt_fingerprints(toks, bs) == \
                JR.prompt_fingerprints(toks, bs)
    fps = TR.prefix_fingerprints(_bs4_caches(TE))
    assert fps == JR.prefix_fingerprints(_bs4_caches(JE)) and len(fps) == 6
    assert TR.fold_digest(fps) == JR.fold_digest(fps)
    # the engine's advertisement is the tree's
    assert TR.prompt_fingerprints([1, 2, 3, 4], 4)[0] in fps


def _routers(n, now=0.0, **kw):
    out = []
    for R in (TR, JR):
        rr = R.ReplicaRouter(block_size=4, **kw)
        for rid in range(n):
            rr.register(rid, {"replicas": n}, now=now)
        out.append(rr)
    return out


def test_replica_routing_with_exclusion_and_dark_equal_jax():
    """The same registrations, advertisements, load overlays and clock
    readings give the same placements, verdicts and counters: longest
    prefix first, least-loaded on a miss, the excluded and the dark
    replicas never."""
    tr, jr = _routers(3)
    prompt = list(range(1, 13))
    fps = TR.prompt_fingerprints(prompt, 4)
    for rr in (tr, jr):
        rr.update(0, {"prefix_fps": fps[:1], "queue_depth": 0}, now=1.0)
        rr.update(1, {"prefix_fps": fps[:2], "queue_depth": 5}, now=1.0)
        rr.update(2, {"prefix_fps": [], "queue_depth": 1}, now=1.0)
        rr.note_load(0, 3)
    calls = [(prompt, 1.5, None), (prompt, 1.5, [1]), ([99] * 8, 1.5, None),
             (prompt, 1.5, [0, 1]), (prompt, 10.0, None)]
    for toks, now, exclude in calls:
        got = tr.route(toks, now, exclude=exclude)
        want = jr.route(toks, now, exclude=exclude)
        assert got == want, (toks, now, exclude)
        assert tr.last_verdict == jr.last_verdict
    for rr in (tr, jr):
        assert rr.route(prompt, 1.5) == (1, 2)
        assert rr.route(prompt, 10.0) is None  # every heartbeat stale
        assert rr.is_dark(0, 10.0) and not rr.is_dark(0, 1.5)
        rr.note_redispatch()
    assert tr.counters(1.5) == jr.counters(1.5)


# -------------------------------------------------------------- trace.py
def test_trace_ids_and_contexts_equal_jax():
    for rid in ("req.000000", "req.000123", "shed.0.4", "", "é"):
        for hop in ("admit", "ROUTE", "1.redrive", "DECODE"):
            assert TT.span_id(rid, hop) == JT.span_id(rid, hop)
        ctx = TT.mint(rid)
        assert ctx == JT.mint(rid)
        assert TT.child(ctx, "redrive") == JT.child(ctx, "redrive")
        assert TT.span_args(ctx, "STREAM", replica=1) == \
            JT.span_args(ctx, "STREAM", replica=1)
    assert TT.span_args(None, "X", rid="r") == JT.span_args(None, "X",
                                                            rid="r")
    src = open(TT.__file__).read()
    assert "import time" not in src and "import random" not in src


def test_trace_attribution_sums_exactly_to_wall():
    """tests/test_serve_trace.py's cases: the components sum exactly to
    the wall, an overshoot is rescaled with its ratio kept, degenerate
    walls and missing components are tolerated."""
    comps, ratio = TT.attribute(1.0, {"queue": 0.2, "prefill": 0.3,
                                      "decode": 0.4})
    assert math.fsum(comps.values()) == 1.0 and ratio == 1.0
    assert comps["stream"] == pytest.approx(0.1)
    assert list(comps) == list(TT.COMPONENTS)
    comps, ratio = TT.attribute(1.0, {"queue": 0.8, "prefill": 0.8})
    assert ratio == pytest.approx(1.6)
    assert math.fsum(comps.values()) == 1.0
    assert comps["stream"] == 0.0 and comps["queue"] == pytest.approx(0.5)
    comps0, ratio0 = TT.attribute(0.0, {"queue": 0.5})
    assert math.fsum(comps0.values()) == 0.0 and ratio0 >= 1.0
    compsn, _ = TT.attribute(2.0, {"queue": None})
    assert math.fsum(compsn.values()) == 2.0


@pytest.mark.parametrize("seed", range(4))
def test_trace_attribution_equals_jax(seed):
    """On random walls and hop durations the port's attribution is the
    JAX function's, float for float.  (Both sum to the wall within one
    rounding: a residual computed as a difference does not make the sum
    exact for every input.)"""
    rng = random.Random(seed)
    for _ in range(50):
        wall = rng.uniform(0, 2.0)
        measured = {c: rng.uniform(0, 1.0) for c in TT.COMPONENTS
                    if rng.random() < 0.8}
        comps, ratio = TT.attribute(wall, measured)
        assert (comps, ratio) == JT.attribute(wall, measured)
        assert math.isclose(math.fsum(comps.values()), wall, rel_tol=1e-15,
                            abs_tol=1e-300)
        assert list(comps) == list(TT.COMPONENTS)


def test_trace_rollup_and_prune_equal_jax():
    rng = random.Random(3)
    records = []
    for i in range(30):
        wall = rng.uniform(0.1, 3.0)
        comps, _ = TT.attribute(wall, {"queue": rng.uniform(0, 0.5),
                                       "decode": rng.uniform(0, 2)})
        records.append({"rid": req_key(i), "status": "done", "wall_s": wall,
                        "components": comps if i % 7 else None,
                        "attempts": [{"replica": i % 3}]})
    assert TT.rollup(records) == JT.rollup(records)
    assert TT.rollup(records, slowest=3)["slowest"] == \
        JT.rollup(records, slowest=3)["slowest"]
    assert TT.percentile([], 50) == JT.percentile([], 50) == 0.0
    keys = [f"r00.{req_key(i)}" for i in range(300)]
    random.Random(1).shuffle(keys)
    for retain in (0, 10, 256, 400):
        assert TT.prune_keys(keys, retain) == JT.prune_keys(keys, retain)
    assert len(TT.prune_keys(keys)) == 300 - TT.TRACE_RETAIN


# ------------------------------------------------------------ journal.py
def _journal_store():
    kv = {}
    reqs = [{"id": req_key(i), "tokens": [i + 1, i + 2], "max_new_tokens": 4,
             "trace": TT.mint(req_key(i))} for i in range(4)]
    for i, r in enumerate(reqs):
        kv[(TJ.JOURNAL_SCOPE, req_key(i))] = json.dumps(r).encode()
    kv[(TJ.JOURNAL_SCOPE, req_key(4))] = b"{torn"
    kv[(OUT_SCOPE, f"{req_key(0)}.done")] = b'{"done": true}'
    kv[(OUT_SCOPE, f"{req_key(1)}.part.000000")] = b'{"tokens": [10, 11]}'
    kv[(OUT_SCOPE, f"{req_key(1)}.part.000001")] = b'{"tokens": [12]}'
    kv[(OUT_SCOPE, f"{req_key(2)}.part.000000")] = b'{"tokens": [5]}'
    kv[(OUT_SCOPE, f"{req_key(2)}.part.000001")] = b"torn"
    return lambda scope, key: kv.get((scope, key))


def test_journal_and_redrive_plan_equal_jax():
    """Finished entries skipped, unfinished ones carry their streamed
    prefix (a torn part ends it) and resume part and a redrive child
    trace context, the cursor lands past every journaled number (a torn
    entry holds its number): the JAX function's output."""
    get = _journal_store()
    for i in (0, 5, 123456):
        assert TJ.journal_key(i) == JJ.journal_key(i) == req_key(i)
    for rid in (req_key(1), req_key(2), req_key(3)):
        assert TJ.emitted_prefix(get, rid) == JJ.emitted_prefix(get, rid)
    assert TJ.emitted_prefix(get, req_key(1)) == ([10, 11, 12], 2)
    entries, seq = TJ.redrive_plan(get)
    assert (entries, seq) == JJ.redrive_plan(get)
    assert seq == 5
    assert [e["id"] for e in entries] == [req_key(i) for i in (1, 2, 3)]
    assert entries[0]["trace"] == TT.child(TT.mint(req_key(1)), "redrive")


# ------------------------------------------------------------- router.py
def test_router_shedding_hysteresis_and_retry_after_equal_jax():
    """Beyond the high watermark admission sheds and resumes only at the
    low one; Retry-After is the service-time EWMA times the queue depth,
    clamped to [1, 60]: step for step the JAX RouterState's."""
    for kw in (dict(max_pending=8, shed_high=4, shed_low=2),
               dict(max_pending=8), dict(max_pending=2), dict(max_pending=0),
               dict(max_pending=64)):
        t, j = TRT.RouterState(**kw), JRT.RouterState(**kw)
        script = ("c", "c", "c", "c", "c", "f", "c", "f", "f", "c", "o", "c",
                  "c", "f", "o", "c")
        for k, op in enumerate(script):
            if op == "c":
                assert t.try_claim() == j.try_claim(), (kw, k)
                assert t.reject_reason == j.reject_reason
            elif op == "f":
                t.finish_stream()
                j.finish_stream()
            else:
                t.observe_done(0.5 * (k + 1), 4)
                j.observe_done(0.5 * (k + 1), 4)
            assert t.retry_after_s() == j.retry_after_s()
            assert t.counters() == j.counters()
    st = TRT.RouterState(max_pending=64)
    assert st.retry_after_s() == 1
    st.observe_done(0.5, 4)
    for _ in range(5):
        st.try_claim()
    assert st.retry_after_s() == 10
    st.observe_done(None, 3)
    assert st.retry_after_s() == 10
    st.observe_done(10.0, 100)
    assert st.retry_after_s() == 60


def test_adaptive_poll_equals_jax():
    t, j = TRT.AdaptivePoll(0.02), JRT.AdaptivePoll(0.02)
    now = 0.0
    for k in range(40):
        if k % 6 == 0:
            now += 0.03 * (k % 5 + 1)
            t.observe_data(now)
            j.observe_data(now)
        assert t.idle() == j.idle()
        assert t.cap() == j.cap()


@pytest.mark.parametrize("body", [
    b"", b"{", b"[]", b'{"tokens": []}', b'{"tokens": [1, -2]}',
    b'{"tokens": [1, 2.5]}', b'{"tokens": "abc"}',
    b'{"tokens": [1], "max_new_tokens": 0}',
    b'{"tokens": [1], "max_new_tokens": "4"}',
    b'{"tokens": [1], "eos_id": "x"}',
    b'{"tokens": [3, 4], "max_new_tokens": 2, "eos_id": 7}',
    b'{"tokens": [3]}'])
def test_parse_generate_body_equals_jax(body):
    def run(parse):
        try:
            return "ok", parse(body)
        except ValueError as e:
            return "error", str(e)
    try:
        json.loads(body or b"{}")
        parsed = True
    except ValueError:
        parsed = False
    if parsed and not isinstance(json.loads(body or b"{}"), dict):
        with pytest.raises(AttributeError):
            TRT.parse_generate_body(body)
        with pytest.raises(AttributeError):
            JRT.parse_generate_body(body)
        return
    assert run(TRT.parse_generate_body) == run(JRT.parse_generate_body)


def test_serve_knobs_and_validation_equal_jax():
    for name in ("HOROVOD_SERVE_JOURNAL", "HOROVOD_SERVE_DRAIN_TIMEOUT",
                 "HOROVOD_SERVE_SHED_HIGH", "HOROVOD_SERVE_SHED_LOW",
                 "HOROVOD_SERVE_DIRECT", "HOROVOD_SERVE_POLL_INTERVAL",
                 "HOROVOD_SERVE_REPLICA_DEAD_S", "HOROVOD_SERVE_AFFINITY",
                 "HOROVOD_ELASTIC_ROUND"):
        assert TK.KNOBS[name].default == JK.KNOBS[name].default, name
        for raw in ("1", "0", "2.5", "7"):
            try:
                want = JK.KNOBS[name].parse(raw)
            except ValueError:
                continue
            assert TK.KNOBS[name].parse(raw) == want
    good = {"HOROVOD_SERVE_PORT": 0,
            "HOROVOD_SERVE_MAX_BATCH_TOKENS": 2048,
            "HOROVOD_SERVE_MAX_SEQ_LEN": 2048,
            "HOROVOD_SERVE_CACHE_BLOCKS": 4096}
    TC.validate_serve_knobs(good)
    for bad, match in (({"HOROVOD_SERVE_DRAIN_TIMEOUT": 0}, "DRAIN_TIMEOUT"),
                       ({"HOROVOD_SERVE_SHED_HIGH": 2,
                         "HOROVOD_SERVE_SHED_LOW": 5}, "SHED"),
                       ({"HOROVOD_SERVE_SHED_HIGH": -1}, "SHED"),
                       ({"HOROVOD_SERVE_POLL_INTERVAL": 0}, "POLL"),
                       ({"HOROVOD_SERVE_REPLICA_DEAD_S": -1}, "DEAD_S")):
        with pytest.raises(ValueError, match=match) as got:
            TC.validate_serve_knobs(dict(good, **bad))
        with pytest.raises(ValueError) as want:
            JC.validate_serve_knobs(dict(good, **bad))
        assert str(got.value) == str(want.value)


def test_backoff_delays_equal_jax():
    for args in ((0, 50.0), (4, 50.0), (8, 50.0, 300.0), (3, 1.0)):
        got = TU.backoff_delays(*args, rng=random.Random(5))
        assert got == JU.backoff_delays(*args, rng=random.Random(5))


def test_runtime_rejects_bad_serve_knobs_at_init(monkeypatch):
    import horovod_tpu_torch as hvd
    monkeypatch.setenv("HOROVOD_SERVE_DRAIN_TIMEOUT", "0")
    with pytest.raises(ValueError, match="DRAIN_TIMEOUT"):
        hvd.init(device="cpu")
    assert not hvd.is_initialized()


# ------------------------------------------- the HTTP front door (in-process)
class _DoneReq:
    def __init__(self, rid):
        self.req_id = rid
        self.finish_reason = "completed"

    def ttft(self):
        return 0.01

    def tpot(self):
        return 0.002


def scripted_tokens(prompt, n):
    """The deterministic 'generation' of the scripted engine: the
    greedy-decode stand-in both incarnations reproduce."""
    base = sum(int(t) for t in prompt)
    return [(base + i) % 1000 for i in range(n)]


class ScriptedEngine:
    """An engine stub with the FleetFrontend contract (submit, step,
    has_work, stats, tick): one token per active request per step."""

    def __init__(self):
        self.tick = 0
        self.active = {}
        self.completed = 0

    def submit(self, tokens, max_new_tokens, req_id=None, eos_id=None):
        self.active[req_id] = scripted_tokens(tokens, max_new_tokens)

    def has_work(self):
        return bool(self.active)

    def step(self):
        emitted, finished = {}, []
        for rid in sorted(self.active):
            emitted[rid] = [self.active[rid].pop(0)]
            if not self.active[rid]:
                del self.active[rid]
                finished.append(_DoneReq(rid))
                self.completed += 1
        if emitted:
            self.tick += 1
        return {"tick": self.tick, "processed": len(emitted),
                "emitted": emitted, "finished": finished}

    def stats(self):
        return {"tick": self.tick, "completed": self.completed,
                "active": len(self.active)}


@pytest.fixture()
def rendezvous():
    server = RendezvousServer(host="127.0.0.1")
    port = server.start()
    yield server, server._httpd, port
    server.stop()


def _post(port, path, body, timeout=10):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    return urllib.request.urlopen(req, timeout=timeout)


def _get_json(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=10) as r:
        return json.loads(r.read())


def _tick(fe, carry=None):
    """The body of FleetFrontend.run for a rank-0 solo-KV frontend, one
    tick at a time, so that a test can stop it mid-stream."""
    for r in (carry or []) + fe._drain_requests():
        if r is None:
            continue
        fe._apply_resume(r)
        fe.engine.submit(r["tokens"], r["max_new_tokens"],
                         req_id=r.get("id"), eos_id=r.get("eos_id"))
    fe._publish_report(fe.engine.step())
    fe._publish_stats(force=True)


def _clients(port, prompts, n_new, results, headers=None, timeout=30):
    def client(i):
        with _post(port, "generate", {"tokens": prompts[i],
                                      "max_new_tokens": n_new},
                   timeout=timeout) as r:
            if headers is not None:
                headers[i] = dict(r.headers)
            results[i] = [json.loads(ln) for ln in r.read().splitlines()]
    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    return threads


def _wait(cond, timeout=10.0):
    deadline = time.time() + timeout
    while time.time() < deadline and not cond():
        time.sleep(0.01)
    assert cond()


@pytest.mark.parametrize("route", [("GET", "/serve/stats"),
                                   ("GET", "/serve/trace"),
                                   ("POST", "/generate"),
                                   ("POST", "/serve/stream"),
                                   ("POST", "/admin/drain")])
def test_serve_routes_answer(rendezvous, route, monkeypatch):
    """The five serve routes the port's server used to 404 answer as the
    JAX server's do; none is a plane route any more."""
    monkeypatch.setenv("HOROVOD_SERVE_DRAIN_TIMEOUT", "0.2")
    server, _, port = rendezvous
    method, path = route
    assert (method, *path.strip("/").split("/", 1)) not in THS.PLANE_ROUTES
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", method=method,
        data=(b'{"tokens": []}' if path == "/generate" else
              b"" if method == "POST" else None))
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            code, body = r.status, r.read()
    except urllib.error.HTTPError as e:
        code, body = e.code, e.read()
    assert code == {"/serve/stats": 200, "/serve/trace": 200,
                    "/generate": 400, "/serve/stream": 200,
                    "/admin/drain": 504}[path]
    assert json.loads(body)


def test_generate_streams_the_engines_results(rendezvous):
    """``/generate`` through the port's router and the port's ``tiny``
    engine behind a FleetFrontend: concurrent streams carry full-forward
    greedy tokens, headers name the request, ``/serve/stats`` merges the
    router's and the engine's views."""
    from horovod_tpu_torch.models import llama
    server, httpd, port = rendezvous
    httpd.serve_router = RouterState(journal=True)
    model = llama.init(llama.CONFIGS["tiny"], torch.Generator().manual_seed(0),
                       device="cpu")
    scfg = TC.ServeConfig(max_slots=2, block_size=4, cache_blocks=32,
                          max_seq_len=32, max_batch_tokens=16,
                          prefill_chunk=8)
    fe = FleetFrontend(TE.ServeEngine(model, scfg, device="cpu"),
                       "127.0.0.1", port, 0, 1, direct=True)
    fe.resume_from_kv()
    prompts = [[3, 5, 8, 13], [2, 4, 6], [9] * 9]
    results, headers = [None] * 3, [None] * 3
    threads = _clients(port, prompts, 6, results, headers)
    deadline = time.time() + 30
    while time.time() < deadline and any(r is None for r in results):
        _tick(fe)
        time.sleep(0.005)
    for t in threads:
        t.join(timeout=10)
    for i, p in enumerate(prompts):
        ids = list(p)
        with torch.no_grad():
            for _ in range(6):
                ids.append(int(model(torch.tensor([ids]))[0, -1].argmax()))
        streamed = [t for ln in results[i][:-1] for t in ln["tokens"]]
        assert streamed == ids[len(p):] == results[i][-1]["tokens"]
        assert results[i][-1]["finish_reason"] == "completed"
        assert headers[i]["X-Serve-Request-Id"].startswith("req.")
        assert headers[i]["Content-Type"] == "application/x-ndjson"
    assert fe._dstream is not None and fe._dstream.sent > 0
    stats = _get_json(port, "/serve/stats")
    assert stats["router"]["submitted"] == 3
    assert stats["router"]["completed"] == 3
    assert stats["journal"] == {"enabled": True, "entries": 3}
    assert stats["engine"]["completed"] == 3
    assert "prefix_fps" in stats["engine"]


def test_429_carries_retry_after_header(rendezvous):
    server, httpd, port = rendezvous
    httpd.serve_router = RouterState(max_pending=0)
    httpd.serve_router.observe_done(0.5, 4)
    with pytest.raises(urllib.error.HTTPError) as exc:
        _post(port, "generate", {"tokens": [1]})
    assert exc.value.code == 429
    assert int(exc.value.headers["Retry-After"]) >= 1
    body = json.loads(exc.value.read())
    assert "queue full" in body["error"] and body["shed"] == 1


def test_generate_journals_accepted_requests(rendezvous):
    """Every accepted /generate lands in the journal scope with the
    request payload, in the same critical section as the enqueue."""
    server, httpd, port = rendezvous
    httpd.serve_router = RouterState(journal=True)
    results = [None]
    threads = _clients(port, [[1, 2, 3]], 2, results)
    _wait(lambda: server.get(REQ_SCOPE, req_key(0)) is not None)
    raw = server.get(REQ_SCOPE, req_key(0))
    journaled = server.get(TJ.JOURNAL_SCOPE, req_key(0))
    assert journaled == raw, "journal diverged from the enqueue"
    entry = json.loads(journaled)
    assert entry["tokens"] == [1, 2, 3] and entry["id"] == req_key(0)
    assert entry["trace"] == TT.mint(req_key(0))
    server.put(OUT_SCOPE, f"{req_key(0)}.done",
               json.dumps({"done": True, "tokens": [7, 8],
                           "finish_reason": "completed", "ttft_s": 0.01,
                           "tpot_s": 0.002}).encode())
    threads[0].join(timeout=10)
    assert results[0][-1]["done"] is True
    # the consumed stream is collected to a tombstone
    tomb = json.loads(server.get(OUT_SCOPE, f"{req_key(0)}.done"))
    assert tomb == {"done": True, "consumed": True,
                    "finish_reason": "completed", "n_tokens": 2}


def test_redrive_resumes_client_streams_byte_identical(rendezvous):
    """Two streams lose their fleet after 3 of 6 tokens; a second
    incarnation (fresh engine, epoch + 1) redrives them from the journal,
    suppresses the streamed prefix, and each client's stream completes
    with exactly the unfaulted token sequence."""
    server, httpd, port = rendezvous
    httpd.serve_router = RouterState(journal=True)
    prompts = [[3, 5, 8], [2, 4]]
    results = [None, None]
    threads = _clients(port, prompts, 6, results)
    _wait(lambda: server.get(REQ_SCOPE, req_key(1)) is not None)
    fe1 = FleetFrontend(ScriptedEngine(), "127.0.0.1", port, 0, 1, epoch=0)
    carry = fe1.resume_from_kv()
    assert len(carry) == 2 and fe1._next_seq == 2
    _tick(fe1, carry)
    _tick(fe1)
    _tick(fe1)
    del fe1
    fe2 = FleetFrontend(ScriptedEngine(), "127.0.0.1", port, 0, 1, epoch=1)
    carry = fe2.resume_from_kv()
    assert [len(e["resume_emitted"]) for e in carry] == [3, 3]
    assert fe2._next_seq == 2
    _tick(fe2, carry)
    for _ in range(5):
        _tick(fe2)
    for t in threads:
        t.join(timeout=20)
    for i, lines in enumerate(results):
        assert lines is not None and lines[-1]["done"] is True, lines
        oracle = scripted_tokens(prompts[i], 6)
        assert [t for ln in lines[:-1] for t in ln["tokens"]] == oracle
        assert lines[-1]["tokens"] == oracle
        assert len(lines) - 1 == 6  # 3 before the crash, 3 resumed


def test_redrive_disabled_fast_forwards_cursor(rendezvous):
    server, _, port = rendezvous
    for i in range(3):
        server.put(REQ_SCOPE, req_key(i), json.dumps(
            {"id": req_key(i), "tokens": [1], "max_new_tokens": 1}).encode())
    fe = FleetFrontend(ScriptedEngine(), "127.0.0.1", port, 0, 1,
                       journal=False)
    assert fe.resume_from_kv() == []
    assert fe._next_seq == 3


def test_plan_epoch_fencing_rejects_stale_plans(rendezvous):
    """A restarted fleet never replays a previous incarnation's plan
    stream: stale keys are invisible and an epoch-mismatched payload is
    refused; a follower whose scheduling digest differs from rank 0's
    refuses the plan too."""
    server, _, port = rendezvous
    assert plan_key(0, epoch=0) != plan_key(0, epoch=1)
    assert plan_key(12, 3) == "e0003.tick.000000012"
    server.put(PLAN_SCOPE, plan_key(0, epoch=0),
               json.dumps({"tick": 0, "epoch": 0, "stop": False,
                           "reqs": [{"id": "req.000000"}]}).encode())
    follower = FleetFrontend(ScriptedEngine(), "127.0.0.1", port, 1, 2,
                             plan_timeout_s=0.4, epoch=1)
    with pytest.raises(TimeoutError):
        follower._fetch_plan()
    server.put(PLAN_SCOPE, plan_key(0, epoch=1),
               json.dumps({"tick": 0, "epoch": 0, "stop": False,
                           "reqs": []}).encode())
    with pytest.raises(ValueError, match="stale plan epoch"):
        follower._fetch_plan()
    server.put(PLAN_SCOPE, plan_key(0, epoch=1),
               json.dumps({"tick": 0, "epoch": 1, "stop": True,
                           "reqs": []}).encode())
    plan = follower._fetch_plan()
    assert plan["stop"] is True and plan["epoch"] == 1
    follower.engine.sched_digest = "aaaa"
    server.put(PLAN_SCOPE, plan_key(0, epoch=1),
               json.dumps({"tick": 0, "epoch": 1, "stop": False,
                           "reqs": [], "sched": "bbbb"}).encode())
    with pytest.raises(ValueError, match="lockstep divergence"):
        follower._fetch_plan()


def test_drain_endpoint_semantics(rendezvous, monkeypatch):
    """POST /admin/drain: admission stops (503), the drain signal lands
    in the KV, the fleet's drained ack completes the response."""
    monkeypatch.setenv("HOROVOD_SERVE_DRAIN_TIMEOUT", "10")
    server, _, port = rendezvous

    def fleet():
        deadline = time.time() + 10
        while time.time() < deadline:
            if server.get(STATS_SCOPE, DRAIN_KEY) is not None:
                server.put(STATS_SCOPE, DRAINED_KEY, json.dumps(
                    {"tick": 42, "completed": 7}).encode())
                return
            time.sleep(0.01)

    t = threading.Thread(target=fleet)
    t.start()
    try:
        with _post(port, "admin/drain", {}) as r:
            out = json.loads(r.read())
    finally:
        t.join(timeout=10)
    assert out["drained"] is True
    assert out["engine_final"]["completed"] == 7
    assert out["router"]["draining"] is True
    with pytest.raises(urllib.error.HTTPError) as exc:
        _post(port, "generate", {"tokens": [1]})
    assert exc.value.code == 503
    assert "draining" in json.loads(exc.value.read())["error"]
    with _post(port, "admin/drain", {}) as r:
        assert json.loads(r.read())["drained"] is True


def test_frontend_drains_in_flight_then_acks(rendezvous):
    """Rank 0 sees the drain signal, finishes every accepted request,
    publishes the drained ack, and run() exits 0."""
    server, _, port = rendezvous
    rec = json.dumps({"id": req_key(0), "tokens": [2, 3],
                      "max_new_tokens": 3}).encode()
    server.put(REQ_SCOPE, req_key(0), rec)
    server.put(TJ.JOURNAL_SCOPE, req_key(0), rec)
    server.put(STATS_SCOPE, DRAIN_KEY, json.dumps(
        {"t": time.time()}).encode())
    fe = FleetFrontend(ScriptedEngine(), "127.0.0.1", port, 0, 1,
                       drain_timeout_s=10.0)
    assert fe.run(ttl_s=0.0) == 0
    ack = server.get(STATS_SCOPE, DRAINED_KEY)
    assert ack is not None and json.loads(ack)["completed"] == 1
    done = server.get(OUT_SCOPE, f"{req_key(0)}.done")
    assert done is not None, "in-flight request dropped by drain"
    assert json.loads(done)["tokens"] == scripted_tokens([2, 3], 3)


def test_serve_loop_kv_retry_rides_an_outage(rendezvous, monkeypatch):
    """The frontend's KV legs stall through transient failures (bounded
    exp-backoff) and still fail loudly once the budget is exhausted.  (The
    JAX test injects the outage through the chaos plane, ROADMAP queue 1
    item 4.5; here the KV client itself fails.)"""
    from horovod_tpu_torch.runner import http_client
    server, _, port = rendezvous
    monkeypatch.setattr(TW, "_KV_RETRIES", 3)
    monkeypatch.setattr(TW, "_KV_BACKOFF_MS", 5.0)
    real, failures = http_client.get_kv, {"n": 0}

    def flaky(*a, **kw):
        if failures["n"] > 0:
            failures["n"] -= 1
            raise urllib.error.URLError(ConnectionRefusedError(111, "down"))
        return real(*a, **kw)

    monkeypatch.setattr(http_client, "get_kv", flaky)
    fe = FleetFrontend(ScriptedEngine(), "127.0.0.1", port, 0, 1)
    failures["n"] = 2
    assert fe._drain_requests() == []
    failures["n"] = 100
    with pytest.raises(urllib.error.URLError):
        fe._drain_requests()


def test_keyed_stream_waiters_wake_only_their_stream():
    server = types.SimpleNamespace(
        kv_waiters={}, kv_waiters_lock=threading.Lock(),
        kv_wakeup=threading.Condition())
    cond = add_stream_waiter(server, "serve_out", "req.000001")
    assert cond is not None
    assert add_stream_waiter(server, "serve_out", "req.000001") is cond
    drop_stream_waiter(server, "serve_out", "req.000001")
    assert ("serve_out", "req.000001") in server.kv_waiters
    woken = []

    def waiter():
        with cond:
            woken.append(cond.wait(5.0))

    t = threading.Thread(target=waiter)
    t.start()
    time.sleep(0.05)
    wake_stream(server, "serve_out", "req.000002.part.000000")
    wake_stream(server, "metrics", "req.000001.part.000000")
    wake_stream(server, "serve_out", "req.000001.done")
    t.join(timeout=5.0)
    assert woken == [True]
    drop_stream_waiter(server, "serve_out", "req.000001")
    assert server.kv_waiters == {}
    bare = types.SimpleNamespace(kv_wakeup=threading.Condition())
    assert add_stream_waiter(bare, "serve_out", "req.000001") is None
    wake_stream(bare, "serve_out.r01", "req.000001.part.000000")


def test_kv_put_wakes_a_stream_waiter(rendezvous):
    """A ``serve_out`` PUT through the server wakes the waiter of its
    request (the KV fallback path of the direct stream)."""
    server, httpd, port = rendezvous
    cond = add_stream_waiter(httpd, "serve_out", "req.000003")
    woken = []

    def waiter():
        with cond:
            woken.append(cond.wait(5.0))

    t = threading.Thread(target=waiter)
    t.start()
    time.sleep(0.05)
    from horovod_tpu_torch.runner import http_client
    http_client.put_kv("127.0.0.1", port, "serve_out",
                       "req.000003.part.000000", b'{"tokens": [1]}')
    t.join(timeout=5.0)
    assert woken == [True]
    drop_stream_waiter(httpd, "serve_out", "req.000003")


def test_kill_one_replica_streams_byte_identical(rendezvous):
    """Two streams land on a two-replica tier (note_load spreads them),
    replica 0 dies after 3 of 6 tokens, the router re-dispatches its
    stream to replica 1 with the delivered prefix suppressed, and both
    clients' streams complete byte-identical to the unfaulted ones; the
    trace record shows both attempts."""
    server, httpd, port = rendezvous
    httpd.serve_routers = {0: RouterState(journal=True),
                           1: RouterState(journal=True)}
    httpd.serve_router = httpd.serve_routers[0]
    rr = TR.ReplicaRouter(block_size=4, dead_after_s=0.4)
    httpd.serve_replicas = rr
    fes = [FleetFrontend(ScriptedEngine(), "127.0.0.1", port, 0, 1,
                         direct=True, replica_id=k) for k in range(2)]
    for fe in fes:
        fe.register_replica({"replicas": 2})
        fe._publish_stats(force=True)
        fe.resume_from_kv()
    prompts = [[3, 5, 8], [2, 4]]
    results, headers = [None, None], [None, None]
    threads = []
    for i in range(2):
        threads += _clients(port, prompts[i:i + 1], 6,
                            _Slot(results, i), _Slot(headers, i))
        _wait(lambda: httpd.serve_routers[i].next_seq == 1)
    for _ in range(3):
        _tick(fes[0])
        _tick(fes[1])
    del fes[0]
    deadline = time.time() + 10
    while time.time() < deadline and rr.redispatches == 0:
        _tick(fes[0])
        time.sleep(0.05)
    assert rr.redispatches == 1, "router never re-dispatched"
    deadline = time.time() + 10
    while time.time() < deadline and any(r is None for r in results):
        _tick(fes[0])
        time.sleep(0.02)
    for t in threads:
        t.join(timeout=10)
    assert sorted(h["X-Serve-Replica"] for h in headers) == ["0", "1"]
    for i, lines in enumerate(results):
        assert lines is not None and lines[-1]["done"] is True, lines
        oracle = scripted_tokens(prompts[i], 6)
        assert [t for ln in lines[:-1] for t in ln["tokens"]] == oracle
        assert lines[-1]["tokens"] == oracle
    assert len(results[0]) - 1 == 6
    assert rr.counters()["redispatches"] == 1
    rec = json.loads(server.get(TT.TRACE_SCOPE,
                                TRT._trace_key(0, "req.000000")))
    atts = rec["attempts"]
    assert rec["status"] == "done"
    assert [a["replica"] for a in atts] == [0, 1]
    assert atts[1]["redispatched_from"] == 0
    assert atts[1]["suppressed_tokens"] == 3 and atts[1]["resume_part"] == 3
    stats = _get_json(port, "/serve/stats")
    assert stats["replicas"]["redispatches"] == 1
    assert set(stats["replicas"]["admission"]) == {"0", "1"}


class _Slot:
    """``lst[i]`` as the one-element list ``_clients`` writes into."""

    def __init__(self, lst, i):
        self.lst, self.i = lst, i

    def __setitem__(self, _, value):
        self.lst[self.i] = value


def test_request_trace_end_to_end(rendezvous):
    """One /generate through the router: the stream completes, the
    serve_trace record's components sum exactly to its wall time, and
    GET /serve/trace rolls it up with the raw record, and the router's
    ROUTE and STREAM spans land on the merged timeline as the JAX
    router's do."""
    server, httpd, port = rendezvous
    httpd.serve_router = RouterState(journal=True)
    fe = FleetFrontend(ScriptedEngine(), "127.0.0.1", port, 0, 1,
                       direct=True)
    fe.resume_from_kv()
    results, headers = [None], [None]
    threads = _clients(port, [[3, 5, 8]], 4, results, headers)
    deadline = time.time() + 10
    while time.time() < deadline and results[0] is None:
        _tick(fe)
        time.sleep(0.01)
    threads[0].join(timeout=10)
    assert results[0][-1]["done"] is True
    assert headers[0]["X-Serve-Request-Id"] == req_key(0)
    rec = json.loads(server.get(TT.TRACE_SCOPE, TRT._trace_key(0,
                                                               req_key(0))))
    assert rec["status"] == "done" and rec["rid"] == req_key(0)
    assert rec["trace"]["span"] == TT.span_id(req_key(0), "admit")
    assert math.fsum(rec["components"].values()) == rec["wall_s"]
    assert rec["overattribution"] >= 1.0
    assert rec["n_tokens"] == 4 and rec["attempts"][0]["replica"] == 0
    spans = [json.loads(v)["events"][0]
             for v in server.scope_items("timeline").values()]
    assert sorted(e["name"] for e in spans) == ["ROUTE", "STREAM"]
    for e in spans:
        assert e["ph"] == "X" and e["dur"] >= 0.0
        assert e["args"]["rid"] == req_key(0)
    view = _get_json(port, "/serve/trace")
    assert view["requests"] == 1 and view["completed"] == 1
    assert view["slowest"][0]["rid"] == req_key(0)
    assert view["components"]["decode"]["count"] == 1
    assert view["records"] == [rec]


def test_shed_429_carries_rid_and_trace_record(rendezvous):
    server, httpd, port = rendezvous
    httpd.serve_router = RouterState(max_pending=1, shed_high=1,
                                     shed_low=1, journal=False)
    httpd.serve_router.try_claim()
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(port, "generate", {"tokens": [1], "max_new_tokens": 1})
    assert e.value.code == 429
    rid = json.loads(e.value.read())["rid"]
    assert rid.startswith("shed.")
    assert e.value.headers.get("X-Serve-Request-Id") == rid
    _wait(lambda: server.get(TT.TRACE_SCOPE,
                             TRT._trace_key(0, rid)) is not None, 5)
    rec = json.loads(server.get(TT.TRACE_SCOPE, TRT._trace_key(0, rid)))
    assert rec["status"] == "shed" and rec["rid"] == rid


def test_trace_retention_is_bounded(rendezvous):
    server, httpd, _ = rendezvous
    for i in range(TT.TRACE_RETAIN + 7):
        TRT._trace_put(httpd, TRT._trace_key(0, req_key(i)),
                       {"rid": req_key(i), "status": "running"})
    items = server.scope_items(TT.TRACE_SCOPE)
    assert len(items) == TT.TRACE_RETAIN
    assert TRT._trace_key(0, req_key(0)) not in items


def test_direct_stream_mirrors_records_and_handoffs(rendezvous):
    """``POST /serve/stream`` records land in ``serve_out`` (and
    ``serve_kv`` for a handoff) under the keys the KV fallback writes;
    malformed records are dropped."""
    from horovod_tpu_torch.serve.stream import DirectTokenStream
    server, _, port = rendezvous
    ds = DirectTokenStream("127.0.0.1", port)
    assert ds.send({"rid": "req.000000", "part": 0, "tokens": [1, 2]})
    assert ds.send({"rid": "req.000000", "done": {"done": True,
                                                  "tokens": [1, 2]}})
    assert ds.send({"rid": "req.000001", "part": 0, "tokens": [5],
                    "scope": "serve_out.r01"})
    assert ds.send({"kind": "kvblock", "scope": "serve_kv",
                    "key": "handoff.000000", "payload": {"req_id": "x"}})
    assert ds.send({"rid": "req.000002", "part": 0, "tokens": [3],
                    "scope": "metrics"})  # dropped: not a stream scope
    ds.close()
    assert json.loads(server.get(OUT_SCOPE, "req.000000.part.000000")) == \
        {"tokens": [1, 2]}
    assert json.loads(server.get(OUT_SCOPE, "req.000000.done"))["done"]
    assert server.get("serve_out.r01", "req.000001.part.000000") is not None
    assert json.loads(server.get("serve_kv", "handoff.000000")) == \
        {"req_id": "x"}
    assert server.get("metrics", "req.000002.part.000000") is None
    dead = DirectTokenStream("127.0.0.1", _free_port(), timeout=1.0)
    assert dead.send({"rid": "x", "part": 0, "tokens": [1]}) is False
    assert dead.fallbacks == 1


def _free_port() -> int:
    """A port below the ephemeral range, free when taken (``hold_ports``)."""
    return hold_ports(1).release()[0]


# ------------------------------------------- the wire format, JAX against port
def _jax_router_run(server_cls, engine_factory, prompts, n_new):
    """The JAX FleetFrontend (its engine built by ``engine_factory``)
    behind a router run by ``server_cls``: each request enqueued in turn,
    then served.  Returns the client records and the KV scopes."""
    from horovod_tpu.serve import worker as JW
    server = server_cls(host="127.0.0.1")
    port = server.start()
    try:
        server._httpd.serve_router = (
            TRT if server_cls is RendezvousServer else JRT
        ).RouterState(journal=True)
        fe = JW.FleetFrontend(engine_factory(), "127.0.0.1", port, 0, 1,
                              direct=True)
        fe.resume_from_kv()
        results = [None] * len(prompts)
        threads = []
        for i in range(len(prompts)):
            threads += _clients(port, prompts[i:i + 1], n_new,
                                _Slot(results, i))
            _wait(lambda: server.get(REQ_SCOPE, req_key(i)) is not None)
        deadline = time.time() + 30
        while time.time() < deadline and any(r is None for r in results):
            _tick(fe)
            time.sleep(0.005)
        for t in threads:
            t.join(timeout=10)
        fe._dstream.close()
        time.sleep(0.1)
        scopes = {s: {k: json.loads(v) for k, v in
                      server.scope_items(s).items()}
                  for s in (OUT_SCOPE, TJ.JOURNAL_SCOPE, REQ_SCOPE,
                            TT.TRACE_SCOPE)}
        return results, scopes
    finally:
        server.stop()


_CLOCK_KEYS = ("ttft_s", "tpot_s", "timing", "submitted_t", "placement_s",
               "wall_s", "components", "overattribution")


def _strip(obj):
    if isinstance(obj, dict):
        return {k: _strip(v) for k, v in obj.items() if k not in _CLOCK_KEYS}
    if isinstance(obj, list):
        return [_strip(v) for v in obj]
    return obj


def test_jax_frontend_on_the_port_router_gives_the_jax_records():
    """The JAX FleetFrontend on a ``tiny`` JAX engine, its direct stream
    and KV legs speaking to the port's router, against the same frontend
    behind the JAX router: the same client records, the same
    ``serve_out`` tombstones, journal and request entries, and the same
    trace records, clock readings aside."""
    import jax
    from horovod_tpu.models import llama as JL
    from horovod_tpu.runner.http_server import RendezvousServer as JServer
    cfg = JL.CONFIGS["tiny"]
    params = JL.init(jax.random.PRNGKey(0), cfg)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("hvd",))
    scfg = JC.ServeConfig(max_slots=2, block_size=4, cache_blocks=32,
                          max_seq_len=32, max_batch_tokens=16,
                          prefill_chunk=8)

    def engine():
        return JE.ServeEngine(JL, cfg, params, scfg, mesh=mesh)

    prompts = [[3, 5, 8, 13, 21], [2, 4], [7] * 9]
    ours = _jax_router_run(RendezvousServer, engine, prompts, 5)
    theirs = _jax_router_run(JServer, engine, prompts, 5)
    assert _strip(ours[0]) == _strip(theirs[0])
    assert all(r[-1]["done"] is True and len(r[-1]["tokens"]) == 5
               for r in ours[0])
    for scope in ours[1]:
        assert _strip(ours[1][scope]) == _strip(theirs[1][scope]), scope
    assert len(ours[1][TT.TRACE_SCOPE]) == len(prompts)
