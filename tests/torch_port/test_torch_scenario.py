"""The port's scenario plane (``horovod_tpu_torch/scenario/``) against the
JAX package's (``horovod_tpu/scenario/``) on the same specs, every
comparison exact (bytes, digests, messages, reports; no tolerance):

  * trace: the golden ``Stream`` values, seed derivation, arrival
    processes and ``rank_for``; the event digests and ``events_jsonl`` of
    the four committed ``scenarios/*.yaml``, and a digest that does not
    move across fresh interpreters with different PYTHONHASHSEED values;
  * spec and storm: the validation errors of ``tests/test_scenario.py``
    letter for letter, ``to_json``, ``to_chaos_spec`` and the replay
    windows;
  * harness: the reports and ``canonical_rows``/``rows_jsonl`` of the
    committed corpus and of ``tests/test_scenario.py``'s storms on the
    virtual engine, and a short spec with a kill replayed on the real
    ``ServeEngine`` (``tiny``, fp32) through both harnesses on the same
    numpy weights;
  * ``validate_scenario_knobs`` and ``hvd.init``'s use of it;
  * hvdlint's ``scenario-determinism`` rule over the port's four files,
    and the port's modules import neither JAX nor ``horovod_tpu``."""

import json
import os
import subprocess
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import horovod_tpu.scenario as JS  # noqa: E402
import horovod_tpu_torch.scenario as TS  # noqa: E402
from horovod_tpu.scenario import trace as JT  # noqa: E402
from horovod_tpu_torch.scenario import trace as TT  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CORPUS = sorted(os.listdir(os.path.join(REPO, "scenarios")))

# tests/test_scenario.py's spec
_SPEC = {
    "name": "unit",
    "seed": 7,
    "virtual_ranks": 32,
    "tick_ms": 10,
    "phases": [
        {"name": "p0", "kind": "serve", "duration_s": 1.0,
         "arrivals": {"process": "poisson", "rate": 20},
         "shapes": {"prompt_mean": 8, "prompt_max": 24,
                    "output_mean": 5, "prefix_groups": 3}},
    ],
}
_ENGINE_DOWN = {"name": "scenario-engine-down",
                "family": "hvd_scenario_engine_up",
                "kind": "threshold", "op": "<=", "value": 0,
                "severity": "critical"}


def _doc(**over):
    doc = json.loads(json.dumps(_SPEC))
    doc.update(over)
    return doc


def _both(doc):
    return JS.parse_scenario(json.loads(json.dumps(doc))), \
        TS.parse_scenario(json.loads(json.dumps(doc)))


# ------------------------------------------------------------------- trace
def test_stream_golden_values():
    """tests/test_scenario.py's pinned values, and the first draws of a
    few streams equal to the JAX package's."""
    assert TT.Stream(42).next_u64() == 13679457532755275413
    assert TT.Stream(42, "x").uniform() == 0.4183931962706945
    for parts in ((0,), (42,), (1337, "arrivals", 0), (7, "shapes", 2),
                  (11, "prefix", 0, 3)):
        j, t = JT.Stream(*parts), TT.Stream(*parts)
        assert [t.next_u64() for _ in range(8)] == \
            [j.next_u64() for _ in range(8)]
        assert [t.expovariate(3.0) for _ in range(4)] == \
            [j.expovariate(3.0) for _ in range(4)]
        assert [t.randint(2, 48) for _ in range(4)] == \
            [j.randint(2, 48) for _ in range(4)]
    assert TT.stream_seed(5, "a", 3) == JT.stream_seed(5, "a", 3)


@pytest.mark.parametrize("process,extra", [
    ("constant", {}), ("poisson", {}),
    ("mmpp", {"rate_high": 90.0, "switch_s": 0.4}),
    ("diurnal", {"amplitude": 0.7})])
def test_arrival_processes_match_jax(process, extra):
    got = TT.arrival_times(TT.Stream(3, process), process, 25.0, 2.0,
                           t0=1.0, **extra)
    want = JT.arrival_times(JT.Stream(3, process), process, 25.0, 2.0,
                            t0=1.0, **extra)
    assert got == want and got


def test_rank_for_and_builtin_arrivals_match_jax():
    assert [TT.rank_for(i, n) for i in range(64) for n in (1, 7, 256)] == \
        [JT.rank_for(i, n) for i in range(64) for n in (1, 7, 256)]
    assert TS.builtin_arrivals("serve-bench-poisson", closed_loop_rps=10.0,
                               n=16) == \
        JS.builtin_arrivals("serve-bench-poisson", closed_loop_rps=10.0,
                            n=16)


@pytest.mark.parametrize("fname", CORPUS)
def test_corpus_events_byte_identical(fname):
    path = os.path.join(REPO, "scenarios", fname)
    j, t = JS.load_scenario(path), TS.load_scenario(path)
    assert t.to_json() == j.to_json()
    ej = JS.generate_events(j.seed, j.phases, j.vocab)
    et = TS.generate_events(t.seed, t.phases, t.vocab)
    assert TS.events_jsonl(et) == JS.events_jsonl(ej)
    assert TS.events_digest(et) == JS.events_digest(ej)


def test_event_digest_identical_across_fresh_processes():
    """Two fresh interpreters with different PYTHONHASHSEED values print
    the digest the JAX package computes in this process."""
    prog = ("import json;"
            "from horovod_tpu_torch.scenario import generate_events,"
            "events_digest;"
            f"doc=json.loads({json.dumps(json.dumps(_SPEC))});"
            "print(events_digest(generate_events("
            "doc['seed'],doc['phases'],256)))")
    want = JS.events_digest(JS.generate_events(7, _SPEC["phases"], 256))
    for hash_seed in ("1", "4242"):
        env = dict(os.environ, PYTHONHASHSEED=hash_seed,
                   PYTHONPATH=REPO + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        out = subprocess.run([sys.executable, "-c", prog], env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        assert out.stdout.strip() == want


# -------------------------------------------------------------- validation
def _raises_alike(fn_jax, fn_port):
    with pytest.raises(ValueError) as ej:
        fn_jax()
    with pytest.raises(ValueError) as et:
        fn_port()
    assert str(et.value) == str(ej.value)
    return str(et.value)


@pytest.mark.parametrize("mutate,msg", [
    (lambda d: d.pop("name"), "'name'"),
    (lambda d: d.update(phases=[]), "non-empty"),
    (lambda d: d.update(blast=1), "unknown fields"),
    (lambda d: d["phases"][0].pop("duration_s"), "duration_s"),
    (lambda d: d["phases"][0].update(kind="dance"), "phase #0 kind"),
    (lambda d: d["phases"][0]["arrivals"].update(process="storky"),
     "process"),
    (lambda d: d["phases"][0]["arrivals"].update(rate="fast"),
     "phase #0 arrivals field 'rate'"),
    (lambda d: d["phases"][0].pop("arrivals"), "arrivals"),
    (lambda d: d.update(engine="gpu"), "engine"),
    (lambda d: d.update(shed_high=4, shed_low=9), "shed_low"),
    (lambda d: d.update(storm=[{"kill": {"at_s": 99.0}}]), "horizon"),
    (lambda d: d.update(expect_alerts=["no-such-rule"]),
     "unknown rule 'no-such-rule'"),
    (lambda d: d.update(replicas=2, storm=[{"kill": {"at_s": 0.1,
                                                      "replica": 2}}]),
     "replica"),
    (lambda d: d.update(engine_config={"max_slots": 0}), "max_slots"),
    (lambda d: d.update(alert_rules=[{"name": "x"}]), "rule"),
])
def test_spec_validation_names_index_and_field(mutate, msg):
    doc = json.loads(json.dumps(_SPEC))
    mutate(doc)
    got = _raises_alike(lambda: JS.parse_scenario(json.loads(json.dumps(
        doc))), lambda: TS.parse_scenario(json.loads(json.dumps(doc))))
    assert msg in got


@pytest.mark.parametrize("items", [
    [{"kind": "explode", "at_s": 1.0}],
    [{"kill": {"rank": 0}}],
    [{"kill": {"at_s": "soon"}}],
    [{"kind": "kill", "at_s": 1.0}, {"stall": {"at_s": 2.0, "blast": 3}}],
    [{"kv_blackout": {"at_s": 1.0, "duration_s": -0.5}}],
    [{"kill": 7}],
    [{"kill": {"at_s": True}}],
    "kill",
])
def test_storm_validation_names_index_and_field(items):
    _raises_alike(lambda: JS.parse_storm(items),
                  lambda: TS.parse_storm(items))


def test_loads_scenario_json_and_yaml_match_jax():
    import yaml
    for text in (json.dumps(_SPEC), yaml.safe_dump(_SPEC)):
        assert TS.loads_scenario(text).to_json() == \
            JS.loads_scenario(text).to_json()


# ------------------------------------------------------------------- storm
_STORMS = [
    [{"kill": {"at_s": 1.0, "down_s": 0.4}},
     {"kill": {"at_s": 1.2, "down_s": 0.4, "rank": 1}},
     {"stall": {"at_s": 3.0, "duration_s": 0.2}}],
    [{"kill": {"at_s": 0.5, "rank": 1}},
     {"stall": {"at_s": 1.0, "duration_s": 0.25}},
     {"kv_blackout": {"at_s": 2.0, "duration_s": 0.05, "op": "put"}}],
    [{"kv_blackout": {"at_s": 1.0, "duration_s": 0.1, "scope": "serve_req"}},
     {"kv_blackout": {"at_s": 1.5, "duration_s": 0.1, "op": "get"}},
     {"kv_blackout": {"at_s": 2.0, "duration_s": 0.3, "shard": 1}},
     {"crash_commit": {"at_s": 2.5, "point": "pre_marker"}}],
    [{"kill": {"at_s": 0.3, "replica": 1, "down_s": 0.2}},
     {"kill": {"at_s": 0.35, "replica": 2}},
     {"kill": {"at_s": 0.4, "replica": 1}}],
]


@pytest.mark.parametrize("items", _STORMS)
def test_to_chaos_spec_and_windows_match_jax(items):
    js, ts = JS.parse_storm(items), TS.parse_storm(items)
    assert [vars(e) for e in ts] == [vars(e) for e in js]
    for tick_s, seed in ((0.01, 9), (0.025, 0)):
        assert TS.to_chaos_spec(ts, tick_s, seed=seed).to_json() == \
            JS.to_chaos_spec(js, tick_s, seed=seed).to_json()
        for shards in (1, 3):
            got = TS.windows(ts, tick_s, kv_shards=shards)
            want = JS.windows(js, tick_s, kv_shards=shards)
            assert [(w.kind, w.start_tick, w.end_tick, w.at_s, w.admission,
                     w.delivery, vars(w.event)) for w in got] == \
                [(w.kind, w.start_tick, w.end_tick, w.at_s, w.admission,
                  w.delivery, vars(w.event)) for w in want]


# ----------------------------------------------------------------- harness
def _replay_alike(j, t, **kw):
    rj = JS.ScenarioHarness(j, **kw).run()
    rt = TS.ScenarioHarness(t, **kw).run()
    assert rt == rj
    assert TS.rows_jsonl(TS.canonical_rows(rt)) == \
        JS.rows_jsonl(JS.canonical_rows(rj))
    return rt


@pytest.mark.parametrize("fname", CORPUS)
def test_corpus_rows_byte_identical_on_the_virtual_engine(fname):
    path = os.path.join(REPO, "scenarios", fname)
    r = _replay_alike(JS.load_scenario(path), TS.load_scenario(path))
    assert r["alerts"]["ok"], r["alerts"]
    assert r["requests"]["backlog"] == 0


@pytest.mark.parametrize("over", [
    {"storm": [{"kill": {"at_s": 0.4, "down_s": 0.2}}]},
    {"storm": [{"kv_blackout": {"at_s": 0.2, "duration_s": 0.3,
                                "scope": "serve_req"}}]},
    {"phases": [{"name": "heavy", "kind": "serve", "duration_s": 1.0,
                 "arrivals": {"process": "poisson", "rate": 200},
                 "shapes": {"prompt_mean": 16, "prompt_max": 48,
                            "output_mean": 10}}],
     "shed_high": 10, "shed_low": 5,
     "engine_config": {"max_slots": 2, "max_batch_tokens": 8,
                       "prefill_chunk": 4}},
    {"storm": [{"kill": {"at_s": 0.4, "down_s": 0.3}}],
     "alert_rules": [_ENGINE_DOWN],
     "expect_alerts": ["scenario-engine-down"]},
    {"alert_rules": [_ENGINE_DOWN],
     "expect_alerts": ["scenario-engine-down"]},
    {"phases": [{"name": "warm", "kind": "train", "duration_s": 0.5,
                 "train_rate": 20},
                {"name": "mix", "kind": "mixed", "duration_s": 1.0,
                 "train_rate": 10,
                 "arrivals": {"process": "constant", "rate": 10}}]},
    {"storm": [{"stall": {"at_s": 0.3, "duration_s": 0.2}},
               {"kv_blackout": {"at_s": 0.6, "duration_s": 0.1,
                                "op": "get"}}]},
], ids=["kill", "admission-blackout", "shedding", "alert-fires",
        "alert-missing", "train-and-mixed", "stall-and-delivery"])
def test_harness_reports_match_jax(over):
    r = _replay_alike(*_both(_doc(**over)))
    if "expect_alerts" in over:
        assert r["alerts"]["ok"] == ("storm" in over)


def test_virtual_ranks_override_matches_jax():
    j, t = _both(_doc())
    r = _replay_alike(j, t, virtual_ranks=8)
    assert r["virtual_ranks"] == 8
    assert r["digest"] == TS.ScenarioHarness(t).run()["digest"]


def test_harness_on_the_real_engine_matches_jax():
    """``engine: real`` on ``tiny`` in fp32 with a kill mid-stream: both
    harnesses build their ``ServeEngine`` through ``engine_factory`` over
    the same numpy weights (the JAX ones, carried over by
    ``llama.params_from_jax``), with the spec's ``engine_config`` mapped
    onto ``ServeConfig`` as ``make_engine_factory`` maps it.  Reports and
    rows identical; every request finishes with its tokens, none lost or
    repeated across the redrive."""
    import jax
    from horovod_tpu.models import llama as JL
    from horovod_tpu.serve.config import ServeConfig as JCfg
    from horovod_tpu.serve.engine import ServeEngine as JEngine
    from horovod_tpu_torch.models import llama as TL
    from horovod_tpu_torch.serve.config import ServeConfig as TCfg
    from horovod_tpu_torch.serve.engine import ServeEngine as TEngine
    doc = _doc(engine="real", phases=[
        {"name": "p0", "kind": "serve", "duration_s": 0.3,
         "arrivals": {"process": "poisson", "rate": 30},
         "shapes": {"prompt_mean": 6, "prompt_max": 12, "output_mean": 4,
                    "output_max": 8, "prefix_groups": 2}}],
        storm=[{"kill": {"at_s": 0.15, "down_s": 0.05}}],
        engine_config={"max_slots": 4, "max_batch_tokens": 32,
                       "prefill_chunk": 8})
    j, t = _both(doc)
    jcfg, tcfg = JL.CONFIGS["tiny"], TL.CONFIGS["tiny"]
    params = JL.init(jax.random.PRNGKey(0), jcfg)
    model = TL.params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                               tcfg, device="cpu")
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("hvd",))
    ec = t.engine_config

    def scfg(cls):
        return cls(max_slots=ec.get("max_slots", 4),
                   block_size=ec.get("block_size", 4),
                   cache_blocks=ec.get("cache_blocks", 64),
                   max_seq_len=ec.get("max_seq_len", 96),
                   max_batch_tokens=ec.get("max_batch_tokens", 32),
                   prefill_chunk=ec.get("prefill_chunk", 16))
    builds = []

    def tfactory():
        builds.append(1)
        return TEngine(model, scfg(TCfg), device="cpu")
    rj = JS.ScenarioHarness(j, engine_factory=lambda: JEngine(
        JL, jcfg, params, scfg(JCfg), mesh=mesh)).run()
    rt = TS.ScenarioHarness(t, engine_factory=tfactory).run()
    assert rt == rj
    assert TS.rows_jsonl(TS.canonical_rows(rt)) == \
        JS.rows_jsonl(JS.canonical_rows(rj))
    assert rt["restarts"] == 1 and len(builds) == 2
    ev = TS.generate_events(t.seed, t.phases, t.vocab)
    arrivals = [e for e in ev if e["kind"] == "arrive"]
    assert rt["requests"]["completed"] == len(arrivals) > 0
    assert rt["requests"]["delivered_tokens"] == \
        sum(e["max_new"] for e in arrivals)


def test_make_engine_factory_builds_tiny_on_the_given_device():
    t = TS.parse_scenario(_doc(engine="real"))
    from horovod_tpu_torch.scenario.harness import make_engine_factory
    build = make_engine_factory(t, device="cpu")
    a, b = build(), build()
    assert a.device.type == "cpu" and a.model is b.model
    assert a.cfg.max_slots == 4 and a.cfg.cache_blocks == 64
    too_wide = TS.parse_scenario(_doc(engine="real", vocab=512))
    with pytest.raises(ValueError, match="vocab 512"):
        make_engine_factory(too_wide, device="cpu")()


# ------------------------------------------------------------------- knobs
def test_validate_scenario_knobs_matches_jax(tmp_path):
    bad = tmp_path / "bad.yaml"
    bad.write_text("name: x\n")
    good = tmp_path / "good.json"
    good.write_text(json.dumps(_SPEC))
    for knobs in ({"HOROVOD_SCENARIO": "", "HOROVOD_SCENARIO_RANKS": 0,
                   "HOROVOD_SCENARIO_TICK_MS": 0.0}, {},
                  {"HOROVOD_SCENARIO": str(good)}):
        JS.validate_scenario_knobs(knobs)
        TS.validate_scenario_knobs(knobs)
    for knobs in ({"HOROVOD_SCENARIO_RANKS": -1},
                  {"HOROVOD_SCENARIO_TICK_MS": -2.0},
                  {"HOROVOD_SCENARIO": str(tmp_path / "nope.yaml")},
                  {"HOROVOD_SCENARIO": str(bad)}):
        _raises_alike(lambda: JS.validate_scenario_knobs(knobs),
                      lambda: TS.validate_scenario_knobs(knobs))


@pytest.mark.parametrize("name,value", [
    ("HOROVOD_SCENARIO_RANKS", "-3"), ("HOROVOD_SCENARIO_TICK_MS", "-1"),
    ("HOROVOD_SCENARIO", "/nonexistent/scenario.yaml")])
def test_init_rejects_bad_scenario_knobs(monkeypatch, name, value):
    from horovod_tpu.common.knobs import KNOBS as JK
    from horovod_tpu_torch.common.knobs import KNOBS as TK
    import horovod_tpu_torch as hvd
    assert TK[name].default == JK[name].default
    monkeypatch.setenv(name, value)
    with pytest.raises(ValueError, match=name):
        hvd.init(device="cpu")
    assert not hvd.is_initialized()


# ------------------------------------------------------------ determinism
def test_hvdlint_scenario_determinism_on_the_port():
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        import hvdlint
    finally:
        sys.path.pop(0)
    files = [f"horovod_tpu_torch/scenario/{f}.py"
             for f in ("trace", "spec", "storm", "harness")]
    assert hvdlint.check_scenario_determinism(files=files) == []


def test_port_imports_neither_jax_nor_the_jax_package():
    prog = ("import sys;"
            "import horovod_tpu_torch as hvd;"
            "from horovod_tpu_torch import scenario, tune;"
            "from horovod_tpu_torch.scenario import harness;"
            "from horovod_tpu_torch.utils import platform, probe;"
            "from horovod_tpu_torch.common import util;"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'horovod_tpu' or "
            "m.startswith('horovod_tpu.')];"
            "print(bad)")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run([sys.executable, "-c", prog], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
