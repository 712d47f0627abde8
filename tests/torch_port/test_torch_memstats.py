"""The port's memory plane (``horovod_tpu_torch/perf/memstats.py``) against
the JAX package's (``horovod_tpu/perf/memstats.py``), on the same inputs.
Tolerances: exact (``==``) throughout; a sample's measured bytes differ by
source (the live tensors here, ``jax.live_arrays()`` there), so those are
held to the port's own storages.

  * the knob checks raise on the values the JAX ones raise on;
  * the CPU sample: source ``live_buffers``, each storage counted once, no
    cap; on a CUDA device a failing ``memory_stats`` raises, never a CPU
    figure;
  * the kill switch, the rate limit, the row and report shapes, the
    reconciliation against ``zero_memory_bytes`` at every level;
  * the pressure latch fires once per crossing, quiet without a cap;
  * the native leg through the port's core;
  * the KV-pool provider: the engine registers it and ``close`` releases
    it, a dropped engine reads as absent, and its planes and gauges equal
    the JAX engine's for the same config and traffic.
"""

import dataclasses
import gc
import math
import os
import time
import weakref

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import jax  # noqa: E402

from horovod_tpu.models import llama as JL  # noqa: E402
from horovod_tpu.perf import ledger as JLed  # noqa: E402
from horovod_tpu.perf import memstats as JMS  # noqa: E402
from horovod_tpu.serve import engine as JE  # noqa: E402
from horovod_tpu.serve.config import ServeConfig as JServeConfig  # noqa
from horovod_tpu.utils import metrics as JM  # noqa: E402

from horovod_tpu_torch.common import basics as TB  # noqa: E402
from horovod_tpu_torch.models import llama as TL  # noqa: E402
from horovod_tpu_torch.perf import costmodel as TCM  # noqa: E402
from horovod_tpu_torch.perf import ledger as TLed  # noqa: E402
from horovod_tpu_torch.perf import memstats as TMS  # noqa: E402
from horovod_tpu_torch.serve import ServeConfig, ServeEngine  # noqa: E402
from horovod_tpu_torch.utils import metrics as TM  # noqa: E402


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    monkeypatch.setenv("HOROVOD_MEM", "1")
    for mod in (TMS, JMS, TLed, JLed):
        mod.reset()
    yield
    for mod in (TMS, JMS, TLed, JLed):
        mod.reset()


def _outcome(fn, *args):
    try:
        fn(*args)
        return "ok"
    except ValueError:
        return "ValueError"


# ------------------------------------------------------------------ knobs
@pytest.mark.parametrize("interval,wm", [
    (0.0, 0.9), (30, 1.0), (-1, 0.9), (0.0, 0.0), (0.0, 1.5), (-0.5, 2.0),
    (1e-9, 1e-9), (0.0, -0.1)])
def test_validate_mem_knobs_matches_jax(interval, wm):
    knobs = {"HOROVOD_MEM_INTERVAL": interval,
             "HOROVOD_MEM_HIGH_WATERMARK": wm}
    assert _outcome(TMS.validate_mem_knobs, knobs) == \
        _outcome(JMS.validate_mem_knobs, knobs)


@pytest.mark.parametrize("knob,value", [
    ("HOROVOD_MEM_INTERVAL", "-1"), ("HOROVOD_MEM_HIGH_WATERMARK", "0"),
    ("HOROVOD_MEM_HIGH_WATERMARK", "1.5")])
def test_init_refuses_bad_mem_knobs(monkeypatch, knob, value):
    import horovod_tpu_torch as hvd
    monkeypatch.setenv(knob, value)
    with pytest.raises(ValueError, match=knob):
        hvd.init(device="cpu")
    assert not hvd.is_initialized()


def test_knob_defaults_match_jax():
    from horovod_tpu.common import knobs as JK
    from horovod_tpu_torch.common import knobs as TK
    for name in ("HOROVOD_PERF", "HOROVOD_PERF_INTERVAL",
                 "HOROVOD_PERF_LINK", "HOROVOD_MEM", "HOROVOD_MEM_INTERVAL",
                 "HOROVOD_MEM_HIGH_WATERMARK"):
        assert TK.KNOBS[name].default == JK.KNOBS[name].default, name
        for raw in ("1", "0", "0.25", "auto"):
            try:
                want = JK.KNOBS[name].parse(raw)
            except ValueError:
                with pytest.raises(ValueError):
                    TK.KNOBS[name].parse(raw)
                continue
            assert TK.KNOBS[name].parse(raw) == want


# ------------------------------------------------------------ measurement
def test_cpu_sample_counts_each_storage_once():
    """The CPU source: the live tensors' storages, a view adding nothing,
    a new tensor adding its bytes; no cap."""
    base = TMS.measure_device()
    assert base["source"] == "live_buffers" and base["cap_bytes"] == 0
    assert base["peak_bytes_in_use"] is None
    x = torch.ones(1 << 18)          # 1 MiB
    grown = TMS.measure_device("cpu")["bytes_in_use"]
    views = [x[1:], x.view(512, 512), x[::2]]
    assert TMS.measure_device()["bytes_in_use"] == grown
    assert grown - base["bytes_in_use"] >= x.numel() * 4
    del x, views
    gc.collect()
    assert TMS.measure_device()["bytes_in_use"] < grown


def test_a_cuda_device_never_reads_as_the_cpu(monkeypatch):
    """No fallback that hides a card: a CUDA device whose ``memory_stats``
    fails raises (the JAX function would report its CPU fallback)."""
    def boom(device=None):
        raise RuntimeError("memory_stats failed")
    monkeypatch.setattr(torch.cuda, "memory_stats", boom)
    with pytest.raises(RuntimeError, match="memory_stats failed"):
        TMS.measure_device("cuda:0")
    with pytest.raises(RuntimeError):
        TMS.sample(device="cuda:0", force=True)
    assert TMS.last_sample() is None


def test_cuda_measurement_reads_the_allocator(monkeypatch):
    """On a CUDA device: ``allocated_bytes.all.current`` and ``.peak``, and
    the card's total from ``mem_get_info`` as the cap."""
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda d=None: {
        "allocated_bytes.all.current": 3 << 30,
        "allocated_bytes.all.peak": 5 << 30,
        "reserved_bytes.all.current": 6 << 30})
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda d=None: (70 << 30, 80 << 30))
    assert TMS.measure_device("cuda:0") == {
        "source": "device", "bytes_in_use": 3 << 30,
        "peak_bytes_in_use": 5 << 30, "cap_bytes": 80 << 30}
    row = TMS.sample(device="cuda:0", force=True)
    assert row["watermark"] == 3 / 80
    assert row["headroom_bytes"] == 77 << 30


def test_kill_switch_and_rate_limit(monkeypatch):
    monkeypatch.setenv("HOROVOD_MEM_INTERVAL", "100")
    s = TMS.MemSampler()
    assert s.sample(now=1000.0) is not None
    assert s.sample(now=1050.0) is None
    assert s.sample(now=1050.0, force=True) is not None
    assert s.sample(now=1200.0) is not None
    monkeypatch.setenv("HOROVOD_MEM", "0")
    assert not TMS.enabled()
    assert TMS.sample(force=True) is None and TMS.last_sample() is None


def test_sample_row_and_report_section_shapes():
    """The JAX row's keys, and the report section's, exactly."""
    arr = torch.ones(256)
    TLed.configure(zero_model={"n_params": 50_000, "world": 4, "level": 2,
                               "opt_slots": 2})
    JLed.configure(zero_model={"n_params": 50_000, "world": 4, "level": 2,
                               "opt_slots": 2})
    assert TMS.report_section() is None
    row = TMS.sample(force=True, cap_bytes=1 << 30)
    jrow = JMS.sample(force=True, cap_bytes=1 << 30)
    assert set(row) == set(jrow)
    assert row["peak_bytes_in_use"] >= row["bytes_in_use"] >= arr.nbytes
    assert row["headroom_bytes"] == (1 << 30) - row["bytes_in_use"]
    # the geometry side is the JAX sampler's, key for key
    for key in ("predicted", "native", "kv_pool", "cap_bytes"):
        assert row[key] == jrow[key], key
    assert row["planes"] == jrow["planes"]
    sec, jsec = TMS.report_section(), JMS.report_section()
    assert set(sec) == set(jsec) and set(sec["measured"]) == \
        set(jsec["measured"])
    assert sec["planes"] == jsec["planes"]
    assert sec["predicted_total_bytes"] == jsec["predicted_total_bytes"]
    assert TLed.report()["memory"]["source"] == "live_buffers"
    del arr


@pytest.mark.parametrize("level", [0, 1, 2, 3])
def test_reconciliation_at_every_zero_level(level):
    """The predicted side is ``zero_memory_bytes`` of the ledger's model
    (the JAX sampler's, equal), and the drift is in use over it."""
    arr = torch.ones(512)
    kw = {"n_params": 100_000, "world": 2, "level": level, "opt_slots": 2}
    TLed.configure(zero_model=kw)
    JLed.configure(zero_model=kw)
    row = TMS.sample(force=True)
    assert row["predicted"] == JMS.sample(force=True)["predicted"] == \
        TCM.zero_memory_bytes(level, 100_000, 2)
    assert row["model_drift_ratio"] == \
        row["bytes_in_use"] / row["predicted"]["total_bytes"]
    assert math.isfinite(row["model_drift_ratio"])
    assert TM.MEM_MODEL_DRIFT.value() == row["model_drift_ratio"]
    assert TM.MEM_PLANE_BYTES.value(plane="opt_state") == \
        row["predicted"]["opt_state_bytes"]
    del arr


# ---------------------------------------------------------------- sentinel
def test_pressure_latch_fires_once_per_crossing():
    """Above, hovering, below, above again: two firings, as the JAX
    latch (``tests/test_memstats.py:211``)."""
    before = TM.MEM_PRESSURE_EVENTS.value()
    arr = torch.ones(1024)
    s = TMS.MemSampler()
    b = TMS.measure_device()["bytes_in_use"]
    for cap, events in ((b, 1), (b, 1), (b * 100, 1), (b, 2)):
        s.sample(cap_bytes=cap, force=True)
        assert s.pressure_events == events
    assert TM.MEM_PRESSURE_EVENTS.value() - before == 2
    del arr


def test_pressure_latch_matches_jax_on_the_same_watermarks(monkeypatch):
    """The same sequence of watermarks fires at the same samples.  Both
    packages measure a fixed 1000 bytes (their live buffers move under
    other tests' garbage), so each cap sets the watermark exactly."""
    fracs = [0.5, 0.95, 0.97, 0.2, 0.91, 0.9, 0.89, 1.0]
    got, want = [], []
    for mod, out in ((TMS, got), (JMS, want)):
        monkeypatch.setattr(mod, "measure_device", lambda device=None: {
            "source": "live_buffers", "bytes_in_use": 1000,
            "peak_bytes_in_use": None, "cap_bytes": 0})
        s = mod.MemSampler()
        for f in fracs:
            row = s.sample(cap_bytes=round(1000 / f), force=True)
            out.append((row["watermark"], s.pressure_events,
                        s.pressure_above))
    assert got == want
    assert [e for _, e, _ in got] == [0, 1, 1, 1, 2, 2, 2, 3]


def test_pressure_quiet_without_cap():
    s = TMS.MemSampler()
    row = s.sample(force=True)
    assert row["watermark"] == 0.0 and row["headroom_bytes"] is None
    assert s.pressure_events == 0 and not s.pressure_above


# ------------------------------------------------------------- native core
def test_native_mem_through_the_port_core():
    hub = TB.LoopbackHub(1)
    core = TB.CoordinationCore.loopback(hub, rank=0)
    try:
        core.submit("t0", "f32:4", TB.OP_ALLREDUCE, 16)
        assert core.wait(5.0) is not None
        nm = TMS.native_mem(core)
        assert nm["version"] >= 1 and nm["rss_bytes"] > 0
        assert nm["trace_ring_bytes"] > 0
        row = TMS.sample(core=core, force=True)
        nm = row["native"]
        assert row["planes"]["native_core"] == (
            nm["trace_ring_bytes"] + nm["window_ring_bytes"]
            + nm["response_cache_bytes"])
        assert TM.MEM_NATIVE_BYTES.value(kind="rss") > 0
    finally:
        core.shutdown()
        time.sleep(0.2)
        core.close()
        hub.close()
    assert TMS.native_mem(object()) is None
    assert TMS.native_mem() is None  # no runtime, no core


# ------------------------------------------------------- kv-pool provider
@pytest.fixture(scope="module")
def tiny():
    cfg = JL.CONFIGS["tiny"]
    params = JL.init(jax.random.PRNGKey(0), cfg)
    tree = jax.tree_util.tree_map(np.asarray, params)
    return cfg, params, TL.params_from_jax(tree, TL.CONFIGS["tiny"],
                                           device="cpu")


def _scfg(**kw):
    base = dict(max_slots=2, block_size=4, cache_blocks=32, max_seq_len=32,
                max_batch_tokens=12, prefill_chunk=6, spec_k=4,
                spill_blocks=8)
    base.update(kw)
    return ServeConfig(**base)


def _traffic(vocab):
    rng = np.random.RandomState(11)
    system = rng.randint(0, vocab, 8).tolist()
    return [system + rng.randint(0, vocab, n).tolist() for n in (3, 5, 2)] \
        + [rng.randint(0, vocab, 7).tolist()]


def _serve(engine, prompts, wait):
    reqs = [engine.submit(p, 6, req_id=f"r{i}")
            for i, p in enumerate(prompts)]
    # mid-traffic: requests hold blocks
    engine.step()
    engine.step()
    mid = wait()
    engine.flush()
    assert all(r.state == "done" for r in reqs)
    return mid, wait()


def _kv_gauges(M):
    return (M.MEM_KV_BLOCKS_USED.value(), M.MEM_KV_BLOCKS_FREE.value(),
            M.MEM_KV_BLOCKS_SHARED.value(), M.MEM_KV_UTIL.value())


def test_kv_pool_planes_match_the_jax_engine(tiny):
    """The engine registers its pool at construction: the sampler's
    ``kv_pool`` and ``kv_spill`` planes, its ``kv_pool`` row and the
    ``hvd_mem_kv_*`` gauges equal the JAX engine's, mid-traffic and after
    it, for the same config and prompts."""
    cfg, params, model = tiny
    scfg = _scfg()
    prompts = _traffic(cfg.vocab)

    def take(mod, M):
        row = mod.sample(force=True)
        return (row["planes"].get("kv_pool"), row["planes"].get("kv_spill"),
                row["kv_pool"], _kv_gauges(M))

    engine = ServeEngine(model, scfg, device="cpu")
    got = _serve(engine, prompts, lambda: take(TMS, TM))
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("hvd",))
    ref = JE.ServeEngine(JL, cfg, params,
                         JServeConfig(**dataclasses.asdict(scfg)), mesh=mesh)
    want = _serve(ref, prompts, lambda: take(JMS, JM))
    assert got == want
    assert got[0][2]["used_blocks"] > 0 and got[0][0] == \
        engine.kv_pool()["pool_bytes"]
    engine.close()
    ref.close()


def test_kv_pool_provider_registers_and_releases(tiny):
    """``close`` unregisters the engine's provider (and only its own); a
    dropped engine's provider reads as absent and does not keep its pool
    alive; a failing provider is an absent plane, as in the JAX module."""
    _, _, model = tiny
    a = ServeEngine(model, _scfg(), device="cpu")
    assert TMS.kv_pool_stats() == a.kv_pool()
    b = ServeEngine(model, _scfg(cache_blocks=16), device="cpu")
    assert TMS.kv_pool_stats()["num_blocks"] == 16
    a.close()                       # not the registered one: no effect
    assert TMS.kv_pool_stats()["num_blocks"] == 16
    b.close()
    assert TMS._kv_pool_fn is None and TMS.kv_pool_stats() is None
    assert "kv_pool" not in TMS.sample(force=True)["planes"]
    c = ServeEngine(model, _scfg(), device="cpu")
    alive = weakref.ref(c)
    del c
    gc.collect()
    assert alive() is None          # the provider held no reference
    assert TMS._kv_pool_fn is not None and TMS.kv_pool_stats() is None

    def boom():
        raise RuntimeError("closing engine")
    TMS.set_kv_pool_provider(boom)
    assert TMS.kv_pool_stats() is None
    TMS.reset()
    assert TMS._kv_pool_fn is None
