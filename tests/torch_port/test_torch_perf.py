"""The port's perf plane (``horovod_tpu_torch/perf/``, ``runner/doctor.py``,
``utils/profiler.py``) against the JAX package's (``horovod_tpu/perf/``,
``horovod_tpu/runner/doctor.py``) on the same inputs.  Tolerances: every
comparison is exact (``==`` on floats, dicts and texts) unless a test says
otherwise; a report's ``time`` stamps are dropped before comparing.

  * the rest of the cost model against the JAX functions and goldens
    (``tests/test_perf.py:27-202``): the MoE counts, ``predicted_step_time``,
    ``zero_level_table``, ``plan_comm_bytes`` over the two packages' fusion
    plans; ``compiled_flops`` (a FLOP counter in place of XLA's cost
    analysis) with the attention counted beside the counter;
  * the ledger fed the same ``configure``/``add_input_wait``/
    ``record_step`` sequences as a JAX ``PerfLedger``: the same rows and
    reports; ``merge_perf_reports`` and ``local_verdict`` on the same bytes;
    the knob checks; the port's departures (the chip and link resolution,
    the synchronizing ``timed_step``);
  * the JAX gate tests' matrix (``tests/test_perf.py:410-487``) through the
    port's gate, and its command line;
  * the doctor's ``--perf``, ``--serve`` and ``--request`` texts against
    the JAX doctor's for the same views, and its refusals;
  * the native op-stats C API round trip on the port's core
    (``tests/test_perf.py:343-408``);
  * a ``-np 2`` gloo launch with ``HOROVOD_PERF=1`` whose ``/perf`` equals
    the JAX merge of the same KV bytes;
  * ``chip_smoke.py``'s phase 16 and ``--ranks N --parts perf`` rehearsed
    on the CPU with ``tiny``.
"""

import json
import os
import signal
import subprocess
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from horovod_tpu.common import basics as JB  # noqa: E402
from horovod_tpu.common.knobs import Knobs as JKnobs  # noqa: E402
from horovod_tpu.ops import fusion as JF  # noqa: E402
from horovod_tpu.perf import costmodel as JCM  # noqa: E402
from horovod_tpu.perf import gate as JG  # noqa: E402
from horovod_tpu.perf import ledger as JLed  # noqa: E402
from horovod_tpu.perf import memstats as JMS  # noqa: E402
from horovod_tpu.runner import doctor as JD  # noqa: E402

import horovod_tpu_torch as hvd  # noqa: E402
from horovod_tpu_torch.common import basics as TB  # noqa: E402
from horovod_tpu_torch.common.knobs import Knobs as TKnobs  # noqa: E402
from horovod_tpu_torch.ops import fusion as TF  # noqa: E402
from horovod_tpu_torch.perf import costmodel as TCM  # noqa: E402
from horovod_tpu_torch.perf import gate as TG  # noqa: E402
from horovod_tpu_torch.perf import ledger as TLed  # noqa: E402
from horovod_tpu_torch.perf import memstats as TMS  # noqa: E402
from horovod_tpu_torch.runner import doctor as TD  # noqa: E402
from torch_port_ports import hold_ports  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _outcome(fn, *args, **kwargs):
    """``("ok", value)`` or ``("raise", type name)``."""
    try:
        return ("ok", fn(*args, **kwargs))
    except Exception as e:  # noqa: BLE001 - compared, not swallowed
        return ("raise", type(e).__name__)


def _untimed(obj):
    """``obj`` with every ``time`` stamp dropped (reports, views)."""
    if isinstance(obj, dict):
        return {k: _untimed(v) for k, v in obj.items() if k != "time"}
    if isinstance(obj, list):
        return [_untimed(v) for v in obj]
    return obj


@pytest.fixture(autouse=True)
def _fresh_planes():
    """Both packages' module-global ledgers and samplers start empty."""
    for mod in (JLed, TLed):
        mod.reset()
    JMS.reset()
    TMS.reset()
    yield
    for mod in (JLed, TLed):
        mod.reset()
    JMS.reset()
    TMS.reset()


# ------------------------------------------------------------- cost model
@pytest.mark.parametrize("args", [
    (256, 64, 2, 4, 2, 128, 4), (256, 64, 2, 4, 2, 128, 8),
    (4096, 256, 4, 8, 4, 512, 8), (32000, 4096, 32, 32, 8, 14336, 8)])
def test_moe_param_counts_match_jax(args):
    assert TCM.moe_llama_param_count(*args) == \
        JCM.moe_llama_param_count(*args)
    for k in range(1, args[-1] + 1):
        assert TCM.moe_llama_active_param_count(*args, k) == \
            JCM.moe_llama_active_param_count(*args, k)


def test_moe_param_count_goldens_and_the_port_model():
    """The JAX goldens (``tests/test_perf.py:35-45``), and the formula
    against the port's own MoE model's parameters."""
    assert TCM.moe_llama_param_count(256, 64, 2, 4, 2, 128, 4) == 189248
    assert TCM.moe_llama_param_count(4096, 256, 4, 8, 4, 512, 8) == \
        11282688
    assert TCM.moe_llama_active_param_count(
        4096, 256, 4, 8, 4, 512, 8, 1) == 3942656
    from horovod_tpu_torch.models import moe_llama
    cfg = moe_llama.CONFIGS["tiny"]
    model = moe_llama.init(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    assert sum(p.numel() for p in model.parameters()) == \
        TCM.moe_llama_param_count(cfg.vocab, cfg.dim, cfg.n_layers,
                                  cfg.n_heads, cfg.n_kv_heads,
                                  cfg.moe_hidden, cfg.n_experts)


@pytest.mark.parametrize("flops,comm,kw", [
    (1e9, 1e6, dict(chip="cpu", link="loopback")),
    (1e9, 1e6, dict(overlap_fraction=1.0)),
    (0, 1e9, dict(link="dcn")), (0, 1e9, dict(link="ici")),
    (7.4e13, 3e9, dict(chip="v5e", link="ici", overlap_fraction=0.3,
                       input_seconds=0.01)),
    (1, 1, dict(link="carrier-pigeon")),
    (1, 1, dict(overlap_fraction=1.5))])
def test_predicted_step_time_matches_jax(flops, comm, kw):
    assert _outcome(TCM.predicted_step_time, flops, comm, **kw) == \
        _outcome(JCM.predicted_step_time, flops, comm, **kw)


def test_predicted_step_time_on_the_h100():
    """The port's own entries: 989 TFLOP/s and NVLink at 450 GB/s."""
    pred = TCM.predicted_step_time(989e12, 450e9, chip="h100",
                                   link="nvlink")
    assert pred["compute_s"] == 1.0 and pred["exposed_comm_s"] == 1.0


@pytest.mark.parametrize("kw", [
    dict(n_params=1000, world=4, k=2, wire_format="bf16",
         flops_per_step=1e9, chip="cpu", link="ici"),
    dict(n_params=1 << 20, world=8), dict(n_params=1000, world=1),
    dict(n_params=12345, world=3, opt_slots=1, ef=True, k=4,
         wire_format="int8_ring", link="dcn", flops_per_step=3e7)])
def test_zero_level_table_matches_jax(kw):
    kw = dict(kw)
    args = (kw.pop("n_params"), kw.pop("world"))
    assert TCM.zero_level_table(*args, **kw) == \
        JCM.zero_level_table(*args, **kw)


_SHAPES = [(1 << 20,), (256,), (64,), (300, 700), (5,), (4096, 33)]


@pytest.mark.parametrize("policy", ["none", "bf16", "int8_ring", "auto",
                                    "dcn_int8"])
@pytest.mark.parametrize("sizes", [{"flat": 8}, {"flat": 1},
                                   {"dcn": 2, "ici": 4}])
def test_plan_comm_bytes_matches_jax(policy, sizes):
    """The same shapes planned by each package's ``make_plan`` and priced
    by each package's wire model."""
    t_plan = TF.make_plan(_SHAPES, [torch.float32] * len(_SHAPES), 4 << 20)
    j_plan = JF.make_plan(_SHAPES, [np.float32] * len(_SHAPES), 4 << 20)
    assert TCM.plan_comm_bytes(t_plan, policy, sizes) == \
        JCM.plan_comm_bytes(j_plan, policy, sizes)


def _sum_attention(q, k, v):
    """An attention of the right shapes whose products are all
    elementwise: a FLOP counter counts nothing in it."""
    g = q.shape[2] // k.shape[2]
    return q + k.repeat_interleave(g, 2) + v.repeat_interleave(g, 2)


def test_compiled_flops_counts_attention_beside_the_counter():
    """``compiled_flops`` of the tiny Llama's forward and backward with
    the flash-attention wrapper equals the counter's count of the same
    step with an attention that has no products, plus the wrapper's three
    calls a layer priced by ``attention_flops``: what the counter saw
    inside the wrapper (the plain path's products on the CPU) is taken
    out, and nothing is counted twice."""
    from torch.utils.flop_counter import FlopCounterMode
    from horovod_tpu_torch.models import llama
    cfg = llama.CONFIGS["tiny"]
    model = llama.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab, (2, 65), dtype=np.int64))

    def fwd_bwd(attn):
        model.zero_grad(set_to_none=True)
        llama.loss_fn(model, ids, attn_fn=attn, ce_chunks=2).backward()

    counted = TCM.compiled_flops(fwd_bwd, hvd.flash_attention)
    counter = FlopCounterMode(display=False)
    with counter:
        fwd_bwd(_sum_attention)
    B, S, H, D = 2, 64, cfg.n_heads, cfg.dim // cfg.n_heads
    attn = cfg.n_layers * sum(
        TCM.attention_flops(kind, B, S, H, D, True)
        for kind in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"))
    assert counted == counter.get_total_flops() + attn
    # the wrapper's Function is back to counting nothing
    from horovod_tpu_torch.ops import flash_attention as FA
    assert FA.FLOP_TALLY is None


def test_compiled_flops_none_means_no_count():
    assert TCM.compiled_flops(lambda: torch.ones(3) + 1) is None
    assert TCM.compiled_flops(lambda: 1 / 0) is None


def test_attention_flops_is_the_chip_checks_formula():
    """``attention_flops`` is ``chip_smoke.py`` ``attention_cost``'s
    product count, at the 1b training shape and a non-causal one."""
    sys.path.insert(0, REPO)
    import chip_smoke
    for kind in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        for causal in (True, False):
            want, _ = chip_smoke.attention_cost(
                kind, B=4, S=2048, H=32, HK=8, D=64, causal=causal,
                itemsize=2)
            assert TCM.attention_flops(kind, 4, 2048, 32, 64, causal) == want


# ----------------------------------------------------------------- ledger
_SEQUENCES = {
    "plain": [("configure", dict(flops_per_step=1e8,
                                 comm_bytes_per_step=1e6, chip="cpu",
                                 link="loopback")),
              ("wait", 0.002), ("step", 0.01), ("step", 0.02),
              ("step", 0.015)],
    "overpredicting": [("configure", dict(flops_per_step=1e12)),
                       ("step", 0.01), ("step", 0.5)],
    "input_capped": [("wait", 5.0), ("step", 0.01), ("step", 0.01),
                     ("wait", 0.0), ("wait", -1.0), ("step", 0.0)],
    "unconfigured": [("step", 0.03), ("wait", 0.01), ("step", 0.02)],
    "zero": [("configure", dict(
        flops_per_step=1e7, comm_bytes_per_step=JCM.zero_comm_bytes(
            1 << 16, 8, 2, k=2)["total_bytes"],
        zero_model={"n_params": 1 << 16, "world": 8, "level": 2, "k": 2,
                    "opt_slots": 2})),
        ("step", 0.0201), ("step", 0.0199), ("step", 0.02)],
    "layout": [("configure", dict(
        flops_per_step=5e9, comm_bytes_per_step=2e7, overlap_fraction=0.5,
        link="ici",
        layout_model={"n_params": 10 ** 7, "world": 8, "dim": 512,
                      "n_layers": 8, "n_heads": 8, "n_kv_heads": 4,
                      "batch": 8, "seq": 256, "mem_cap_bytes": 1e9,
                      "active": {"dp": 8, "tp": 1, "pp": 1}})),
        ("wait", 0.001), ("step", 0.05), ("step", 0.06)],
    "reconfigured": [("configure", dict(flops_per_step=1e6)),
                     ("step", 0.01),
                     ("configure", dict(comm_bytes_per_step=1e7,
                                        link="dcn", overlap_fraction=0.9)),
                     ("step", 0.01)],
}


def _feed(ledger, seq):
    rows = []
    for what, arg in seq:
        if what == "configure":
            ledger.configure(**arg)
        elif what == "wait":
            ledger.add_input_wait(arg)
        else:
            rows.append(ledger.record_step(arg))
    return rows


@pytest.mark.parametrize("name", sorted(_SEQUENCES))
def test_ledger_rows_and_report_match_jax(name):
    """Exact: each row and the whole report (time stamps dropped), the ZeRO
    what-if and the layout sections included.  Without a runtime both
    ledgers price on chip ``cpu`` and link ``loopback``."""
    j, t = JLed.PerfLedger(), TLed.PerfLedger()
    assert _feed(t, _SEQUENCES[name]) == _feed(j, _SEQUENCES[name])
    assert _untimed(t.report()) == _untimed(j.report())
    assert t.model_drift_ratio() == j.model_drift_ratio()


def test_rows_sum_to_the_step():
    """The invariant ``tests/test_perf.py:247`` pins, to its 1e-12 s."""
    t = TLed.PerfLedger()
    for _, seq in sorted(_SEQUENCES.items()):
        for row in _feed(t, seq):
            parts = (row["compute_s"] + row["exposed_comm_s"]
                     + row["host_input_s"] + row["stall_s"])
            assert abs(parts - row["step_time_s"]) <= 1e-12


@pytest.mark.parametrize("kw", [dict(link="warp-drive"),
                                dict(overlap_fraction=2.0),
                                dict(zero_model={"world": 8}),
                                dict(layout_model={"n_params": 3})])
def test_configure_validation_matches_jax(kw):
    assert _outcome(TLed.PerfLedger().configure, **kw) == \
        _outcome(JLed.PerfLedger().configure, **kw)


def test_unknown_chip_raises_where_jax_prices_a_v5e():
    """The port's departure: a chip the cost model has no peak for raises
    at ``configure``; the JAX ledger takes it and prices it as a v5e."""
    JLed.PerfLedger().configure(chip="a100")
    with pytest.raises(ValueError, match="unknown chip 'a100'"):
        TLed.PerfLedger().configure(chip="a100")
    led = TLed.PerfLedger()
    led.configure(chip="h100", flops_per_step=989e12)
    assert led.record_step(2.0)["compute_s"] == 1.0


class _FakeRuntime:
    def __init__(self, device, cross=1):
        self.device = torch.device(device)
        self._cross = cross
        self.knobs = TKnobs()
        self.core = None

    def cross_size(self):
        return self._cross


def test_chip_and_link_resolve_from_the_runtime(monkeypatch):
    """``resolve_chip``: ``cpu`` without a runtime or on a CPU runtime,
    ``h100`` on an H100, and a raise on any other card; ``resolve_link``:
    the knob when it names a class, else ``dcn`` across hosts, ``nvlink``
    on CUDA ranks of one host, ``loopback`` on the CPU."""
    from horovod_tpu_torch import perf
    assert TLed.resolve_chip() == "cpu"
    assert TLed.resolve_chip("cpu") == "cpu"
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "NVIDIA H100 80GB HBM3")
    assert TLed.resolve_chip("cuda:0") == "h100"
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "NVIDIA A100-SXM4-80GB")
    with pytest.raises(ValueError, match="A100"):
        TLed.resolve_chip("cuda:0")
    knobs = TKnobs()
    assert perf.resolve_link(knobs) == "loopback"
    assert perf.resolve_link(knobs, _FakeRuntime("cpu")) == "loopback"
    assert perf.resolve_link(knobs, _FakeRuntime("cuda:0")) == "nvlink"
    assert perf.resolve_link(knobs, _FakeRuntime("cuda:0", 2)) == "dcn"
    assert perf.resolve_link(TKnobs({"HOROVOD_PERF_LINK": "ici"}),
                             _FakeRuntime("cuda:0")) == "ici"


def test_timed_step_synchronizes_a_cuda_runtime(monkeypatch):
    """The port's departure: on a CUDA runtime ``timed_step`` waits for
    the device before it reads the clock on exit (once a step); on the
    CPU it does not touch CUDA."""
    from horovod_tpu_torch import runtime as R
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda d=None: calls.append(d))
    led = TLed.PerfLedger()
    led.configure(chip="cpu", link="loopback")
    monkeypatch.setattr(R, "_runtime", _FakeRuntime("cpu"))
    with led.timed_step() as t:
        pass
    assert calls == [] and t.row["step_time_s"] >= 0.0
    monkeypatch.setattr(R, "_runtime", _FakeRuntime("cuda:0"))
    with led.timed_step():
        pass
    assert calls == [torch.device("cuda:0")]
    with pytest.raises(KeyError):
        with led.timed_step():
            raise KeyError("a failed step records nothing")
    assert led.report()["steps"] == 2 and len(calls) == 1


def test_global_api_and_the_root_package():
    """``hvd.perf`` and ``hvd.perf_report()`` as ``horovod_tpu``'s."""
    import horovod_tpu as jhvd
    for mod, report in ((jhvd.perf, jhvd.perf_report),
                        (hvd.perf, hvd.perf_report)):
        mod.reset()
        with mod.timed_step():
            pass
        rep = report()
        assert rep["steps"] == 1 and rep["step_time_s"]["mean"] >= 0.0
        mod.reset()
        assert mod.report()["steps"] == 0


@pytest.mark.parametrize("knobs", [
    {}, {"HOROVOD_PERF_LINK": "wormhole"}, {"HOROVOD_PERF_LINK": "dcn"},
    {"HOROVOD_PERF_INTERVAL": -1.0}, {"HOROVOD_PERF_INTERVAL": 0.0},
    {"HOROVOD_PERF_INTERVAL": 0.5}])
def test_perf_knob_validation_matches_jax(knobs):
    from horovod_tpu.perf import validate_perf_knobs as jv
    from horovod_tpu_torch.perf import validate_perf_knobs as tv
    assert _outcome(tv, TKnobs(knobs)) == _outcome(jv, JKnobs(knobs))


def test_nvlink_is_a_link_the_port_takes():
    from horovod_tpu_torch.perf import validate_perf_knobs
    validate_perf_knobs(TKnobs({"HOROVOD_PERF_LINK": "nvlink"}))
    with pytest.raises(ValueError, match="HOROVOD_PERF_LINK"):
        hvd.init(device="cpu", HOROVOD_PERF_LINK="wormhole")
    assert not hvd.is_initialized()


def test_configure_from_overlap_gauges_matches_jax():
    from horovod_tpu.utils import metrics as JM
    from horovod_tpu_torch.utils import metrics as TM
    j, t = JLed.PerfLedger(), TLed.PerfLedger()
    for M, led in ((JM, j), (TM, t)):
        M.OVERLAP_EXPOSED_BYTES.set(0.0, plane="microbatch")
        M.OVERLAP_FRACTION.set(0.0, plane="microbatch")
        assert led.configure_from_overlap_gauges() is False
        M.OVERLAP_EXPOSED_BYTES.set(3e6, plane="microbatch")
        M.OVERLAP_FRACTION.set(0.5, plane="microbatch")
        assert led.configure_from_overlap_gauges() is True
        led.record_step(0.01)
    assert _untimed(t.report()) == _untimed(j.report())


# ------------------------------------------------------------ fleet merge
def _stored(reports):
    return {f"rank.{r}": json.dumps(dict(rep, rank=r)).encode()
            for r, rep in enumerate(reports)}


def _report(step_s, comp=None, mem=None):
    led = JLed.PerfLedger()
    if comp:
        led.configure(**comp)
    for _ in range(3):
        led.record_step(step_s)
    rep = led.report()
    if mem is not None:
        rep["memory"] = mem
    return rep


_COMM = dict(flops_per_step=1e6, comm_bytes_per_step=8e7, chip="cpu",
             link="loopback")
_MERGES = {
    "straggler": _stored([_report(0.01), _report(0.01), _report(0.05)]),
    "comm": dict(_stored([_report(0.01, _COMM), _report(0.011, _COMM)]),
                 **{"rank.2": b"{torn json"}),
    "empty": {},
    "one": _stored([_report(0.02)]),
    "memory": _stored([
        _report(0.01, mem={"measured": {"watermark": 0.2,
                                        "bytes_in_use": 10,
                                        "headroom_bytes": 40},
                           "model_drift_ratio": 1.1}),
        _report(0.012, mem={"measured": {"watermark": 0.7,
                                         "bytes_in_use": 70,
                                         "headroom_bytes": 30},
                            "model_drift_ratio": None})]),
    "no_steps": _stored([JLed.PerfLedger().report()] * 2),
}


@pytest.mark.parametrize("name", sorted(_MERGES))
@pytest.mark.parametrize("ratio", [1.5, 1.2])
def test_merge_perf_reports_matches_jax(name, ratio):
    assert _untimed(TLed.merge_perf_reports(_MERGES[name], ratio)) == \
        _untimed(JLed.merge_perf_reports(_MERGES[name], ratio))


@pytest.mark.parametrize("seed", range(6))
def test_local_verdict_matches_jax(seed):
    rng = np.random.RandomState(seed)
    for _ in range(50):
        v = rng.dirichlet(np.ones(4))
        if seed % 2:
            v[rng.randint(4)] = v.max()  # ties resolve alike
        fr = dict(zip(("compute_s", "exposed_comm_s", "host_input_s",
                       "stall_s"), map(float, v)))
        assert TLed.local_verdict(fr) == JLed.local_verdict(fr)


# ------------------------------------------------------------------- gate
def _art(value, metric="llama train tokens/sec/chip (cpu, run detail)",
         unit="tokens/sec/chip"):
    return {"metric": metric, "value": value, "unit": unit}


def _gate_matrix(G):
    """``tests/test_perf.py:410-487``'s scenarios, returning every result
    instead of asserting on it."""
    out = []
    a = _art(1.0, "llama train tokens/sec/chip (cpu, loss 5.9->5.0)")
    b = _art(2.0, "llama train tokens/sec/chip (v5e, loss 4.2->4.0)")
    out.append((G.metric_key(a), G.metric_key(b)))
    doc = G.empty_baseline()
    out.append(G.update_baseline(doc, [_art(v) for v in (100.0, 102.0,
                                                         98.0)]))
    for cur in ([_art(101.0)], [_art(50.0)], [_art(200.0)],
                [_art(5.0, metric="new mode", unit="GB/s")]):
        out.append(G.check_artifacts(doc, cur))
    doc = G.empty_baseline()
    art = {"metric": "step time", "value": 0.1, "unit": "seconds"}
    G.update_baseline(doc, [art])
    out += [G.check_artifacts(doc, [dict(art, value=0.25)]),
            G.check_artifacts(doc, [dict(art, value=0.05)])]
    doc = G.empty_baseline()
    G.update_baseline(doc, [_art(100.0)])
    out += [G.check_artifacts(doc, [_art(95.0)]),
            G.check_artifacts(doc, [_art(80.0)])]
    doc = G.empty_baseline()
    G.update_baseline(doc, [_art(v) for v in (80.0, 120.0, 100.0, 90.0,
                                              110.0)])
    out.append(G.check_artifacts(doc, [_art(75.0)]))
    doc = G.empty_baseline()
    for i in range(G.MAX_BASELINE_VALUES + 7):
        G.update_baseline(doc, [_art(float(i))])
    out.append(doc)
    invalid = {"metric": "BENCH_INVALID", "value": 0, "unit": "error"}
    doc = G.empty_baseline()
    out += [G.update_baseline(doc, [invalid]),
            G.check_artifacts(doc, [invalid])]
    out.append([G.higher_is_better(x) for x in (
        _art(1.0), art, {"unit": "bytes"}, {"unit": "x",
                                            "higher_is_better": False})])
    out.append([G.median_mad(v) for v in ([1.0], [3.0, 1.0],
                                          [5.0, 1.0, 2.0, 9.0])])
    out.append(_outcome(G.median_mad, []))
    for k in (2.0, 4.0):
        for rel in (0.0, 0.1, 0.5):
            out.append(G.compare([10.0, 11.0, 9.0, 10.5], [12.0, 12.5],
                                 higher_better=False, mad_k=k,
                                 min_rel_delta=rel))
    return out


def test_gate_matrix_matches_jax():
    """Exact: every key, verdict, band, ratio and baseline document."""
    got, want = _gate_matrix(TG), _gate_matrix(JG)
    assert got == want
    # and the JAX tests' own assertions on the port's results
    checks = got[2:6]
    assert [next(iter(r["results"].values()))["status"] for r in checks] \
        == ["pass", "regression", "improved", "no-baseline"]
    assert [r["failed"] for r in got[6:11]] == [True, False, False, True,
                                                False]
    assert len(next(iter(got[11]["entries"].values()))["values"]) == \
        TG.MAX_BASELINE_VALUES


def test_gate_files_and_command_line(tmp_path, capsys):
    """The baseline round trip, JSON and JSONL artifacts with sub-rows,
    and ``python -m horovod_tpu_torch.perf.gate`` check/update."""
    base = str(tmp_path / "baseline.json")
    arts = tmp_path / "a.json"
    arts.write_text(json.dumps(dict(_art(100.0), sub_rows=[
        {"metric": "ttft", "value": 0.2, "unit": "seconds"}])))
    jsonl = tmp_path / "b.jsonl"
    jsonl.write_text("\n".join(json.dumps(_art(v)) for v in (98.0, 102.0))
                     + "\nnot json\n")
    assert TG.load_artifacts([str(arts), str(jsonl)]) == \
        JG.load_artifacts([str(arts), str(jsonl)])
    assert TG.main(["update", "--baseline", base, str(arts),
                    str(jsonl)]) == 0
    doc = TG.load_baseline(base)
    assert doc == JG.load_baseline(base)
    slow = tmp_path / "slow.json"
    slow.write_text(json.dumps(_art(40.0)))
    assert TG.main(["check", "--baseline", base, str(arts)]) == 0
    assert TG.main(["check", "--baseline", base, str(slow)]) == 1
    out = capsys.readouterr()
    assert "REGRESSION" in out.out and "REGRESSION detected" in out.err
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"schema": "nope"}))
    with pytest.raises(ValueError, match="schema"):
        TG.load_baseline(str(bad))
    assert TG.main([]) == 2
    p = subprocess.run([sys.executable, "-m", "horovod_tpu_torch.perf.gate",
                        "check", "--baseline", base, str(slow)], cwd=REPO,
                       capture_output=True, text=True, timeout=60)
    assert p.returncode == 1 and "REGRESSION" in p.stdout


# ----------------------------------------------------------------- doctor
def _perf_views():
    zero = JLed.PerfLedger()
    zero.configure(flops_per_step=1e7, comm_bytes_per_step=1e5,
                   zero_model={"n_params": 1000, "world": 4, "level": 3})
    zero.record_step(0.01)
    lay = JLed.PerfLedger()
    lay.configure(flops_per_step=5e9, layout_model={
        "n_params": 10 ** 7, "world": 8, "dim": 512, "n_layers": 8,
        "n_heads": 8, "n_kv_heads": 4, "batch": 8, "seq": 256,
        "mem_cap_bytes": 1e9, "active": {"dp": 8, "tp": 1, "pp": 1}})
    lay.record_step(0.05)
    mem = {"source": "device", "measured": {
        "bytes_in_use": 3 << 30, "peak_bytes_in_use": 5 << 30,
        "cap_bytes": 80 << 30, "host_rss_bytes": 2 << 30,
        "watermark": 0.0375, "headroom_bytes": 77 << 30},
        "predicted_total_bytes": 4 << 30, "model_drift_ratio": 0.75,
        "planes": {"params": {"predicted_bytes": 1 << 30,
                              "attributed_bytes": 1 << 30},
                   "kv_pool": {"predicted_bytes": None,
                               "attributed_bytes": 1 << 29}},
        "native": {"rss_bytes": 1 << 20}, "kv_pool": None,
        "pressure_events": 1, "time": 0.0}
    ops = [{"name": "grad", "count": 3, "bytes": 192, "mean_us": 12.5,
            "max_us": 20}]
    with_mem = dict(_report(0.01, _COMM, mem), native_ops=ops)
    return {
        "straggler": JLed.merge_perf_reports(_MERGES["straggler"]),
        "comm": JLed.merge_perf_reports(_MERGES["comm"]),
        "empty": JLed.merge_perf_reports({}),
        "memory": JLed.merge_perf_reports(_MERGES["memory"]),
        "zero": JLed.merge_perf_reports(_stored([zero.report()])),
        "layout": JLed.merge_perf_reports(_stored([lay.report()])),
        "full": JLed.merge_perf_reports(_stored([with_mem, with_mem])),
    }


@pytest.mark.parametrize("name", sorted(_perf_views()))
def test_render_perf_matches_jax(name):
    view = _perf_views()[name]
    assert TD.render_perf(view) == JD.render_perf(view)


def test_load_perf_view_sources_match_jax(tmp_path):
    view = _perf_views()["straggler"]
    (tmp_path / "perf.json").write_text(json.dumps(view))
    single = tmp_path / "single.json"
    single.write_text(json.dumps(_report(0.02)))
    for src in (str(tmp_path / "perf.json"), str(tmp_path)):
        assert TD.render_perf(TD.load_perf_view(src)) == \
            JD.render_perf(JD.load_perf_view(src))
    t, j = TD.load_perf_view(str(single)), JD.load_perf_view(str(single))
    assert _untimed(t) == _untimed(j)
    assert "1 rank(s)" in TD.render_perf(t)


def _serve_views():
    from horovod_tpu_torch import serve
    from horovod_tpu_torch.models import llama
    cfg = llama.CONFIGS["tiny"]
    model = llama.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    eng = serve.ServeEngine(model, serve.ServeConfig(
        max_slots=2, max_seq_len=64, block_size=8, cache_blocks=24,
        prefill_chunk=16), device="cpu")
    eng.submit(list(range(1, 20)), 4)
    eng.submit(list(range(1, 12)), 3)
    eng.flush()
    engine = eng.stats()
    eng.close()
    router = {"pending": 2, "accepted": 9, "shed": 1, "draining": False,
              "shed_high": 8, "completed": 7}
    return {
        "engine": {"router": router, "journal": {"enabled": True,
                                                 "entries": 3},
                   "engine": engine},
        "bare": {"router": {}, "journal": {}},
        "alerts": {"router": {"pending": 0}, "journal": {"enabled": True},
                   "alerts": {"firing": 2, "critical": 1,
                              "rules": ["sentinel-nonfinite"]}},
        "shards": {"router": {}, "journal": {}, "kv_shards": [
            {"shard": 0, "port": 1, "alive": True, "requests": 9,
             "keys": 3, "scopes": ["metrics"]},
            {"shard": 1, "port": 2, "alive": False, "requests": 0,
             "keys": 0, "scopes": []}]},
        "replicas": {"router": dict(router, draining=True),
                     "journal": {"enabled": False},
                     "replicas": {"live": [0], "affinity": True,
                                  "affinity_hit_rate": 0.5,
                                  "affinity_hits": 2, "affinity_misses": 2,
                                  "redispatches": 1, "per_replica": {
                         "0": {"alive": True, "pending": 1},
                         "1": {"alive": False, "pending": 0}}},
                     "engines": {"0": engine}},
    }


@pytest.mark.parametrize("name", sorted(_serve_views()))
def test_render_serve_matches_jax(name):
    view = _serve_views()[name]
    assert TD.render_serve(view) == JD.render_serve(view)


_COMPONENTS = ("queue", "placement", "prefill", "handoff", "decode",
               "stream")
_RECORDS = {
    "done": {"rid": "req.000003", "status": "done",
             "finish_reason": "length", "wall_s": 1.25,
             "components": dict(zip(_COMPONENTS, (0.1, 0.01, 0.3, 0.0,
                                                  0.8, 0.04))),
             "prompt_tokens": 12, "max_new_tokens": 8, "n_tokens": 8,
             "ttft_s": 0.41, "placement_s": 0.01, "overattribution": 1.2,
             "attempts": [
                 {"replica": 0, "affinity_blocks": 2, "verdict": {
                     "kind": "affinity", "winner": 0, "candidates": [
                         {"replica": 0, "depth": 2, "queue_depth": 1},
                         {"replica": 1, "depth": 0, "queue_depth": 0,
                          "shed": True}]}},
                 {"replica": 1, "redispatched_from": 0,
                  "suppressed_tokens": 3, "resume_part": 3}],
             "trace": {"rid": "req.000003"}},
    "shed": {"rid": "req.000007", "status": "shed"},
    "timeout": {"rid": "req.000009", "status": "timeout",
                "prompt_tokens": 5, "max_new_tokens": 4,
                "attempts": [{"replica": 2}]},
    "odd": {"rid": "req.000010", "status": "queued"},
}


@pytest.mark.parametrize("name", sorted(_RECORDS))
def test_render_request_matches_jax(name):
    rec = _RECORDS[name]
    assert TD.render_request(rec) == JD.render_request(rec)
    view = {"records": list(_RECORDS.values())}
    assert TD.find_request(view, rec["rid"]) == \
        JD.find_request(view, rec["rid"])
    assert TD.find_request(view, "req.999999") is None


def test_doctor_command_line(tmp_path, capsys):
    """``launch doctor`` with ``--perf``, ``--serve`` and ``--request`` on
    saved views exits 0 with the JAX doctor's text; a missing file exits
    2; the postmortem path and ``--watch`` render now (the postmortem
    plane, item 4.3), so a directory without a postmortem.json and a perf
    view given to ``--watch`` are what they read, and exit as the JAX
    doctor exits on them."""
    from horovod_tpu_torch.runner import launch as TL
    perf = tmp_path / "perf.json"
    perf.write_text(json.dumps(_perf_views()["comm"]))
    stats = tmp_path / "stats.json"
    stats.write_text(json.dumps(_serve_views()["alerts"]))
    trace = tmp_path / "trace.json"
    trace.write_text(json.dumps({"records": list(_RECORDS.values())}))
    for args, render in (
            (["--perf", str(perf)],
             JD.render_perf(JD.load_perf_view(str(perf)))),
            (["--serve", str(stats)],
             JD.render_serve(json.loads(stats.read_text()))),
            (["--request", "req.000003", str(trace)],
             JD.render_request(_RECORDS["done"]))):
        assert TL.run_commandline(["doctor"] + args) == 0
        assert capsys.readouterr().out == render + "\n"
    assert TL.run_commandline(["doctor", "--perf", str(perf),
                               "--json"]) == 0
    assert json.loads(capsys.readouterr().out) == json.loads(
        perf.read_text())
    for args in (["--perf", str(tmp_path / "missing.json")],
                 ["--request", "req.424242", str(trace)]):
        assert TL.run_commandline(["doctor"] + args) == 2
    capsys.readouterr()
    assert TL.run_commandline(["doctor", str(tmp_path)]) == 2
    assert "postmortem.json" in capsys.readouterr().err
    assert TL.run_commandline(["doctor", "--watch", str(perf),
                               "--once"]) == 0
    got = capsys.readouterr().out
    assert JD.main(["--watch", str(perf), "--once"]) == 0
    assert got == capsys.readouterr().out


# --------------------------------------------------------------- profiler
def test_profiler_on_the_cpu(tmp_path):
    """A capture on a CPU runtime: a Chrome trace in ``logdir`` holding the
    ``HOROVOD_ALLREDUCE`` range of an eager collective, an
    ``annotate_function`` range and ``timed``'s, no CUDA kernels; one
    session at a time; a stop without a session raises."""
    from horovod_tpu_torch.ops import collectives
    from horovod_tpu_torch.utils import profiler
    hvd.init(device="cpu")
    try:
        @profiler.annotate_function
        def scaled(x):
            return x * 2

        with profiler.trace(str(tmp_path)):
            assert profiler.is_active()
            with pytest.raises(RuntimeError, match="already"):
                profiler.start(str(tmp_path))
            collectives.allreduce_([torch.ones(8)])
            scaled(torch.ones(3))
            out, us = profiler.timed(lambda: torch.ones(2) + 1)
        assert not profiler.is_active() and us > 0
        assert torch.equal(out, torch.full((2,), 2.0))
        path = profiler.last_trace_path
        assert os.path.dirname(path) == str(tmp_path)
        names = {e.get("name") for e in json.load(open(path))["traceEvents"]}
        assert {"HOROVOD_ALLREDUCE", "HOROVOD_EXEC"} <= names
        assert any("scaled" in str(n) for n in names)
        assert profiler.trace_kernels(path) == []
        with pytest.raises(RuntimeError, match="no session"):
            profiler.stop()
    finally:
        hvd.shutdown()


# -------------------------------------------------------------- native leg
def _op_stats_round_trip(B, ledger):
    hub = B.LoopbackHub(2)
    cores = [B.CoordinationCore.loopback(hub, r, cycle_ms=0.5)
             for r in range(2)]
    try:
        for i in range(3):
            for c in cores:
                # per-call unique suffixes collapse to one key
                c.submit(f"grad.noname.{i}", "f32:8:sum", B.OP_ALLREDUCE,
                         64)
            for c in cores:
                r = c.wait(10.0)
                assert r is not None and r.type == "OK", r
        stats = [c.op_stats() for c in cores]
        rows = ledger.native_op_stats(cores[0])
        return stats, rows
    finally:
        for c in cores:
            c.shutdown()
        time.sleep(0.3)
        for c in cores:
            c.close()
        hub.close()


def test_op_stats_c_api_round_trip():
    """``tests/test_perf.py:343-379`` on the port's core: one collapsed
    key, its count and bytes, the ledger's native rows; the schema equals
    the JAX core's (latencies differ run to run)."""
    stats, rows = _op_stats_round_trip(TB, TLed)
    jstats, jrows = _op_stats_round_trip(JB, JLed)
    for s in stats:
        assert set(s) == {"grad"}, s
        g = s["grad"]
        assert g["count"] == 3 and g["bytes"] == 3 * 64
        assert g["sum_us"] >= g["max_us"] > 0
    assert rows and rows[0]["name"] == "grad"
    assert rows[0]["mean_us"] == stats[0]["grad"]["sum_us"] / 3
    assert set(rows[0]) == set(jrows[0])
    assert {k: v for k, v in stats[0]["grad"].items()
            if k in ("count", "bytes")} == \
        {k: v for k, v in jstats[0]["grad"].items()
         if k in ("count", "bytes")}


def test_op_stats_distinct_names_and_the_snapshot_import():
    """``tests/test_perf.py:381-408``, and ``import_op_stats`` into the
    ``hvd_perf_native_op_*`` families as the JAX function imports."""
    from horovod_tpu_torch.utils import metrics as TM
    hub = TB.LoopbackHub(1)
    core = TB.CoordinationCore.loopback(hub, 0, cycle_ms=0.5)
    try:
        core.submit("a", "f32:4:sum", TB.OP_ALLREDUCE, 16)
        assert core.wait(10.0).type == "OK"
        core.submit("b", "f32:4:bcast", TB.OP_BROADCAST, 8)
        assert core.wait(10.0).type == "OK"
        stats = core.op_stats()
        assert set(stats) == {"a", "b"}, stats
        assert stats["a"]["bytes"] == 16 and stats["b"]["bytes"] == 8
        TLed.import_op_stats(core)
        assert TM.PERF_NATIVE_OP_BYTES.value(name="a") == 16
        assert TM.PERF_NATIVE_OP_US.value(name="b") == \
            stats["b"]["sum_us"]
        mem = core.mem()
        assert mem["version"] == 1 and mem["rss_bytes"] > 0
        assert {"trace_ring_bytes", "window_ring_bytes",
                "response_cache_bytes"} <= set(mem)
    finally:
        core.shutdown()
        time.sleep(0.2)
        core.close()
        hub.close()


# ---------------------------------------------------------------- launch
def _free_port() -> int:
    """A port below the ephemeral range, free when taken (``hold_ports``)."""
    return hold_ports(1).release()[0]


def test_two_rank_launch_serves_the_merged_perf_view(tmp_path):
    """``-np 2`` gloo ranks with ``HOROVOD_PERF=1``: ``GET /perf`` holds
    both ranks' reports and equals the JAX ``merge_perf_reports`` of the
    same KV bytes (time stamps dropped); each rank priced its three steps
    on the CPU and loopback; the port's doctor renders the saved view as
    the JAX doctor does."""
    worker = os.path.join(REPO, "tests", "torch_port",
                          "torch_port_perf_worker.py")
    env = dict(os.environ, OMP_NUM_THREADS="1", HOROVOD_PERF="1",
               HOROVOD_PERF_INTERVAL="60")
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    p = subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.runner.launch", "-np",
         "2", "--coordinator-port", str(_free_port()), "--controller-port",
         str(_free_port()), "--metrics-port", str(_free_port()),
         sys.executable, worker, str(tmp_path)], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        start_new_session=True)
    try:
        out, err = p.communicate(timeout=120)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        p.communicate()
        pytest.fail("the launch did not end in 120 s")
    assert p.returncode == 0, err.decode()[-3000:]
    got = json.load(open(tmp_path / "perf.json"))
    served = got["served"]
    raw = {k: v.encode() for k, v in got["raw"].items()}
    assert _untimed(served) == _untimed(JLed.merge_perf_reports(raw))
    assert sorted(served["ranks"]) == ["0", "1"]
    for r, rep in served["ranks"].items():
        assert rep["steps"] == 3 and rep["rank"] == int(r)
        assert rep["model"]["chip"] == "cpu"
        assert rep["model"]["link"] == "loopback"
        assert rep["model"]["flops_per_step"] == 2e6
    assert served["fleet"]["ranks"] == 2
    assert served["fleet"]["verdict"] in JLed.VERDICTS
    view = tmp_path / "view.json"
    view.write_text(json.dumps(served))
    assert TD.render_perf(TD.load_perf_view(str(view))) == \
        JD.render_perf(JD.load_perf_view(str(view)))


# ------------------------------------------------ chip_smoke's rehearsal
_REHEARSAL = """
import sys
import numpy as np
import torch
sys.path.insert(0, {repo!r})
import chip_smoke as C
import horovod_tpu_torch as hvd
from horovod_tpu_torch.models import llama
from horovod_tpu_torch.ops import flash_attention as F
torch.set_num_threads(1)
if {part!r} == "phase":
    # phase 5's losses on this small configuration, as the reference
    hvd.init(device="cpu")
    cfg = llama.CONFIGS["tiny"]
    model = llama.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=0.01),
        named_parameters=model.named_parameters())
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    hvd.broadcast_optimizer_state(opt, root_rank=0)
    step = hvd.make_train_step(model, lambda m, ids: llama.loss_fn(
        m, ids, attn_fn=hvd.flash_attention, ce_chunks=8), opt)
    rng = np.random.RandomState(0)
    losses = [float(step(torch.from_numpy(rng.randint(
        0, cfg.vocab, (2, 65), dtype=np.int32))))
        for _ in range(C.MEASURE_STEPS)]
    hvd.shutdown()
    out = C.phase_perf(torch, np, hvd, llama, F, "CPU", losses, 1.0,
                       device_type="cpu", cfg_name="tiny", batch=2, seq=64)
    assert out == {{name: 0 for name in C.REPLACES}}, out
else:
    C.rank_perf(torch, 2, "CPU", device_type="cpu", cfg_name="tiny",
                batch=1, seq=64)
print("REHEARSAL-OK", flush=True)
"""


@pytest.mark.parametrize("part", ["phase", "ranks"])
def test_chip_smoke_perf_rehearsal_on_cpu(part):
    """``chip_smoke.py`` phase 16 (the ledger's rows summing to the step,
    host input from ``prefetch``, the memory sample, the profiler's trace,
    ``compiled_flops``; losses bitwise phase 5's) and ``--ranks N --parts
    perf`` (two gloo ranks at ZeRO level 3 under the launcher: the
    sharded-bytes gauges, ``GET /perf`` over both ranks, the doctor, equal
    parameters), with ``tiny`` standing in for ``1b``: every check of the
    card's run but the kernels'."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    p = subprocess.Popen([sys.executable, "-c", _REHEARSAL.format(
        repo=REPO, part=part)], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, start_new_session=True)
    try:
        out, err = p.communicate(timeout=150)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        out, err = p.communicate()
        pytest.fail(f"the rehearsal did not end in 150 s: "
                    f"{err.decode()[-3000:]}")
    out, err = out.decode(), err.decode()
    assert p.returncode == 0 and "REHEARSAL-OK" in out, (out[-3000:],
                                                         err[-3000:])
    if part == "phase":
        assert "bitwise phase 5's: True" in out
        assert "memory: source live_buffers" in out
        assert "compiled_flops" in out
    else:
        assert "GET /perf 2 ranks" in out
        assert "launch doctor --perf exit 0" in out
