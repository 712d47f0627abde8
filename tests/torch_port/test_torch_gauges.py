"""The planes' gauges and instants (``ops/wire.py``, ``ops/overlap.py``,
``parallel/zero.py``, ``parallel/layout.py``, ``optimizer.py``) and
``prefetch``'s input wait, against the JAX package's registry on the same
plans.  Tolerances: exact (``==``) throughout.  Each comparison reads the
change a call makes to each package's own process-global registry.

  * wire: ``plan_formats`` counts buckets and modeled bytes saved by format
    as the JAX function does at every layout and policy; through the
    optimizer the registry counts once per distinct plan and policy (the port's
    counterpart of a trace), so N synced steps read what one traced JAX
    step reads, while ``wire.stats()`` keeps counting every sync;
    ``wire_residual_report`` sets its gauge;
  * overlap: ``microbatch_overlap_model`` and ``record_overlap`` set the
    ``hvd_overlap_*`` gauges as the JAX trace does, and the optimizer's
    pipeline runs the model once a cycle;
  * ZeRO levels 1-3: the gauges and the ``zeroN`` overlap split of a built
    chain equal the JAX chain's trace-time record of the same plan;
  * layout: ``resolve_layout("auto")`` sets the three gauges as the JAX
    function does;
  * the instants land on the runtime's timeline: ``wire.encode.<fmt>``
    once per plan, ``overlap.sync.*`` once per plan and depth,
    ``zero.bucket.{ag,rs,free}`` once per built chain;
  * ``prefetch`` feeds the ledger's host-input leg
    (``tests/test_perf.py:322``).
"""

import os
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import jax  # noqa: E402
from jax.sharding import Mesh, PartitionSpec as P  # noqa: E402

from horovod_tpu import optimizer as JO  # noqa: E402
from horovod_tpu.common.reduce_op import ReduceOp as JR  # noqa: E402
from horovod_tpu.ops import fusion as JF  # noqa: E402
from horovod_tpu.ops import overlap as JOv  # noqa: E402
from horovod_tpu.ops import wire as JW  # noqa: E402
from horovod_tpu.ops._compat import shard_map  # noqa: E402
from horovod_tpu.parallel import layout as JLay  # noqa: E402
from horovod_tpu.parallel import zero as JZ  # noqa: E402
from horovod_tpu.perf import ledger as JLed  # noqa: E402
from horovod_tpu.utils import metrics as JM  # noqa: E402

import horovod_tpu_torch as hvd  # noqa: E402
from horovod_tpu_torch import optimizer as TO  # noqa: E402
from horovod_tpu_torch.common.reduce_op import ReduceOp as TR  # noqa: E402
from horovod_tpu_torch.ops import fusion as TF  # noqa: E402
from horovod_tpu_torch.ops import overlap as TOv  # noqa: E402
from horovod_tpu_torch.ops import wire as TW  # noqa: E402
from horovod_tpu_torch.parallel import layout as TLay  # noqa: E402
from horovod_tpu_torch.parallel import zero as TZ  # noqa: E402
from horovod_tpu_torch.perf import ledger as TLed  # noqa: E402
from horovod_tpu_torch.utils import metrics as TM  # noqa: E402
from horovod_tpu_torch.utils.timeline import load_trace_events  # noqa

FORMATS = ("none", "bf16", "fp16", "int8_ring", "dcn_int8")
SHAPES = [(1 << 20,), (256,), (64,), (300, 700), (5,), (2 << 20,),
          (4096, 33)]
THRESHOLD = 4 << 20


def _wire_values(M):
    return ({f: M.WIRE_BUCKETS.value(format=f) for f in FORMATS},
            {f: M.WIRE_BYTES_SAVED.value(format=f) for f in FORMATS})


def _delta(M, values, fn):
    """``fn()``'s result and the change it made to ``values(M)``."""
    before = values(M)
    out = fn()
    after = values(M)
    return out, tuple({k: a[k] - b[k] for k in a}
                      for a, b in zip(after, before))


@pytest.fixture(autouse=True)
def _no_runtime():
    hvd.shutdown()
    yield
    hvd.shutdown()


# ------------------------------------------------------------------- wire
@pytest.mark.parametrize("policy", ["none", "bf16", "fp16", "int8_ring",
                                    "dcn_int8", "auto"])
@pytest.mark.parametrize("sizes", [{"flat": 1}, {"flat": 4},
                                   {"dcn": 2, "ici": 2}])
@pytest.mark.parametrize("op", ["AVERAGE", "MAX"])
def test_plan_formats_counts_as_jax(policy, sizes, op):
    """The same shapes planned by each package, decided by each package's
    policy, counted into each registry: equal formats and deltas."""
    t_plan = TF.make_plan(SHAPES, [torch.float32] * len(SHAPES), THRESHOLD)
    j_plan = JF.make_plan(SHAPES, [np.float32] * len(SHAPES), THRESHOLD)
    axis = ("dcn.data", "ici.data") if "dcn" in sizes else "data"
    got = _delta(TM, _wire_values, lambda: TW.plan_formats(
        t_plan, TW.get_policy(policy), getattr(TR, op), axis_sizes=sizes))
    want = _delta(JM, _wire_values, lambda: JW.plan_formats(
        j_plan, JW.get_policy(policy), axis, getattr(JR, op),
        axis_sizes=sizes))
    assert got == want


def _jax_traced_sync(leaves, n, policy):
    """One JAX ``sync_gradients`` traced under ``shard_map`` on an
    ``n``-device mesh (a trace: what a compiled step counts)."""
    mesh = Mesh(np.array(jax.devices()[:n]), ("hvd",))

    def body(*g):
        return tuple(JO.sync_gradients(list(g), "hvd", wire_policy=policy,
                                       fusion_threshold_bytes=THRESHOLD))
    jax.make_jaxpr(shard_map(body, mesh=mesh,
                             in_specs=(P(),) * len(leaves),
                             out_specs=(P(),) * len(leaves),
                             check_vma=False))(*leaves)


@pytest.mark.parametrize("policy", ["none", "auto"])
def test_optimizer_counts_once_per_plan(policy):
    """Three synced steps of the port at one rank count into the registry
    what one traced JAX step counts on a one-device mesh (every bucket
    ``none``), and ``wire.stats()`` still counts all three syncs."""
    hvd.init(device="cpu")
    shapes = [(3, 1000), (17,), (40, 40), (123457,), (9,)]
    params = [torch.nn.Parameter(torch.zeros(s)) for s in shapes]
    n_buckets = len(TF.make_plan(shapes, [torch.float32] * len(shapes),
                                 THRESHOLD).buckets)
    stats0 = TW.stats()["buckets"].get("none", 0)

    def three_steps():
        for i in range(3):
            for p in params:
                p.grad = torch.full_like(p, float(i))
            hvd.sync_gradients(params, wire_policy=policy,
                               fusion_threshold_bytes=THRESHOLD)
    _, got = _delta(TM, _wire_values, three_steps)
    leaves = [jax.numpy.zeros(s, np.float32) for s in shapes]
    _, want = _delta(JM, _wire_values,
                     lambda: _jax_traced_sync(leaves, 1, policy))
    assert got == want and got[0]["none"] == n_buckets
    assert TW.stats()["buckets"]["none"] - stats0 == 3 * n_buckets
    # a new plan (another threshold) is a new trace; the same plan again
    # is not
    for threshold, counted in ((100_000, 3), (100_000, 0),
                               (THRESHOLD, 0)):
        _, again = _delta(TM, _wire_values, lambda: hvd.sync_gradients(
            params, wire_policy=policy, fusion_threshold_bytes=threshold))
        assert again[0]["none"] == counted


def test_wire_residual_report_sets_its_gauge_as_jax():
    rng = np.random.RandomState(3)
    arrays = [rng.randn(*s).astype(np.float32) for s in
              [(40,), (3, 7), (1000,)]]
    plan_t = TF.make_plan([a.shape for a in arrays],
                          [torch.float32] * 3, 1024)
    plan_j = JF.make_plan([a.shape for a in arrays], [np.float32] * 3, 1024)
    for plan_pair in ((plan_t, plan_j), (None, None)):
        got = TO.wire_residual_report([torch.from_numpy(a) for a in arrays],
                                      plan_pair[0])
        want = JO.wire_residual_report(arrays, plan_pair[1])
        assert got == want
        for label, norm in got.items():
            assert TM.WIRE_RESIDUAL_NORM.value(bucket=label) == \
                JM.WIRE_RESIDUAL_NORM.value(bucket=label) == norm


# ---------------------------------------------------------------- overlap
def _overlap_values(M, planes=("microbatch",)):
    return tuple(tuple((M.OVERLAP_EXPOSED_BYTES.value(plane=p),
                        M.OVERLAP_FRACTION.value(plane=p)) for p in planes))


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("k,depth", [(2, 1), (4, 1), (4, 2), (3, 0),
                                     (4, 4)])
def test_microbatch_overlap_model_matches_jax(n, k, depth):
    """The model traced in JAX on an ``n``-device axis and the port's on a
    flat layout of ``n`` ranks: the same dict and the same gauges."""
    shapes = [(3, 1000), (17,), (123457,)]
    got = TOv.microbatch_overlap_model(
        [torch.zeros(s) for s in shapes], k, depth, axis_sizes={"flat": n})
    t_gauges = _overlap_values(TM)
    mesh = Mesh(np.array(jax.devices()[:n]), ("hvd",))
    seen = {}

    def body(x):
        seen["out"] = JOv.microbatch_overlap_model(
            [jax.numpy.zeros(s) for s in shapes], "hvd", k, depth)
        return x
    jax.make_jaxpr(shard_map(body, mesh=mesh, in_specs=P(), out_specs=P(),
                             check_vma=False))(jax.numpy.zeros(2))
    assert got == seen["out"]
    assert t_gauges == _overlap_values(JM)


@pytest.mark.parametrize("total,exposed", [(0.0, 0.0), (100.0, 25.0),
                                           (8.0, 9.0), (1e9, 0.0)])
def test_record_overlap_matches_jax(total, exposed):
    assert TOv.record_overlap(total, exposed, "zero2") == \
        JOv.record_overlap(total, exposed, "zero2")
    assert _overlap_values(TM, ("zero2",)) == _overlap_values(JM, ("zero2",))


def test_pipelined_optimizer_records_its_model_once_a_cycle(tmp_path):
    """``DistributedOptimizer(backward_passes_per_step=2, overlap=True)``
    at one rank: the microbatch gauges after its cycles equal the model's,
    and the timeline holds one ``overlap.sync.*`` instant a microbatch of
    the first cycle, not of every cycle."""
    hvd.init(device="cpu")
    path = str(tmp_path / "trace.json")
    hvd.start_timeline(path)
    model = torch.nn.Linear(30, 20)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1),
        named_parameters=model.named_parameters(),
        backward_passes_per_step=2, overlap=True, overlap_depth=1)
    TM.OVERLAP_EXPOSED_BYTES.set(-1.0, plane="microbatch")
    for _ in range(3):  # three cycles of two microbatches
        for _ in range(2):
            model(torch.ones(4, 30)).sum().backward()
            opt.step()
    want = TOv.record_overlap(0.0, 0.0, "microbatch")  # one rank moves 0
    assert _overlap_values(TM) == ((want["exposed_bytes"],
                                    want["overlapped_fraction"]),)
    hvd.stop_timeline()
    names = [e["name"] for e in load_trace_events(path)
             if str(e.get("name", "")).startswith("overlap.sync.")]
    assert names == ["overlap.sync.issue", "overlap.sync.flush"]


# ------------------------------------------------------------------- ZeRO
ZERO_KINDS = ("params", "grads", "ef_residual")


def _zero_values(M, level):
    return (M.ZERO_LEVEL.value(), M.ZERO_AG_PREFETCH.value(),
            tuple(M.ZERO_SHARDED_BYTES.value(kind=k) for k in ZERO_KINDS),
            _overlap_values(M, (f"zero{level}",)))


@pytest.mark.parametrize("level", [1, 2, 3])
@pytest.mark.parametrize("n,k,depth,wire", [
    (1, 1, 2, "none"), (2, 1, 2, "none"), (4, 2, 1, "bf16"),
    (4, 1, 3, "int8_ring"), (3, 4, 2, "none")])
def test_zero_trace_record_matches_jax(level, n, k, depth, wire):
    """The record of one chain (the JAX chain's trace, the port's build) of
    the same plan, order, formats, level, ranks, microbatches, prefetch
    depth and error feedback: the same gauges."""
    t_plan = TF.make_plan(SHAPES, [torch.float32] * len(SHAPES), THRESHOLD)
    j_plan = JF.make_plan(SHAPES, [np.float32] * len(SHAPES), THRESHOLD)
    order = TOv.priority_order(t_plan)
    assert order == JOv.priority_order(j_plan)
    formats = ["none" if i % 2 else wire for i in range(len(order))]
    ef = wire != "none"
    pbytes = sum(int(np.prod(s)) * 4 for s in SHAPES)
    TZ._record_zero_trace(t_plan, order, formats, level, n, k, depth, ef,
                          pbytes)
    JZ._record_zero_trace(j_plan, order, formats, level, n, k, depth, ef,
                          [], pbytes)
    assert _zero_values(TM, level) == _zero_values(JM, level)


class _Tiny(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.a = torch.nn.Linear(64, 300)
        self.b = torch.nn.Linear(300, 7)

    def forward(self, x):
        return self.b(torch.relu(self.a(x)))


@pytest.mark.parametrize("level", [1, 2, 3])
def test_zero_step_sets_the_gauges_and_instants(tmp_path, level):
    """A built and stepped chain at one rank: its gauges equal the JAX
    chain's record of the same plan (``_record_zero_trace`` at one rank),
    ``opt_state`` holds the optimizer's state bytes after the first step,
    and the timeline holds the schedule's instants once."""
    hvd.init(device="cpu")
    path = str(tmp_path / "trace.json")
    hvd.start_timeline(path)
    torch.manual_seed(0)
    model = _Tiny()
    leaves = list(model.parameters())
    pbytes = sum(p.numel() * 4 for p in leaves)
    state = TZ.init_zero_state(torch.optim.AdamW, model, zero_level=level,
                               fusion_threshold_bytes=40_000, lr=1e-3)
    step = TZ.make_zero_train_step(
        model, lambda m, x: m(x).square().mean(), state, zero_level=level,
        fusion_threshold_bytes=40_000, ag_prefetch=2)
    for _ in range(2):
        step(torch.ones(5, 64))
    plan = TZ._bucket_plan(leaves, 40_000)
    j_plan = JF.make_plan([tuple(p.shape) for p in leaves],
                          [np.float32] * len(leaves), 40_000)
    order = TOv.priority_order(plan)
    JZ._record_zero_trace(j_plan, order, ["none"] * len(plan.buckets),
                          level, 1, 1, 2 if level == 3 else 0, False, [],
                          pbytes)
    assert _zero_values(TM, level) == _zero_values(JM, level)
    want_state = sum(2 * s.numel() * 4 + 4 for s in state.shards)
    assert TM.ZERO_SHARDED_BYTES.value(kind="opt_state") == want_state
    hvd.stop_timeline()
    names = [e["name"] for e in load_trace_events(path)
             if str(e.get("name", "")).startswith("zero.bucket.")]
    nb = len(plan.buckets)
    expect = (["zero.bucket.ag", "zero.bucket.free"] * nb
              if level == 3 else []) + ["zero.bucket.rs"] * nb
    assert names == expect


# ----------------------------------------------------------------- layout
def _layout_values(M):
    return (M.LAYOUT_CANDIDATES.value(), M.LAYOUT_CHOSEN_RANK.value(),
            M.LAYOUT_PREDICTED_STEP.value())


@pytest.mark.parametrize("world,tp,pp,model", [
    (8, 1, 1, None), (4, 2, 1, None), (8, 1, 2, None),
    (8, 1, 1, dict(n_params=10 ** 8, dim=1024, n_layers=8, n_heads=16,
                   n_kv_heads=8, batch=16, seq=512,
                   flops_per_step=6e8 * 16 * 512)),
    (4, 1, 1, dict(n_params=10 ** 9, dim=2048, n_layers=16, n_heads=32,
                   n_kv_heads=8, batch=8, seq=2048,
                   flops_per_step=6e9 * 8 * 2048))])
def test_resolve_layout_auto_sets_the_gauges_as_jax(world, tp, pp, model):
    knobs = {"HOROVOD_LAYOUT": "auto", "HOROVOD_TP": tp, "HOROVOD_PP": pp,
             "HOROVOD_ZERO_LEVEL": 1}
    got = TLay.resolve_layout(world, knobs, model=model)
    want = JLay.resolve_layout(world, knobs, model=model)
    assert got == want
    assert _layout_values(TM) == _layout_values(JM)


# ----------------------------------------------------------------- wire's
def test_wire_instants_once_per_plan(tmp_path):
    """``wire.encode.<fmt>`` once a bucket of a plan, not once a sync."""
    hvd.init(device="cpu")
    path = str(tmp_path / "trace.json")
    hvd.start_timeline(path)
    shapes = [(500, 3), (8,), (33000,)]
    params = [torch.nn.Parameter(torch.ones(s)) for s in shapes]
    for _ in range(3):
        for p in params:
            p.grad = torch.ones_like(p)
        hvd.sync_gradients(params, fusion_threshold_bytes=60_000)
    hvd.stop_timeline()
    events = [e for e in load_trace_events(path)
              if str(e.get("name", "")).startswith("wire.encode.")]
    plan = TF.make_plan(shapes, [torch.float32] * 3, 60_000)
    assert [e["name"] for e in events] == \
        ["wire.encode.none"] * len(plan.buckets)
    assert [e["args"] for e in events] == [
        {"bucket": i, "nbytes": b.nbytes} for i, b in enumerate(plan.buckets)]


# ---------------------------------------------------------------- prefetch
def test_prefetch_accounts_input_wait():
    """``prefetch`` feeds the ledger's host-input leg with the time spent
    pulling and staging batches (``tests/test_perf.py:322``)."""
    TLed.reset()

    def slow_batches():
        for i in range(3):
            time.sleep(0.005)
            yield i

    out = list(hvd.prefetch(slow_batches(), depth=1, transfer=lambda b: b))
    assert out == [0, 1, 2]
    row = hvd.perf.record_step(1.0)
    assert row["host_input_s"] >= 0.015
    assert hvd.perf.record_step(1.0)["host_input_s"] == 0.0
    TLed.reset()


def test_prefetch_input_wait_matches_jax_in_kind():
    """Both loaders account the same waits: a batch that costs nothing to
    pull accounts (nearly) nothing, a slow source its sleeps; and a broken
    ledger never breaks the loader."""
    from horovod_tpu.data.loader import prefetch as jprefetch
    for fetch, mod in ((hvd.prefetch, TLed), (jprefetch, JLed)):
        mod.reset()
        assert list(fetch(iter(range(4)), depth=2,
                          transfer=lambda b: b)) == [0, 1, 2, 3]
        assert mod.record_step(1.0)["host_input_s"] < 0.01
        mod.reset()
    orig = TLed.add_input_wait
    try:
        TLed.add_input_wait = None  # not callable: accounting fails
        assert list(hvd.prefetch(iter([1, 2]), depth=1,
                                 transfer=lambda b: b)) == [1, 2]
    finally:
        TLed.add_input_wait = orig
