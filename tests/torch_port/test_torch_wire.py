"""The wire and overlap planes against the JAX package in one process: the
pure functions (policy names, ``auto_policy``, ``resolve_format``, the
byte model, ``plan_formats``, ``priority_order``,
``microbatch_overlap_model``) compared exactly over grids of sizes,
dtypes, reduce ops and layouts; the int8 and cast codecs bitwise; and the
optimizer's one-rank behaviour (the knobs, the pipeline's switches, error
feedback's state).  The four-rank parity of the collectives is
``test_torch_wire_gloo.py``."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from horovod_tpu.common import knobs as JK
from horovod_tpu.common.reduce_op import ReduceOp as JOp
from horovod_tpu.ops import compression as JC
from horovod_tpu.ops import fusion as JF
from horovod_tpu.ops import overlap as JO
from horovod_tpu.ops import quantized as JQ
from horovod_tpu.ops import wire as JW
from horovod_tpu.ops._compat import shard_map

import horovod_tpu_torch as hvd
from horovod_tpu_torch.common import knobs as TK
from horovod_tpu_torch.common.reduce_op import ReduceOp as TOp
from horovod_tpu_torch.models import llama as TL
from horovod_tpu_torch.ops import compression as TC
from horovod_tpu_torch.ops import fusion as TF
from horovod_tpu_torch.ops import overlap as TO
from horovod_tpu_torch.ops import quantized as TQ
from horovod_tpu_torch.ops import wire as TW

# (JAX axis name, port layout) of the four-rank layouts
LAYOUTS = {"flat": ("hvd", {"flat": 4}),
           "two_level": (("dcn.data", "ici.data"), {"dcn": 2, "ici": 2})}
DTYPES = [("float32", jnp.float32, torch.float32),
          ("bfloat16", jnp.bfloat16, torch.bfloat16),
          ("float16", jnp.float16, torch.float16),
          ("float64", jnp.float64, torch.float64),
          ("int32", jnp.int32, torch.int32),
          ("int8", jnp.int8, torch.int8)]
OPS = ["AVERAGE", "SUM", "MIN", "MAX", "PRODUCT", "ADASUM"]
NBYTES = [0, 1024, 64 * 1024 - 1, 64 * 1024, 1 << 20, 4 * 1024 * 1024 - 1,
          4 * 1024 * 1024, 64 << 20]


@pytest.fixture
def runtime():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    hvd.init(device="cpu")
    yield hvd
    hvd.shutdown()
    # later files in this process (one xdist worker runs many) keep their
    # thread count
    torch.set_num_threads(threads)


def _raises_same(jfn, tfn):
    """Both return the same value, or both raise ValueError."""
    try:
        want = jfn()
    except ValueError:
        with pytest.raises(ValueError):
            tfn()
        return
    assert tfn() == want


# ------------------------------------------------------------ pure functions
def test_knob_defaults_match_jax():
    for name in ("HOROVOD_WIRE_POLICY", "HOROVOD_WIRE_EF", "HOROVOD_OVERLAP",
                 "HOROVOD_OVERLAP_DEPTH", "HOROVOD_HIERARCHICAL_ALLREDUCE",
                 "HOROVOD_HIERARCHICAL_ALLGATHER"):
        assert TK.KNOBS[name].default == JK.KNOBS[name].default, name
    assert TO.MAX_OVERLAP_DEPTH == JO.MAX_OVERLAP_DEPTH
    for name in ("FORMAT_NAMES", "POLICY_NAMES", "LOSSY_FORMATS",
                 "SMALL_BUCKET_BYTES", "INT8_MIN_BYTES"):
        assert getattr(TW, name) == getattr(JW, name), name


@pytest.mark.parametrize("name", list(JW.POLICY_NAMES) + ["int9", "gzip", ""])
def test_validate_policy_name(name):
    _raises_same(lambda: JW.validate_policy_name(name),
                 lambda: TW.validate_policy_name(name))


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_auto_policy_grid(layout):
    axis, sizes = LAYOUTS[layout]
    for nbytes, (_, jdt, tdt) in itertools.product(NBYTES, DTYPES):
        assert TW.auto_policy(nbytes, tdt, sizes) == \
            JW.auto_policy(nbytes, jdt, axis), (nbytes, jdt)
        for name in JW.POLICY_NAMES:
            assert TW.get_policy(name)(nbytes, tdt, sizes) == \
                JW.get_policy(name)(nbytes, jdt, axis)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_resolve_format_grid(layout):
    axis, sizes = LAYOUTS[layout]
    for fmt, (_, jdt, tdt), op in itertools.product(
            list(JW.FORMAT_NAMES) + ["auto", "int4"], DTYPES, OPS):
        _raises_same(
            lambda: JW.resolve_format(fmt, jdt, axis, getattr(JOp, op)),
            lambda: TW.resolve_format(fmt, tdt, sizes, getattr(TOp, op)))
    for fmt in JW.FORMAT_NAMES:
        assert TW.is_lossy(fmt) == JW.is_lossy(fmt)


SIZES = [{"flat": 1}, {"flat": 2}, {"flat": 4}, {"flat": 8},
         {"dcn": 2, "ici": 2}, {"dcn": 2, "ici": 4}, {"dcn": 4, "ici": 8},
         {"dcn": 1, "ici": 4}]


def test_modeled_wire_bytes_grid():
    for nelems, itemsize, fmt, sizes in itertools.product(
            [0, 1, 7, 1000, 1 << 20, 3 * (1 << 20) + 5], [2, 4],
            JW.FORMAT_NAMES, SIZES):
        assert TW.modeled_wire_bytes(nelems, itemsize, fmt, sizes) == \
            JW.modeled_wire_bytes(nelems, itemsize, fmt, sizes)


def test_wire_byte_model_ratios():
    """``tests/test_wire.py``'s ratios on the port's model: int8 <= 1/2
    bf16 <= 1/4 fp32, and dcn_int8's cross-host bytes below the flat int8
    ring's on a two-level layout."""
    flat, nelems = {"flat": 8}, 1 << 20
    f32 = TW.modeled_wire_bytes(nelems, 4, "none", flat)["bottleneck"]
    b16 = TW.modeled_wire_bytes(nelems, 4, "bf16", flat)["bottleneck"]
    i8 = TW.modeled_wire_bytes(nelems, 4, "int8_ring", flat)["bottleneck"]
    assert i8 <= b16 / 2 <= f32 / 4
    hier = {"ici": 4, "dcn": 2}
    d8 = TW.modeled_wire_bytes(nelems, 4, "dcn_int8", hier)
    i8h = TW.modeled_wire_bytes(nelems, 4, "int8_ring", hier)
    assert d8["bottleneck"] < i8h["bottleneck"]
    assert set(d8["per_fabric"]) == {"ici", "dcn"}
    assert TW.modeled_wire_bytes(64, 4, "none", {"flat": 1})[
        "bottleneck"] == 0


# leaf lists (shape, dtype name) and thresholds the plans are made from
PLANS = [
    ([((41,), "float32"), ((3, 7), "float32"), ((200,), "float32"),
      ((5,), "float32"), ((64,), "float32"), ((33,), "bfloat16")], 256),
    ([((1 << 20,), "float32"), ((32768,), "float32"), ((10,), "float32"),
      ((4096, 512), "bfloat16"), ((7,), "int32")], 1),
    ([((1 << 20,), "float32"), ((32768,), "float32"), ((10,), "float32"),
      ((4096, 512), "bfloat16"), ((7,), "int32")], 128 * 1024 * 1024),
    ([((300, 300), "float16"), ((2,), "float64")], 4096),
]
JDT = {n: j for n, j, _ in DTYPES}
TDT = {n: t for n, _, t in DTYPES}


def _plans(leaves, threshold):
    shapes = [s for s, _ in leaves]
    return (JF.make_plan(shapes, [JDT[d] for _, d in leaves], threshold),
            TF.make_plan(shapes, [TDT[d] for _, d in leaves], threshold))


@pytest.mark.parametrize("plan_idx", range(len(PLANS)))
def test_plan_formats_and_priority_order(plan_idx):
    jplan, tplan = _plans(*PLANS[plan_idx])
    assert [b.indices for b in tplan.buckets] == \
        [b.indices for b in jplan.buckets]
    assert TO.priority_order(tplan) == JO.priority_order(jplan)
    grid = itertools.product(LAYOUTS.values(), JW.POLICY_NAMES,
                             ["AVERAGE", "SUM", "MAX"])
    for (axis, sizes), policy, op in grid:
        for ranks in (sizes, {"flat": 1}):  # one rank forces none
            assert TW.plan_formats(tplan, TW.get_policy(policy),
                                   getattr(TOp, op), axis_sizes=ranks) == \
                JW.plan_formats(jplan, JW.get_policy(policy), axis,
                                getattr(JOp, op), axis_sizes=ranks)


def test_plan_formats_counts_into_stats():
    _, tplan = _plans(*PLANS[1])
    before = TW.stats()
    fmts = TW.plan_formats(tplan, TW.auto_policy, TOp.AVERAGE,
                           axis_sizes={"flat": 4})
    after = TW.stats()
    assert fmts == ["int8_ring", "bf16", "none", "int8_ring", "none"]
    for fmt in set(fmts):
        assert after["buckets"][fmt] - before["buckets"].get(fmt, 0) == \
            fmts.count(fmt)
    saved = (JW.modeled_wire_bytes(1 << 20, 4, "none", {"flat": 4})
             ["bottleneck"] - JW.modeled_wire_bytes(
                 1 << 20, 4, "int8_ring", {"flat": 4})["bottleneck"]) + (
        JW.modeled_wire_bytes(4096 * 512, 2, "none", {"flat": 4})
        ["bottleneck"] - JW.modeled_wire_bytes(
            4096 * 512, 2, "int8_ring", {"flat": 4})["bottleneck"])
    assert after["bytes_saved"]["int8_ring"] - \
        before["bytes_saved"].get("int8_ring", 0) == saved


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("k,depth", [(1, 0), (2, 0), (2, 1), (4, 1),
                                     (4, 3), (4, 8)])
def test_microbatch_overlap_model(layout, k, depth):
    """The JAX model reads the ring sizes from the bound mesh axes, so it
    runs traced under shard_map on a four-device sub-mesh; the port reads
    the same sizes from ``axis_sizes``."""
    axis, sizes = LAYOUTS[layout]
    shapes = [(300, 7), (4096,), (5,)]
    devs = np.array(jax.devices()[:4])
    mesh = (Mesh(devs, ("hvd",)) if layout == "flat"
            else Mesh(devs.reshape(2, 2), axis))
    seen = []

    def body(x):
        seen.append(JO.microbatch_overlap_model(
            [jnp.zeros(s, jnp.float32) for s in shapes], axis, k, depth))
        return x

    jax.make_jaxpr(shard_map(body, mesh=mesh, in_specs=P(axis),
                             out_specs=P(axis), check_vma=False))(
        jnp.zeros(4))
    got = TO.microbatch_overlap_model([torch.zeros(s) for s in shapes], k,
                                      depth, axis_sizes=sizes)
    assert got == seen[0]


def test_record_overlap_matches_jax():
    for total, exposed in [(0.0, 0.0), (100.0, 25.0), (100.0, 150.0),
                           (8.0, -1.0)]:
        assert TO.record_overlap(total, exposed, "microbatch") == \
            JO.record_overlap(total, exposed, "microbatch")


def test_resolve_depth_bounds():
    assert TO.resolve_depth(0) == 0
    assert TO.resolve_depth(TO.MAX_OVERLAP_DEPTH) == TO.MAX_OVERLAP_DEPTH
    for bad in (-1, TO.MAX_OVERLAP_DEPTH + 1):
        with pytest.raises(ValueError, match="out of range"):
            TO.resolve_depth(bad)


# ---------------------------------------------------------------- the codecs
# One row per scale; scale 0 is an all-zero buffer, the scale's 1e-30
# floor.  The data stay clear of denormal results: XLA's CPU code flushes
# them to zero, torch keeps them.
CODEC_SCALES = (0.0, 1e-20, 1e-3, 1.0, 1e4)


@pytest.mark.parametrize("n", [1, 7, 1000, 65537])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_int8_codec_and_local_error_bitwise(n, dtype):
    """The JAX functions as jit compiles them (the scale's division by
    127 folded into a product, an fp32 residual fused into one
    multiply-add), mapped over the rows, against the port's on each row,
    bitwise."""
    rng = np.random.RandomState(n)
    x32 = np.clip(np.array(CODEC_SCALES)[:, None] * rng.randn(
        len(CODEC_SCALES), n) * rng.exponential(1.0, (1, n)),
        -6e4, 6e4).astype(np.float32)  # finite in fp16 too
    if n == 7:
        x32[:, :3] = [0.5, -1.5, 2.5]  # ties, before the scale takes them
    jx = jnp.asarray(x32).astype(JDT[dtype])
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(TDT[dtype])
    if dtype == "float32":
        q, s = jax.jit(jax.vmap(JQ._quantize))(jx)
        for i, row in enumerate(tx):
            tq, ts = TQ._quantize(row)
            np.testing.assert_array_equal(tq.numpy(), np.asarray(q[i]))
            assert ts.numpy().tobytes() == np.asarray(s[i]).tobytes()
    for fmt in JW.FORMAT_NAMES:
        for jfn, tfn in ((JW.wire_roundtrip, TW.wire_roundtrip),
                         (JW.local_error, TW.local_error)):
            want = np.asarray(jax.jit(jax.vmap(lambda v: jfn(v, fmt)))(jx)
                              .astype(jnp.float32))
            for i, row in enumerate(tx):
                got = tfn(row, fmt).float().numpy()
                assert got.tobytes() == want[i].tobytes(), \
                    (fmt, jfn.__name__, CODEC_SCALES[i])


@pytest.mark.parametrize("name", ["none", "bf16", "fp16"])
def test_compressors_bitwise(name):
    x = np.random.RandomState(3).randn(999).astype(np.float32) * 100
    jc, ctx = JC.Compression.by_name(name).compress(jnp.asarray(x))
    tc, tctx = TC.Compression.by_name(name).compress(torch.from_numpy(x))
    np.testing.assert_array_equal(tc.float().numpy(),
                                  np.asarray(jc.astype(jnp.float32)))
    back = TC.Compression.by_name(name).decompress(tc, tctx)
    assert back.dtype == torch.float32
    np.testing.assert_array_equal(back.numpy(), np.asarray(
        JC.Compression.by_name(name).decompress(jc, ctx)))
    with pytest.raises(ValueError):
        TC.Compression.by_name("int8")
    import horovod_tpu_torch.torch as TT
    assert TT.Compression is TC.Compression


# ------------------------------------------------ the optimizer at one rank
def _weights(opt_kw, k=2, steps=4):
    w = torch.nn.Parameter(torch.ones(24))
    opt = hvd.DistributedOptimizer(torch.optim.SGD([w], lr=0.1),
                                   backward_passes_per_step=k, **opt_kw)
    rng = np.random.RandomState(0)
    for _ in range(steps):
        w.grad = torch.from_numpy(rng.randn(24).astype(np.float32))
        opt.step()
    return w.detach().numpy(), opt


def test_one_rank_forces_none_and_overlap_is_exact(runtime):
    """At one rank plan_formats forces ``none`` and the sync is a copy:
    every format, with EF and the pipeline at every depth, gives the
    classic path's weights bitwise, and the residuals stay zero."""
    ref, _ = _weights({})
    for fmt, ef, depth in itertools.product(["none", "int8_ring", "auto"],
                                            [False, True], [0, 1]):
        got, opt = _weights(dict(wire_policy=fmt, error_feedback=ef,
                                 overlap=True, overlap_depth=depth))
        assert got.tobytes() == ref.tobytes(), (fmt, ef, depth)
        assert all(float(r.abs().max()) == 0.0
                   for r in opt.wire_residuals.values())


def test_overlap_knob_alone_turns_the_pipeline_on(runtime, monkeypatch):
    _, opt = _weights({}, steps=0)
    assert opt._hvd_pipeline is None
    monkeypatch.setenv("HOROVOD_OVERLAP", "1")
    _, opt = _weights({}, steps=0)
    assert opt._hvd_pipeline is not None and opt._hvd_pipeline.depth == 1
    _, opt = _weights({"overlap": False}, steps=0)
    assert opt._hvd_pipeline is None  # the argument wins
    _, opt = _weights({}, k=1, steps=0)
    assert opt._hvd_pipeline is None  # nothing to pipeline at k = 1
    monkeypatch.setenv("HOROVOD_OVERLAP_DEPTH", "3")
    _, opt = _weights({}, k=4, steps=0)
    assert opt._hvd_pipeline.depth == 3
    _, opt = _weights({}, k=2, steps=0)
    assert opt._hvd_pipeline.depth == 1  # capped at k - 1, as in JAX


def test_pipelined_optimizer_is_freed_without_the_collector(runtime):
    """The pipeline reaches its optimizer through a weak reference: no
    cycle keeps a dropped optimizer's state alive until a collection."""
    import gc
    import weakref
    gc.disable()
    try:
        _, opt = _weights({"overlap": True}, steps=4)
        ref = weakref.ref(opt)
        del opt
        assert ref() is None
    finally:
        gc.enable()


def test_set_overlap_only_between_cycles(runtime):
    _, opt = _weights({"overlap": True}, k=2, steps=1)
    with pytest.raises(RuntimeError, match="cycle"):
        opt.set_overlap(False)
    _, opt = _weights({"overlap": False}, k=2, steps=1)
    with pytest.raises(RuntimeError, match="cycle"):
        opt.set_overlap(True)


def test_ef_defaults_follow_the_knob(runtime, monkeypatch):
    assert not _weights({}, steps=0)[1]._hvd_ef
    assert _weights({"wire_policy": "int8_ring"}, steps=0)[1]._hvd_ef
    assert _weights({"compression": hvd.Compression.bf16}, steps=0)[1]._hvd_ef
    assert not _weights({"wire_policy": "int8_ring", "error_feedback": False},
                        steps=0)[1]._hvd_ef
    monkeypatch.setenv("HOROVOD_WIRE_EF", "0")
    assert not _weights({"quantized_wire": True}, steps=0)[1]._hvd_ef
    monkeypatch.setenv("HOROVOD_WIRE_POLICY", "int8_ring")
    assert not _weights({}, steps=0)[1]._hvd_ef  # the env knob adds none


def test_bad_wire_arguments_raise_at_construction():
    with pytest.raises(ValueError, match="unknown wire policy"):
        _weights({"wire_policy": "int9"}, steps=0)
    with pytest.raises(ValueError, match="Average/Sum"):
        _weights({"quantized_wire": True, "op": hvd.Min}, steps=0)
    with pytest.raises(ValueError, match="out of range"):
        _weights({"overlap_depth": 9}, steps=0)


@pytest.mark.parametrize("env,match", [
    ({"HOROVOD_WIRE_POLICY": "int9"}, "unknown wire policy"),
    ({"HOROVOD_OVERLAP_DEPTH": "0"}, "HOROVOD_OVERLAP_DEPTH"),
    ({"HOROVOD_OVERLAP_DEPTH": "9"}, "HOROVOD_OVERLAP_DEPTH")])
def test_bad_knobs_fail_at_init(monkeypatch, env, match):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError, match=match):
        hvd.init(device="cpu")
    assert not hvd.is_initialized()


def test_runtime_wire_policy_is_live(runtime, monkeypatch):
    rt = hvd.runtime.get()
    assert rt.hierarchy is None  # one rank: flat
    monkeypatch.setenv("HOROVOD_WIRE_POLICY", "none")
    assert rt.wire_policy() == "none"
    monkeypatch.setenv("HOROVOD_WIRE_POLICY", "bf16")
    assert rt.wire_policy() == "bf16"
    monkeypatch.setenv("HOROVOD_WIRE_POLICY", "auto")
    assert rt.wire_policy() == "auto"
    assert TW._axis_sizes() == {"flat": 1}


def test_wire_residual_report_norms():
    rng = np.random.RandomState(1)
    res = [torch.from_numpy(rng.randn(*s).astype(np.float32))
           for s in [(5,), (3, 4), (7,)]]
    plan = TF.make_plan([tuple(r.shape) for r in res],
                        [r.dtype for r in res], 80)
    by_leaf = hvd.wire_residual_report(res)
    by_bucket = hvd.wire_residual_report(res, plan)
    for i, r in enumerate(res):
        assert by_leaf[f"leaf{i}"] == pytest.approx(
            float(np.linalg.norm(r.double().numpy())), rel=1e-12)
    for i, b in enumerate(plan.buckets):
        assert by_bucket[f"bucket{i}"] == pytest.approx(np.sqrt(sum(
            by_leaf[f"leaf{j}"] ** 2 for j in b.indices)), rel=1e-12)


def test_microbatched_step_with_overlap_is_the_classic_step(runtime):
    """``make_microbatched_train_step(..., overlap=True, overlap_depth=1)``
    on the ``tiny`` Llama at one rank: the same losses and weights,
    bitwise, as the classic accumulate-then-sync step."""
    cfg = TL.CONFIGS["tiny"]
    batch = torch.from_numpy(np.random.RandomState(4).randint(
        0, cfg.vocab, (2, 2, 17)).astype(np.int64))
    out = {}
    for overlap in (False, True):
        model = TL.init(cfg, torch.Generator().manual_seed(0), device="cpu")
        opt = hvd.DistributedOptimizer(
            torch.optim.AdamW(model.parameters(), lr=1e-2),
            backward_passes_per_step=2, wire_policy="auto",
            error_feedback=True)
        step = hvd.make_microbatched_train_step(
            model, TL.loss_fn, opt, 2, overlap=overlap, overlap_depth=1)
        assert (opt._hvd_pipeline is not None) == overlap
        losses = [float(step(batch)) for _ in range(2)]
        out[overlap] = (losses, [p.detach().clone()
                                 for p in model.parameters()])
    assert out[True][0] == out[False][0]
    for a, b in zip(out[True][1], out[False][1]):
        assert torch.equal(a, b)
