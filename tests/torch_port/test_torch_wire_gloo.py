"""The wire and overlap planes on four gloo ranks against the JAX package
on a four-device sub-mesh of the eight virtual CPU devices.

One spawned run (``torch_port_wire_worker.py``) records every rank's
results: a flat layout (the JAX ``("hvd",)`` axis) and a two-level one
(HOROVOD_LOCAL_SIZE=2, the JAX ``("dcn.data", "ici.data")`` 2 x 2 mesh).
Here the same per-rank inputs go through ``shard_map`` of the JAX
functions, called as ``tests/test_wire.py`` and
``tests/test_hierarchical.py`` call them.

Tolerances: ``none`` rtol 1e-6 plus one fp32 ulp of max |x| (gloo and XLA
add the four ranks in different orders, so a sum that cancels may differ in
its last bit), and one bf16 ulp of max |x| for the bf16 leaf, whose sum
rounds in bf16; ``bf16``/``fp16``
one ulp of the wire dtype relative to max |x|; the int8 formats 1e-6 of
max |x| (the hop arithmetic is the same, so they are expected bitwise);
every format bitwise equal across the four ranks.  Overlap: each depth
against depth 0 at rtol 2e-6, atol 2e-7, depth 0 against the classic
path (``none``) and against JAX's pipelined transform at rtol 1e-5,
atol 1e-6 (``tests/test_overlap.py``), plus, for ``bf16``, one bf16 ulp
of the gradients times the learning rate: XLA's CPU psum of a bf16 buffer
adds in fp32 and rounds once, gloo rounds every partial sum."""

import os
import socket
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch.multiprocessing as tmp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from horovod_tpu.common.reduce_op import ReduceOp
from horovod_tpu.ops._compat import shard_map
from horovod_tpu.optimizer import (distributed_optimizer, sync_gradients,
                                   sync_gradients_ef)
from horovod_tpu.parallel.hierarchical import (hierarchical_allgather,
                                               hierarchical_allreduce)

import torch_port_wire_worker as W

DCN, ICI = "dcn.data", "ici.data"
# The references are compiled without excess precision: XLA otherwise
# keeps bf16 arithmetic (the bf16 leaf's gradient + residual) in fp32,
# which moves the int8 scale of its bucket and flips a code.
STRICT = {"xla_allow_excess_precision": False}
EPS = {"float32": 2.0 ** -23, "bfloat16": 2.0 ** -7, "float16": 2.0 ** -10}


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out_dir = str(tmp_path_factory.mktemp("wire"))
    ctx = tmp.spawn(W.run, args=((_free_port(), _free_port()), out_dir),
                    nprocs=W.SIZE, join=False)
    deadline = time.monotonic() + 120
    while not ctx.join(timeout=2):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.terminate()
            pytest.fail("gloo ranks did not finish in 120 s")
    return [np.load(os.path.join(out_dir, f"rank{r}.npy"),
                    allow_pickle=True).item() for r in range(W.SIZE)]


def _mesh(layout):
    devs = np.array(jax.devices()[:W.SIZE])
    if layout == "flat":
        return Mesh(devs, ("hvd",)), "hvd"
    return Mesh(devs.reshape(2, 2), (DCN, ICI)), (DCN, ICI)


def _per_rank(fn, layout, inputs, dtypes):
    """``fn(list of this rank's leaves, axis)`` under shard_map; returns
    ``out[rank]``: the list of that rank's outputs as fp32 numpy."""
    mesh, axis = _mesh(layout)
    stacked = [jnp.asarray(np.stack([inputs[r][i] for r in range(W.SIZE)]),
                           getattr(jnp, dtypes[i]))
               for i in range(len(dtypes))]

    def body(*xs):
        outs = fn([x[0] for x in xs], axis)
        return jax.tree_util.tree_map(lambda o: o[None], outs)

    f = shard_map(body, mesh=mesh, in_specs=(P(axis),) * len(stacked),
                  out_specs=P(axis), check_vma=False)
    outs = jax.jit(f).lower(*stacked).compile(STRICT)(*stacked)
    return [jax.tree_util.tree_map(
        lambda o: np.asarray(o[r], np.float32), outs) for r in range(W.SIZE)]


WIRE_DTYPES = {"bf16": "bfloat16", "fp16": "float16"}


def _assert_close(got, want, fmt, dtype, inputs_max):
    if dtype != "float32":  # the bf16 leaf rounds to bf16 on every format
        atol, rtol = EPS[dtype] * inputs_max, 0.0
    elif fmt in ("int8_ring", "dcn_int8"):
        atol, rtol = 1e-6 * inputs_max, 0.0
    elif fmt in WIRE_DTYPES:
        atol, rtol = EPS[WIRE_DTYPES[fmt]] * inputs_max, 0.0
    else:  # gloo and XLA sum the four ranks in different orders
        atol, rtol = EPS["float32"] * inputs_max, 1e-6
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _check_sync(ranks, name, want, fmt, dtypes, inputs):
    for r in range(W.SIZE):
        got = ranks[r][name]
        for i, dtype in enumerate(dtypes):
            np.testing.assert_array_equal(got[i], ranks[0][name][i])
            m = max(float(np.abs(inputs[q][i]).max()) for q in range(W.SIZE))
            _assert_close(got[i], want[r][i], fmt, dtype, m)


def test_no_part_of_the_run_raised(ranks):
    for r in ranks:
        crashed = {n: v for n, v in r.items() if n.startswith("_")}
        assert not crashed, crashed


SYNC_CASES = ([("flat", "", i, f) for i, f in enumerate(W.FLAT_FORMATS)]
              + [("two_level", "two_level ", i, f)
                 for i, f in enumerate(W.TWO_LEVEL_FORMATS)])


@pytest.mark.parametrize("layout,prefix,seed,fmt", SYNC_CASES,
                         ids=[f"{c[0]}-{c[3]}" for c in SYNC_CASES])
def test_sync_gradients_per_format(ranks, monkeypatch, layout, prefix, seed,
                                   fmt):
    if layout == "two_level" and fmt == "none":
        monkeypatch.setenv("HOROVOD_HIERARCHICAL_ALLREDUCE", "1")
    inputs = [W.leaves(1 + seed, r) for r in range(W.SIZE)]
    want = _per_rank(lambda ls, ax: sync_gradients(
        ls, ax, wire_policy=fmt, fusion_threshold_bytes=W.THRESHOLD),
        layout, inputs, W.DTYPES)
    _check_sync(ranks, f"{prefix}sync {fmt}", want, fmt, W.DTYPES, inputs)


@pytest.mark.parametrize("layout,prefix", [("flat", ""),
                                           ("two_level", "two_level ")])
def test_auto_policy_per_bucket(ranks, layout, prefix):
    """'auto' on one bucket per leaf: 4 MiB -> the int8 ring (dcn_int8 on
    the two-level layout), 128 KiB -> bf16, 40 B -> none."""
    expect = ["int8_ring" if layout == "flat" else "dcn_int8", "bf16",
              "none"]
    assert ranks[0][f"{prefix}auto formats"] == expect
    inputs = [W.leaves(9, r, W.AUTO_SHAPES) for r in range(W.SIZE)]
    want = _per_rank(lambda ls, ax: sync_gradients(
        ls, ax, wire_policy="auto", fusion_threshold_bytes=1),
        layout, inputs, ["float32"] * 3)
    name = f"{prefix}sync auto"
    for r in range(W.SIZE):
        for i, fmt in enumerate(expect):
            np.testing.assert_array_equal(ranks[r][name][i],
                                          ranks[0][name][i])
            m = max(float(np.abs(inputs[q][i]).max()) for q in range(W.SIZE))
            _assert_close(ranks[r][name][i], want[r][i], fmt, "float32", m)


@pytest.mark.parametrize("layout,prefix", [("flat", ""),
                                           ("two_level", "two_level ")])
def test_int8_ring_with_scale_factors(ranks, layout, prefix):
    inputs = [W.leaves(10, r) for r in range(W.SIZE)]
    want = _per_rank(lambda ls, ax: sync_gradients(
        ls, ax, op=ReduceOp.SUM, wire_policy="int8_ring",
        prescale_factor=0.5, postscale_factor=3.0,
        fusion_threshold_bytes=W.THRESHOLD), layout, inputs, W.DTYPES)
    _check_sync(ranks, f"{prefix}sync int8_ring scaled", want, "int8_ring",
                W.DTYPES, [[3.0 * x for x in xs] for xs in inputs])


EF_CASES = ([("flat", "", i, f) for i, f in enumerate(W.EF_FORMATS)]
            + [("two_level", "two_level ", 0, "dcn_int8")])


@pytest.mark.parametrize("layout,prefix,idx,fmt", EF_CASES,
                         ids=[f"{c[0]}-{c[3]}" for c in EF_CASES])
def test_error_feedback_three_steps(ranks, layout, prefix, idx, fmt):
    """Three sync_gradients_ef steps: outputs and the rank-local residuals
    against JAX's, within the format's tolerance."""
    mesh, axis = _mesh(layout)
    res = [np.zeros((W.SIZE,) + s, np.float32) for s in W.SHAPES]
    steps = ranks[0][f"{prefix}ef {fmt}"]
    for step in range(W.EF_STEPS):
        inputs = [W.leaves(20 + 5 * idx + step, r) for r in range(W.SIZE)]
        dts = [getattr(jnp, d) for d in W.DTYPES]
        xs = [jnp.asarray(np.stack([inputs[r][i] for r in range(W.SIZE)]),
                          dts[i]) for i in range(len(W.SHAPES))]
        rs = [jnp.asarray(r, d) for r, d in zip(res, dts)]

        def body(xs, rs):
            out, new = sync_gradients_ef(
                [x[0] for x in xs], [r[0] for r in rs], axis,
                wire_policy=fmt, fusion_threshold_bytes=W.THRESHOLD)
            return [o[None] for o in out], [n[None] for n in new]

        f = shard_map(body, mesh=mesh, in_specs=(P(axis), P(axis)),
                      out_specs=(P(axis), P(axis)), check_vma=False)
        out, new = jax.jit(f).lower(xs, rs).compile(STRICT)(xs, rs)
        res = [np.asarray(n, np.float32) for n in new]
        for r in range(W.SIZE):
            got_out, got_res = ranks[r][f"{prefix}ef {fmt}"][step]
            for i, dtype in enumerate(W.DTYPES):
                np.testing.assert_array_equal(got_out[i], steps[step][0][i])
                m = max(float(np.abs(inputs[q][i]).max())
                        for q in range(W.SIZE))
                _assert_close(got_out[i], np.asarray(out[i][r], np.float32),
                              fmt, dtype, m)
                _assert_close(got_res[i], res[i][r], fmt, dtype, m)


def _jax_cycle(k, fmt, ef):
    """JAX's pipelined transform at depth 0 with optax.sgd(0.1): final
    weights after one k-microbatch cycle from ones(24)."""
    mesh, _ = _mesh("flat")
    opt = distributed_optimizer(optax.sgd(0.1), axis_name="hvd",
                                backward_passes_per_step=k,
                                wire_policy=fmt, error_feedback=ef,
                                overlap=True, overlap_depth=0)
    gs = [np.stack([W.overlap_grads(k, r)[i] for r in range(W.SIZE)])
          for i in range(k)]

    def body(w, *gr):
        s = opt.init(w)
        for g in gr:
            u, s = opt.update(g[0], s, w)
            w = optax.apply_updates(w, u)
        return w

    f = shard_map(body, mesh=mesh, in_specs=(P(),) + (P("hvd"),) * k,
                  out_specs=P(), check_vma=False)
    args = (jnp.ones(24),) + tuple(map(jnp.asarray, gs))
    return np.asarray(jax.jit(f).lower(*args).compile(STRICT)(*args))


OVERLAP_CASES = [(k, f, ef) for k in W.OVERLAP_KS
                 for f in W.OVERLAP_FORMATS for ef in (False, True)]


@pytest.mark.parametrize("k,fmt,ef", OVERLAP_CASES,
                         ids=[f"k{k}-{f}-ef{int(e)}"
                              for k, f, e in OVERLAP_CASES])
def test_overlap_depths_match_sequential_and_jax(ranks, k, fmt, ef):
    key = f"overlap k{k} {fmt} ef{int(ef)}"
    for r in range(W.SIZE):
        seq = ranks[r][f"{key} depth0"]
        np.testing.assert_array_equal(seq, ranks[0][f"{key} depth0"])
        for depth in sorted({1, k - 1}):
            pip = ranks[r][f"{key} depth{depth}"]
            np.testing.assert_array_equal(pip, ranks[0][f"{key} depth{depth}"])
            np.testing.assert_allclose(pip, seq, rtol=2e-6, atol=2e-7)
        if fmt == "none":
            np.testing.assert_allclose(seq, ranks[r][f"{key} classic"],
                                       rtol=1e-5, atol=1e-6)
    # XLA's CPU psum of a bf16 buffer adds in fp32 and rounds once; gloo
    # rounds each partial sum to bf16: one bf16 ulp of the gradients,
    # times the learning rate, on top
    gmax = max(float(np.abs(g).max()) for r in range(W.SIZE)
               for g in W.overlap_grads(k, r))
    wire_atol = 0.1 * EPS[WIRE_DTYPES[fmt]] * gmax if fmt in WIRE_DTYPES \
        else 0.0
    np.testing.assert_allclose(ranks[0][f"{key} depth0"],
                               _jax_cycle(k, fmt, ef), rtol=1e-5,
                               atol=1e-6 + wire_atol)


def test_k1_overlap_is_identity(ranks):
    for r in ranks:
        np.testing.assert_array_equal(r["k1 overlap1"], r["k1 overlap0"])


def test_error_feedback_state_is_rank_local(ranks):
    """The residuals live outside optimizer.state: state_dict() has only
    the inner optimizer's keys, broadcast_optimizer_state leaves each
    rank's own residual, and the residuals differ across ranks."""
    for r in ranks:
        assert r["ef state keys"] == ["momentum_buffer"]
        assert r["ef state kept by broadcast"]
        assert float(np.abs(r["ef state residual"]).max()) > 0
    assert any(not np.array_equal(r["ef state residual"],
                                  ranks[0]["ef state residual"])
               for r in ranks[1:])


def test_flat_allgather_in_rank_order(ranks):
    rows = [np.arange(6, dtype=np.float32).reshape(2, 3) + 10 * r
            for r in range(W.SIZE)]
    for r in ranks:
        np.testing.assert_array_equal(r["allgather axis0"],
                                      np.concatenate(rows, 0))
        np.testing.assert_array_equal(r["allgather axis1"],
                                      np.concatenate(rows, 1))
        np.testing.assert_array_equal(r["eager allgather"],
                                      np.concatenate(rows, 0))


def test_two_level_layout_and_groups(ranks):
    for rank, r in enumerate(ranks):
        assert r["two_level axis sizes"] == {"dcn": 2, "ici": 2}
        cross, local = r["two_level groups"]
        assert local == [rank // 2 * 2, rank // 2 * 2 + 1]
        assert cross == [rank % 2, rank % 2 + 2]


@pytest.mark.parametrize("op", W.HIER_OPS)
def test_hierarchical_allreduce_matches_flat_and_jax(ranks, op):
    red = getattr(ReduceOp, op)
    inputs = [W.leaves(30, r, [(W.HIER_N,)]) for r in range(W.SIZE)]
    want = _per_rank(lambda ls, ax: [hierarchical_allreduce(
        ls[0], ici_axis=ICI, dcn_axis=DCN, op=red, prescale_factor=0.5,
        postscale_factor=0.25)], "two_level", inputs, ["float32"])
    for rank, r in enumerate(ranks):
        np.testing.assert_allclose(r[f"hier {op}"], r[f"flat {op}"],
                                   rtol=1e-6)
        np.testing.assert_allclose(r[f"hier {op}"], want[rank][0],
                                   rtol=1e-6)


def test_knob_routes_spmd_allreduce_two_level(ranks):
    for r in ranks:
        assert r["spmd routed calls"] == 1
        np.testing.assert_allclose(r["spmd routed AVERAGE"],
                                   r["flat AVERAGE"] * 8.0, rtol=1e-6)


def test_hierarchical_allgather_host_major(ranks):
    y = [np.arange(6, dtype=np.float32).reshape(2, 3) + 10 * r
         for r in range(W.SIZE)]
    for axis in (0, 1):
        want = _per_rank(lambda ls, ax: [hierarchical_allgather(
            ls[0], ici_axis=ICI, dcn_axis=DCN, axis=axis)], "two_level",
            [[v] for v in y], ["float32"])
        flat = _per_rank(lambda ls, ax: [lax.all_gather(
            ls[0], ax, axis=axis, tiled=True)], "two_level",
            [[v] for v in y], ["float32"])
        for rank, r in enumerate(ranks):
            np.testing.assert_allclose(r["hier allgather"][axis],
                                       r["flat allgather"][axis], rtol=1e-6)
            np.testing.assert_array_equal(r["spmd allgather routed"][axis],
                                          want[rank][0])
            np.testing.assert_array_equal(want[rank][0], flat[rank][0])
    for r in ranks:
        np.testing.assert_array_equal(r["eager allgather routed"],
                                      np.concatenate(y, 0))


def test_wire_stats_count_buckets(ranks):
    stats = ranks[0]["wire stats"]
    assert stats["buckets"]["int8_ring"] > 0
    assert stats["buckets"]["dcn_int8"] > 0
    assert stats["bytes_saved"]["int8_ring"] > 0
