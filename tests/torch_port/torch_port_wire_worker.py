"""One gloo rank of the wire and overlap planes' four-rank run
(tests/torch_port/test_torch_wire_gloo.py), started with
torch.multiprocessing.  Imports torch and horovod_tpu_torch only, never
JAX.  The run has two parts: a flat layout (HOROVOD_LOCAL_SIZE=4) and a
two-level one (HOROVOD_LOCAL_SIZE=2: two "hosts" of two ranks), each on
its own process group.  Every result lands in ``out[name]`` as numpy
arrays, saved to ``<out_dir>/rank<r>.npy``; the test runs the JAX package
on the same inputs (``leaves``) and compares.  A part that raised is
recorded under ``_<part>`` with its traceback."""

import os
import traceback

import numpy as np

SIZE = 4
LOCAL_SIZES = {"flat": 4, "two_level": 2}
# fp32 leaves, then one bf16 leaf; at THRESHOLD bytes the plan makes
# buckets [0, 1], [2], [3], [4, 5] (one-leaf buckets reduce in place)
SHAPES = [(41,), (3, 7), (200,), (5,), (64,), (33,)]
DTYPES = ["float32"] * 5 + ["bfloat16"]
SCALES = [1.0, 0.01, 30.0, 1e-4, 3.0, 2.0]
THRESHOLD = 256
# one bucket per leaf (threshold 1): int8, bf16 and none under 'auto'
AUTO_SHAPES = [(1 << 20,), (32768,), (10,)]
FLAT_FORMATS = ["none", "bf16", "fp16", "int8_ring", "dcn_int8"]
TWO_LEVEL_FORMATS = ["none", "bf16", "int8_ring", "dcn_int8"]
EF_FORMATS = ["bf16", "int8_ring"]
OVERLAP_FORMATS = ["none", "bf16", "int8_ring"]
OVERLAP_KS = [2, 4]
EF_STEPS = 3
HIER_OPS = ["SUM", "AVERAGE", "MIN", "MAX"]
HIER_N = 21  # pads to a multiple of the 2 ranks of a host


def leaves(seed, rank, shapes=SHAPES, scales=SCALES):
    """The per-rank gradients of one case, as fp32 numpy arrays (the test
    casts the last one to bf16 where DTYPES says so)."""
    rng = np.random.RandomState(1000 * seed + rank)
    return [(rng.randn(*s) * (scales[i % len(scales)]
                              * rng.exponential(1.0, s))).astype(np.float32)
            for i, s in enumerate(shapes)]


def overlap_grads(k, rank):
    rng = np.random.RandomState(500 + 10 * k + rank)
    return [rng.randn(24).astype(np.float32) for _ in range(k)]


def _np(t):
    return t.detach().float().numpy().copy()


def _tensors(torch, arrays, dtypes=DTYPES):
    return [torch.from_numpy(a.copy()).to(getattr(torch, d))
            for a, d in zip(arrays, dtypes)]


def _sync_cases(hvd, torch, rank, out, prefix, formats):
    for i, fmt in enumerate(formats):
        ts = _tensors(torch, leaves(1 + i, rank))
        hvd.sync_gradients(ts, wire_policy=fmt, fusion_threshold_bytes=THRESHOLD)
        out[f"{prefix}sync {fmt}"] = [_np(t) for t in ts]
    ts = _tensors(torch, leaves(9, rank, AUTO_SHAPES), ["float32"] * 3)
    hvd.sync_gradients(ts, wire_policy="auto", fusion_threshold_bytes=1)
    out[f"{prefix}sync auto"] = [_np(t) for t in ts]
    from horovod_tpu_torch.ops import fusion, wire
    plan = fusion.make_plan([tuple(t.shape) for t in ts],
                            [t.dtype for t in ts], 1)
    out[f"{prefix}auto formats"] = wire.plan_formats(
        plan, wire.get_policy("auto"), hvd.Average)
    ts = _tensors(torch, leaves(10, rank))
    hvd.sync_gradients(ts, op=hvd.Sum, wire_policy="int8_ring",
                       prescale_factor=0.5, postscale_factor=3.0,
                       fusion_threshold_bytes=THRESHOLD)
    out[f"{prefix}sync int8_ring scaled"] = [_np(t) for t in ts]


def _ef_cases(hvd, torch, rank, out, prefix, formats):
    for i, fmt in enumerate(formats):
        res = [torch.zeros(s, dtype=getattr(torch, d))
               for s, d in zip(SHAPES, DTYPES)]
        steps = []
        for step in range(EF_STEPS):
            ts = _tensors(torch, leaves(20 + 5 * i + step, rank))
            ts, res = hvd.optimizer.sync_gradients_ef(
                ts, res, wire_policy=fmt, fusion_threshold_bytes=THRESHOLD)
            steps.append(([_np(t) for t in ts], [_np(r) for r in res]))
        out[f"{prefix}ef {fmt}"] = steps


def _flat(hvd, torch, rank, out):
    _sync_cases(hvd, torch, rank, out, "", FLAT_FORMATS)
    _ef_cases(hvd, torch, rank, out, "", EF_FORMATS)
    from horovod_tpu_torch.ops import collectives, spmd
    x = torch.arange(6, dtype=torch.float32).view(2, 3) + 10 * rank
    out["allgather axis0"] = _np(spmd.allgather(x))
    out["allgather axis1"] = _np(spmd.allgather(x, axis=1))
    out["eager allgather"] = _np(collectives.allgather(x))


def _cycle(hvd, torch, rank, k, fmt, ef, overlap, depth):
    """Final weights after one k-microbatch cycle of SGD(0.1) through the
    DistributedOptimizer, from ones(24)."""
    w = torch.nn.Parameter(torch.ones(24))
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD([w], lr=0.1), backward_passes_per_step=k,
        wire_policy=fmt, error_feedback=ef, overlap=overlap,
        overlap_depth=depth)
    for g in overlap_grads(k, rank):
        w.grad = torch.from_numpy(g)
        opt.step()
    return _np(w)


def _overlap(hvd, torch, rank, out):
    for k in OVERLAP_KS:
        for fmt in OVERLAP_FORMATS:
            for ef in (False, True):
                for depth in sorted({0, 1, k - 1}):
                    out[f"overlap k{k} {fmt} ef{int(ef)} depth{depth}"] = \
                        _cycle(hvd, torch, rank, k, fmt, ef, True, depth)
                out[f"overlap k{k} {fmt} ef{int(ef)} classic"] = \
                    _cycle(hvd, torch, rank, k, fmt, ef, False, None)
    for overlap in (False, True):
        out[f"k1 overlap{int(overlap)}"] = _cycle(
            hvd, torch, rank, 1, "int8_ring", True, overlap, 1)


def _ef_state(hvd, torch, rank, out):
    """Where the residuals live: outside optimizer.state, rank-local, kept
    by broadcast_optimizer_state."""
    w = torch.nn.Parameter(torch.ones(300))
    opt = hvd.DistributedOptimizer(torch.optim.SGD([w], lr=0.1,
                                                   momentum=0.9),
                                   wire_policy="int8_ring")
    w.grad = torch.from_numpy(leaves(40, rank, [(300,)])[0])
    opt.step()
    res = opt.wire_residuals[w].clone()
    out["ef state residual"] = _np(res)
    state = opt.state_dict()["state"]
    out["ef state keys"] = sorted(k for s in state.values() for k in s)
    hvd.broadcast_optimizer_state(opt, root_rank=0)
    out["ef state kept by broadcast"] = bool(
        torch.equal(opt.wire_residuals[w], res))


def _two_level(hvd, torch, rank, out):
    from horovod_tpu_torch.ops import collectives, spmd, wire
    from horovod_tpu_torch.parallel import hierarchical
    out["two_level axis sizes"] = wire._axis_sizes()
    pair = hierarchical.split_hierarchy()
    out["two_level groups"] = [torch.distributed.get_process_group_ranks(g)
                               for g in pair]
    x = torch.from_numpy(leaves(30, rank, [(HIER_N,)])[0])
    for name in HIER_OPS:
        op = getattr(hvd.ReduceOp, name)
        out[f"hier {name}"] = _np(hierarchical.hierarchical_allreduce(
            x.clone(), *pair, op=op, prescale_factor=0.5,
            postscale_factor=0.25))
        out[f"flat {name}"] = _np(spmd.allreduce(
            x.clone(), op=op, prescale_factor=0.5, postscale_factor=0.25))
    calls = []
    real = hierarchical.hierarchical_allreduce
    hierarchical.hierarchical_allreduce = \
        lambda *a, **kw: calls.append(1) or real(*a, **kw)
    os.environ["HOROVOD_HIERARCHICAL_ALLREDUCE"] = "1"
    try:
        out["spmd routed AVERAGE"] = _np(spmd.allreduce(x.clone()))
        out["spmd routed calls"] = len(calls)
        _sync_cases(hvd, torch, rank, out, "two_level ", TWO_LEVEL_FORMATS)
        _ef_cases(hvd, torch, rank, out, "two_level ", ["dcn_int8"])
    finally:
        hierarchical.hierarchical_allreduce = real
        os.environ["HOROVOD_HIERARCHICAL_ALLREDUCE"] = "0"
    y = torch.arange(6, dtype=torch.float32).view(2, 3) + 10 * rank
    flat = [_np(spmd.allgather(y, axis=a)) for a in (0, 1)]
    os.environ["HOROVOD_HIERARCHICAL_ALLGATHER"] = "1"
    try:
        out["hier allgather"] = [_np(hierarchical.hierarchical_allgather(
            y, *pair, axis=a)) for a in (0, 1)]
        out["spmd allgather routed"] = [_np(spmd.allgather(y, axis=a))
                                        for a in (0, 1)]
        out["eager allgather routed"] = _np(collectives.allgather(y))
    finally:
        os.environ["HOROVOD_HIERARCHICAL_ALLGATHER"] = "0"
    out["flat allgather"] = flat


PARTS = {"flat": (_flat, _overlap, _ef_state), "two_level": (_two_level,)}


def run(rank, store_ports, out_dir):
    import torch
    torch.set_num_threads(1)
    import horovod_tpu_torch as hvd
    out = {}
    for (layout, parts), port in zip(PARTS.items(), store_ports):
        local = LOCAL_SIZES[layout]
        os.environ.update(HOROVOD_RANK=str(rank), HOROVOD_SIZE=str(SIZE),
                          HOROVOD_LOCAL_RANK=str(rank % local),
                          HOROVOD_LOCAL_SIZE=str(local),
                          HOROVOD_COORDINATOR_ADDR=f"127.0.0.1:{port}",
                          HOROVOD_CONTROLLER="none")
        try:
            hvd.init(device="cpu")
        except Exception:
            out[f"_init {layout}"] = traceback.format_exc()
            break
        for part in parts:
            try:
                part(hvd, torch, rank, out)
            except Exception:
                out[f"_{part.__name__}"] = traceback.format_exc()
        hvd.shutdown()
    from horovod_tpu_torch.ops import wire
    out["wire stats"] = wire.stats()
    np.save(os.path.join(out_dir, f"rank{rank}.npy"),
            np.array(out, dtype=object), allow_pickle=True)
