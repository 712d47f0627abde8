"""One gloo rank of the eager API's two-rank run
(tests/torch_port/test_torch_eager_gloo.py), started with
torch.multiprocessing.  Imports torch and horovod_tpu_torch only, never
JAX.  Each check lands in ``checks[name] = (ok, detail)``, saved to
``<out_dir>/rank<r>.npy`` for the test to read."""

import os
import traceback

import numpy as np

SIZE = 2


def _close(got, want, atol=1e-6):
    got = np.asarray(got.detach().cpu().float() if hasattr(got, "detach")
                     else got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    ok = got.shape == want.shape and np.allclose(got, want, rtol=atol,
                                                 atol=atol)
    return ok, "" if ok else f"got {got.tolist()} want {want.tolist()}"


def _ops(hvd, torch, rank, checks):
    """Every eager op against a numpy oracle of both ranks' inputs."""
    rng = np.random.RandomState(0)
    xs = [rng.randn(3, 4).astype(np.float32) for _ in range(SIZE)]
    x = torch.from_numpy(xs[rank].copy())
    both = np.stack(xs)
    oracle = {hvd.Sum: both.sum(0), hvd.Average: both.mean(0),
              hvd.Min: both.min(0), hvd.Max: both.max(0),
              hvd.Product: both.prod(0)}
    for op, want in oracle.items():
        checks[f"allreduce {op.name}"] = _close(
            hvd.allreduce(x, op=op, name=f"ar.{op.name}"), want)
    checks["allreduce scaled"] = _close(
        hvd.allreduce(x, op=hvd.Sum, prescale_factor=0.5,
                      postscale_factor=3.0), 1.5 * both.sum(0))
    ints = torch.tensor([rank * 3 + 1, 7, -5], dtype=torch.int64)
    ints_all = np.stack([[1, 7, -5], [4, 7, -5]])
    checks["allreduce int Average"] = _close(
        hvd.allreduce(ints, op=hvd.Average),
        np.trunc(ints_all.sum(0) / SIZE))
    y = x.clone()
    h = hvd.allreduce_async_(y, op=hvd.Sum)
    out = hvd.synchronize(h)
    checks["allreduce_async_ in place"] = (
        out is y and _close(y, both.sum(0))[0], "")
    bf = hvd.allreduce(x.to(torch.bfloat16), op=hvd.Sum)
    checks["allreduce bf16"] = (bf.dtype == torch.bfloat16 and _close(
        bf, both.sum(0), atol=5e-2)[0], "")
    g = [x, torch.full((2,), float(rank + 1), dtype=torch.float64)]
    got = hvd.grouped_allreduce(g, op=hvd.Sum)
    checks["grouped_allreduce"] = (
        _close(got[0], both.sum(0))[0] and _close(got[1], [3.0, 3.0])[0]
        and got[1].dtype == torch.float64, "")
    gi = [t.clone() for t in g]
    hvd.grouped_allreduce_(gi, op=hvd.Average)
    checks["grouped_allreduce_ in place"] = _close(gi[0], both.mean(0))
    checks["allgather"] = _close(hvd.allgather(x), both.reshape(6, 4))
    rag = torch.arange(rank + 1, dtype=torch.float32).view(-1, 1) + rank
    checks["allgather ragged"] = _close(
        hvd.synchronize(hvd.mpi_ops.allgather_ragged_async(rag)),
        [[0.0], [1.0], [2.0]])
    checks["broadcast"] = _close(hvd.broadcast(x, root_rank=1), xs[1])
    z = x.clone()
    hvd.broadcast_(z, root_rank=0)
    checks["broadcast_ in place"] = _close(z, xs[0])
    # alltoall with splits: rank r sends rows to rank 0 then rank 1
    send = [[1, 2], [3, 1]][rank]
    rows = torch.arange(sum(send), dtype=torch.float32).view(-1, 1) \
        + 10 * rank
    out, recv = hvd.alltoall(rows, splits=torch.tensor(send))
    want = {0: [[0.0], [10.0], [11.0], [12.0]], 1: [[1.0], [2.0], [13.0]]}
    checks["alltoall splits"] = (
        _close(out, want[rank])[0] and recv.tolist() == [
            [1, 3], [2, 1]][rank], f"{out.tolist()} {recv.tolist()}")
    even = torch.arange(4, dtype=torch.float32).view(4, 1) + 100 * rank
    checks["alltoall even"] = _close(
        hvd.alltoall(even), [[0.0], [1.0], [100.0], [101.0]] if rank == 0
        else [[2.0], [3.0], [102.0], [103.0]])
    rs = torch.from_numpy(np.arange(8, dtype=np.float32).reshape(4, 2)
                          * (rank + 1))
    full = np.arange(8, dtype=np.float64).reshape(4, 2) * 3
    checks["reducescatter"] = _close(hvd.reducescatter(rs, op=hvd.Sum),
                                     full[2 * rank:2 * rank + 2])
    hvd.barrier()
    checks["barrier"] = (True, "")
    checks["broadcast_object"] = (hvd.broadcast_object(
        {"rank": rank, "v": [1, 2]}, root_rank=1) == {"rank": 1,
                                                      "v": [1, 2]}, "")
    checks["allgather_object"] = (hvd.allgather_object(("r", rank)) == [
        ("r", 0), ("r", 1)], "")
    # autograd: d(sum(allreduce(w * c)))/dw = Sum over ranks of 1 * c
    w = torch.ones(3, requires_grad=True)
    hvd.allreduce(w * (rank + 1), op=hvd.Sum).sum().backward()
    checks["allreduce grad"] = _close(w.grad, [2.0 * (rank + 1)] * 3)
    w = torch.ones(2, requires_grad=True)
    (hvd.allgather(w * (rank + 1)) * torch.arange(4.0)).sum().backward()
    # both ranks' losses weight the gathered rows by 0..3: this rank's
    # rows get twice their weights, times its own factor
    checks["allgather grad"] = _close(
        w.grad, [2.0 * (2 * rank + i) * (rank + 1) for i in range(2)])
    sp = torch.sparse_coo_tensor(torch.tensor([[rank, 3]]),
                                 torch.tensor([1.0, 2.0]), (4,))
    dense = hvd.sparse_allreduce_async(sp, op=hvd.Sum)().to_dense()
    checks["sparse_allreduce_async"] = _close(dense, [1.0, 1.0, 0.0, 4.0])


def _data_plane(hvd, torch, rank, checks):
    """The data plane of ``ops/collectives.py`` called in the same order on
    both ranks (packed buffers, a strided output, Product), and ops built
    by hand through the engine: mixed scales in one submission round and
    the synchronous form ``wait(submit(op))``."""
    from horovod_tpu_torch.ops import collectives as C, negotiated as N
    from horovod_tpu_torch.torch import mpi_ops
    x = torch.full((3,), float(rank + 1))
    y = torch.full((2, 2), float(rank + 2))
    strided = torch.empty(2, 4)[:, ::2]
    outs = C.allreduce_([x, y], op=hvd.Product,
                        outputs=[torch.empty(3), strided])
    checks["data plane packed Product"] = (
        _close(outs[0], [2.0] * 3)[0] and outs[1] is strided
        and _close(strided, [[6.0, 6.0], [6.0, 6.0]])[0], "")
    got = C.allreduce_([x.clone()], op=hvd.Average, prescale_factor=2.0,
                       postscale_factor=0.5)[0]
    checks["data plane scaled Average"] = _close(got, [1.5] * 3)
    b = [x.clone(), y.clone()]
    C.broadcast_(b, root_rank=1)
    checks["data plane packed broadcast"] = (
        _close(b[0], [2.0] * 3)[0] and _close(b[1], [[3.0] * 2] * 2)[0], "")
    eng = mpi_ops.engine()
    ops = [eng.submit(N.Op(f"scales.{i}", "allreduce", [x], reduce_op=hvd.Sum,
                           pre=pre, post=post))
           for i, (pre, post) in enumerate([(1.0, 1.0), (2.0, 1.0),
                                            (1.0, 0.25)])]
    got = [eng.wait(op) for op in ops]
    checks["engine mixed scales"] = (
        _close(got[0], [3.0] * 3)[0] and _close(got[1], [6.0] * 3)[0]
        and _close(got[2], [0.75] * 3)[0], f"{got}")
    got = eng.wait(eng.submit(N.Op("sync.form", "allreduce", [x],
                                   reduce_op=hvd.Max)))
    checks["engine wait(submit(op))"] = _close(got, [2.0] * 3)


def _opposite_orders(hvd, torch, rank, checks):
    """Rank 0 submits a, b, c; rank 1 c, b, a: the controller orders them
    the same on both ranks, so nothing deadlocks or mispairs."""
    names = ["order.a", "order.b", "order.c"]
    vals = {n: torch.full((5,), float(i + 1) * (rank + 1))
            for i, n in enumerate(names)}
    order = names if rank == 0 else names[::-1]
    handles = {n: hvd.allreduce_async(vals[n], name=n, op=hvd.Sum)
               for n in order}
    ok = all(_close(hvd.synchronize(handles[n]),
                    [3.0 * (i + 1)] * 5)[0] for i, n in enumerate(names))
    checks["opposite submission orders"] = (ok, "")


def _join(hvd, torch, rank, checks):
    """Uneven batches: rank 0 has three, rank 1 one; after joining, rank 1
    answers rank 0's allreduces with zeros."""
    got = []
    for i in range(3 if rank == 0 else 1):
        got.append(hvd.allreduce(torch.full((2,), float(rank + 1)),
                                 op=hvd.Sum, name=f"join.batch{i}").tolist())
    last = hvd.join()
    want = [[3.0, 3.0], [1.0, 1.0], [1.0, 1.0]] if rank == 0 else [[3.0, 3.0]]
    checks["join uneven batches"] = (got == want and last == 0,
                                     f"{got} last={last}")


def _optimizer(hvd, torch, rank, checks):
    """The hook optimizer on each rank's half of the batch against a plain
    optimizer on the full batch in this process, three steps."""
    torch.manual_seed(0)
    net = torch.nn.Sequential(torch.nn.Linear(6, 8), torch.nn.Tanh(),
                              torch.nn.Linear(8, 3))
    rng = np.random.RandomState(1)
    batches = [(torch.from_numpy(rng.randn(8, 6).astype(np.float32)),
                torch.from_numpy(rng.randn(8, 3).astype(np.float32)))
               for _ in range(3)]
    cases = {"buckets": {}, "bucket_bytes=0": {"bucket_bytes": 0},
             "num_groups=2": {"num_groups": 2},
             "predivide": {"gradient_predivide_factor": 4.0}}
    for label, kw in cases.items():
        ref = [p.detach().clone() for p in net.parameters()]
        mine = [torch.nn.Parameter(p.clone()) for p in ref]
        full = [torch.nn.Parameter(p.clone()) for p in ref]

        def loss(params, xb, yb):
            h = torch.tanh(xb @ params[0].T + params[1])
            return ((h @ params[2].T + params[3] - yb) ** 2).mean()
        opt = hvd.DistributedOptimizer(
            torch.optim.AdamW(mine, lr=1e-2, eps=1e-3),
            named_parameters=[(f"p{i}", p) for i, p in enumerate(mine)],
            **kw)
        local = torch.optim.AdamW(full, lr=1e-2, eps=1e-3)
        for xb, yb in batches:
            opt.zero_grad()
            loss(mine, xb[rank * 4:(rank + 1) * 4],
                 yb[rank * 4:(rank + 1) * 4]).backward()
            opt.step()
            local.zero_grad()
            loss(full, xb, yb).backward()
            local.step()
        errs = [(a - b).abs().max().item() for a, b in
                zip(mine, full)]
        checks[f"optimizer {label} vs full batch"] = (max(errs) < 1e-5,
                                                      f"{errs}")


def _sync_bn(hvd, torch, rank, checks):
    """SyncBatchNorm on each rank's rows against BatchNorm on all rows:
    output, input gradient, weight gradient and running statistics."""
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.randn(6, 3, 4).astype(np.float32))
    rows = [slice(0, 2), slice(2, 6)][rank]  # uneven: 2 and 4 rows
    bn = hvd.SyncBatchNorm(3)
    ref = torch.nn.BatchNorm1d(3)
    xs = x[rows].clone().requires_grad_()
    xf = x.clone().requires_grad_()
    weights = torch.from_numpy(rng.randn(6, 3, 4).astype(np.float32))
    out_s, out_f = bn(xs), ref(xf)
    (out_s * weights[rows]).sum().backward()
    (out_f * weights).sum().backward()
    wgrad = hvd.allreduce(bn.weight.grad, op=hvd.Sum)
    ok = (torch.allclose(out_s, out_f[rows], atol=1e-5)
          and torch.allclose(xs.grad, xf.grad[rows], atol=1e-5)
          and torch.allclose(wgrad, ref.weight.grad, atol=1e-5)
          and torch.allclose(bn.running_mean, ref.running_mean, atol=1e-6)
          and torch.allclose(bn.running_var, ref.running_var, atol=1e-6))
    bn.eval()
    ref.eval()
    ok = ok and torch.allclose(bn(x), ref(x), atol=1e-5)
    checks["SyncBatchNorm vs full-batch BatchNorm"] = (ok, "")


def _state_repair(hvd, torch, rank, checks):
    """broadcast_optimizer_state with rank 0 stepped and rank 1 fresh, for
    the eager API's and the root package's functions."""
    import horovod_tpu_torch as root
    for label, api, make in (
            ("eager", hvd, lambda ps: hvd.DistributedOptimizer(
                torch.optim.AdamW(ps, lr=0.1, weight_decay=0.1),
                named_parameters=[(f"s{i}", p) for i, p in enumerate(ps)])),
            ("root", root, lambda ps: root.DistributedOptimizer(
                torch.optim.AdamW(ps, lr=0.1, weight_decay=0.1)))):
        torch.manual_seed(rank)
        ps = [torch.nn.Parameter(torch.randn(4, 3)),
              torch.nn.Parameter(torch.randn(5))]
        opt = make(ps)
        if rank == 0:  # two local steps of the wrapped class, no sync
            for k in range(2):
                for p in ps:
                    p.grad = torch.full_like(p, 0.1 * (k + 1))
                torch.optim.AdamW.step(opt)
        api.broadcast_optimizer_state(opt, root_rank=0)
        api.broadcast_parameters([(f"s{i}", p) for i, p in enumerate(ps)],
                                 root_rank=0)
        state = [[float(v.sum()) if torch.is_tensor(v) else v
                  for _, v in sorted(opt.state[p].items())] for p in ps]
        flat = {"state": state,
                "params": [p.detach().numpy().tolist() for p in ps]}
        gathered = api.allgather_object(flat)
        checks[f"broadcast_optimizer_state {label}: stepped root, fresh "
               "rank"] = (gathered[0] == gathered[1]
                          and state[0][-1] == 2.0, f"{gathered}")


def run(rank, store_port, controller_port, out_dir):
    os.environ.update(HOROVOD_RANK=str(rank), HOROVOD_SIZE=str(SIZE),
                      HOROVOD_LOCAL_RANK=str(rank),
                      HOROVOD_LOCAL_SIZE=str(SIZE),
                      HOROVOD_COORDINATOR_ADDR=f"127.0.0.1:{store_port}",
                      HOROVOD_CONTROLLER_PORT=str(controller_port))
    import torch
    torch.set_num_threads(1)
    import horovod_tpu_torch.torch as hvd

    hvd.init(device="cpu")
    checks = {}
    for part in (_ops, _data_plane, _opposite_orders, _optimizer, _sync_bn,
                 _state_repair, _join):
        try:
            part(hvd, torch, rank, checks)
        except Exception:
            checks[part.__name__] = (False, traceback.format_exc())
    from horovod_tpu_torch.torch import mpi_ops
    checks["negotiated through the controller"] = (
        mpi_ops.engine().core is not None
        and mpi_ops.stats()["responses"] > 0, f"{mpi_ops.stats()}")
    hvd.shutdown()
    np.save(os.path.join(out_dir, f"rank{rank}.npy"),
            np.array(checks, dtype=object), allow_pickle=True)
