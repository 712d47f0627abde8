"""One gloo rank of Adasum's four-rank run
(tests/torch_port/test_torch_adasum.py), started with
torch.multiprocessing.  Imports torch and horovod_tpu_torch only, never
JAX.

The four ranks run on a two-level layout (HOROVOD_LOCAL_SIZE=2: hosts
{0, 1} and {2, 3}): ``adasum_allreduce`` over the world, the identical
and orthogonal vectors, a three-rank group (the non-power-of-two error),
Adasum over {0, 2} and {1, 3} with the vector sharded over {0, 1} and
{2, 3} (``dot_group``), ``adasum_hierarchical`` on the runtime's host
layout, ``spmd.allreduce(op=Adasum)`` with and without
HOROVOD_HIERARCHICAL_ALLREDUCE, and ``sync_gradients(op=Adasum)`` over
several buckets.  Then ranks 0 and 1 start a two-rank job of their own
with the native controller and run the eager API: ``allreduce(op=Adasum)``
(and its gradient), a grouped Adasum allreduce and the delta optimizer.
Each rank saves ``out[name]`` to ``<out_dir>/rank<r>.npy``; a case that
raised is recorded under ``_<name>`` with its traceback."""

import os
import traceback

import numpy as np

SIZE = 4
THRESHOLD = 256  # bytes: the sync leaves fall into several buckets
SYNC_SHAPES = ((8, 4), (16,), (3, 5), (40,), (2,))
LR = 0.1


def vectors(seed, n=SIZE, dim=16):
    return np.random.RandomState(seed).randn(n, dim).astype(np.float32)


def sync_inputs():
    rng = np.random.RandomState(7)
    return [[rng.randn(*s).astype(np.float32) for s in SYNC_SHAPES]
            for _ in range(SIZE)]


def delta_inputs():
    """Per rank: the initial weights (shared) and that rank's gradients."""
    rng = np.random.RandomState(9)
    w = [rng.randn(4, 3).astype(np.float32), rng.randn(5).astype(np.float32)]
    grads = [[rng.randn(*a.shape).astype(np.float32) for a in w]
             for _ in range(2)]
    return w, grads


def _np(t):
    return t.detach().float().numpy().copy()


def _spmd_cases(torch, dist, hvd, rank, out):
    from horovod_tpu_torch.parallel import adasum as A
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    trio = dist.new_group([0, 1, 2])
    singles = [dist.new_group([r]) for r in range(SIZE)]
    across = [dist.new_group([0, 2]), dist.new_group([1, 3])][rank % 2]
    within = [dist.new_group([0, 1]), dist.new_group([2, 3])][rank // 2]
    v = vectors(1, 1, 8)[0]
    cases = {}
    cases["model"] = lambda: _np(A.adasum_allreduce(t(vectors(0)[rank])))
    cases["identical"] = lambda: _np(A.adasum_allreduce(t(v)))
    cases["orthogonal"] = lambda: _np(A.adasum_allreduce(
        t(np.eye(SIZE, dtype=np.float32)[rank])))

    def one_rank():
        x = t(v)
        return A.adasum_allreduce(x, group=singles[rank]) is x
    cases["one rank"] = one_rank

    def non_power_of_two():
        if rank == 3:
            return "not a member"
        try:
            A.adasum_allreduce(t(v), group=trio)
        except ValueError as e:
            return str(e)
        return "no error"
    cases["non power of two"] = non_power_of_two
    cases["dot_group"] = lambda: _np(A.adasum_allreduce(
        t(vectors(2, SIZE, 8)[rank]), group=across, dot_group=within))
    cross, local = hvd.runtime.get().hierarchy
    cases["hierarchical"] = lambda: _np(A.adasum_hierarchical(
        t(vectors(3)[rank]), local, cross))
    cases["spmd"] = lambda: _np(hvd.spmd.allreduce(
        t(vectors(4)[rank]).clone(), op=hvd.Adasum, prescale_factor=2.0,
        postscale_factor=0.25))

    def spmd_two_level():
        os.environ["HOROVOD_HIERARCHICAL_ALLREDUCE"] = "1"
        try:
            return _np(hvd.spmd.allreduce(t(vectors(4)[rank]).clone(),
                                          op=hvd.Adasum))
        finally:
            os.environ.pop("HOROVOD_HIERARCHICAL_ALLREDUCE")
    cases["spmd two-level"] = spmd_two_level

    def sync():
        grads = [t(a).clone() for a in sync_inputs()[rank]]
        hvd.sync_gradients(grads, op=hvd.Adasum,
                           fusion_threshold_bytes=THRESHOLD)
        return [_np(g) for g in grads]
    cases["sync_gradients"] = sync
    for name, fn in cases.items():
        try:
            out[name] = fn()
        except Exception:
            out["_" + name] = traceback.format_exc()


def _eager_cases(torch, rank, out):
    """Ranks 0 and 1 as a two-rank job, negotiated through the
    controller."""
    import horovod_tpu_torch.torch as ht
    x = torch.from_numpy(vectors(5, 2, 16)[rank]).requires_grad_()
    y = ht.allreduce(x, op=ht.Adasum, name="adasum.eager")
    y.sum().backward()
    out["eager"] = _np(y)
    out["eager grad"] = _np(x.grad)
    pair = [torch.from_numpy(vectors(6, 2, 8)[rank]),
            torch.from_numpy(vectors(7, 2, 3)[rank])]
    out["eager grouped"] = [_np(g) for g in ht.grouped_allreduce(
        pair, op=ht.Adasum, name="adasum.grouped")]
    w, grads = delta_inputs()
    params = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in w]
    opt = ht.DistributedOptimizer(torch.optim.SGD(params, lr=LR),
                                  op=ht.Adasum)
    for p, g in zip(params, grads[rank]):
        p.grad = torch.from_numpy(g.copy())
    from horovod_tpu_torch.torch import mpi_ops
    names, submit = [], mpi_ops.allreduce_async

    def recording(tensor, *args, name=None, **kw):
        names.append(name)
        return submit(tensor, *args, name=name, **kw)
    mpi_ops.allreduce_async = recording
    try:
        opt.step()
    finally:
        mpi_ops.allreduce_async = submit
    out["delta"] = [_np(p) for p in params]
    out["delta class"] = (type(opt).__name__,
                          isinstance(opt, torch.optim.SGD))
    out["delta names"] = names
    out["negotiated"] = mpi_ops.engine().core is not None


def run(rank, ports, out_dir):
    store, store2, controller = ports
    os.environ.update(HOROVOD_RANK=str(rank), HOROVOD_SIZE=str(SIZE),
                      HOROVOD_LOCAL_RANK=str(rank % 2),
                      HOROVOD_LOCAL_SIZE="2",
                      HOROVOD_COORDINATOR_ADDR=f"127.0.0.1:{store}",
                      HOROVOD_CONTROLLER="none")
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    import horovod_tpu_torch as hvd
    hvd.init(device="cpu")
    out = {}
    _spmd_cases(torch, dist, hvd, rank, out)
    hvd.shutdown()
    if rank < 2:
        os.environ.update(HOROVOD_SIZE="2", HOROVOD_LOCAL_SIZE="2",
                          HOROVOD_LOCAL_RANK=str(rank),
                          HOROVOD_COORDINATOR_ADDR=f"127.0.0.1:{store2}",
                          HOROVOD_CONTROLLER="tcp",
                          HOROVOD_CONTROLLER_PORT=str(controller))
        import horovod_tpu_torch.torch as ht
        ht.init(device="cpu")
        try:
            _eager_cases(torch, rank, out)
        except Exception:
            out["_eager"] = traceback.format_exc()
        ht.shutdown()
    np.save(os.path.join(out_dir, f"rank{rank}.npy"), out, allow_pickle=True)
