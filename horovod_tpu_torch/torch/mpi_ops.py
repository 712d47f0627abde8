"""Eager torch collectives: the port of ``horovod_tpu/torch/mpi_ops.py`` (the
reference's ``horovod.torch`` op surface): sync, async and in-place
variants of allreduce, grouped allreduce, allgather, broadcast, alltoall and
reducescatter, integer handles with ``synchronize``/``poll``, the autograd
functions, ``sparse_allreduce_async``, ``barrier`` and ``join``.

Every op goes through this process's negotiation engine
(``ops/negotiated.py``): when the job has more than one process, or
``HOROVOD_CONTROLLER=tcp``, it is submitted to the native controller under
its name and runs when its response arrives, packed with the other tensors
of that response into one buffer for one collective.  A single process
without ``tcp`` runs each op at once.

Tensors live on the runtime's device.  On CUDA the collective runs on a side
stream that first waits for an event recorded on the caller's stream at
submission, and ``synchronize`` makes the caller's stream wait for the op's
done event: a result read on the caller's stream after ``synchronize`` is
complete, and nothing waits on the host.  There is no host copy of the
data (the JAX frontend crossed PCIe twice per op).  The semantics are per
process, as in reference Horovod (see ``ops/collectives.py``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import torch

from .. import runtime as _rt
from ..common.reduce_op import Adasum, Average, ReduceOp, Sum
from ..ops import negotiated as N
from .compression import Compression

__all__ = [
    "allreduce", "allreduce_", "allreduce_async", "allreduce_async_",
    "grouped_allreduce", "grouped_allreduce_", "grouped_allreduce_async",
    "grouped_allreduce_async_",
    "allgather", "allgather_async", "broadcast", "broadcast_",
    "broadcast_async", "broadcast_async_", "alltoall", "alltoall_async",
    "reducescatter", "reducescatter_async", "sparse_allreduce_async",
    "synchronize", "poll", "join", "barrier",
]

Tensor = torch.Tensor


def engine() -> N.Engine:
    """This process's negotiation engine, made on first use (it lives as
    long as the runtime)."""
    rt = _rt.get()
    if rt.eager is None:
        rt.eager = N.Engine(rt)
    return rt.eager


def _dispatch(name: Optional[str], prefix: str, kind: str,
              tensors: Sequence[Tensor], finish=None, **kw) -> int:
    eng = engine()
    op = N.Op(name or eng.auto_name(prefix), kind, tensors, **kw)
    return eng.handle(eng.submit(op), finish)


def _resolve_op(average: Optional[bool], op: Optional[ReduceOp]) -> ReduceOp:
    """The deprecated ``average`` flag maps onto ReduceOp."""
    if average is not None:
        if op is not None:
            raise ValueError("cannot specify both average and op")
        return Average if average else Sum
    return op if op is not None else Average


# ------------------------------------------------------------------ allreduce
def allreduce_async(tensor: Tensor, average: Optional[bool] = None,
                    name: Optional[str] = None,
                    op: Optional[ReduceOp] = None,
                    prescale_factor: float = 1.0,
                    postscale_factor: float = 1.0,
                    compression=Compression.none) -> int:
    """Async allreduce into a new tensor; returns a handle."""
    compressed, ctx = compression.compress(tensor.detach())
    return _dispatch(name, "allreduce", "allreduce", [compressed],
                     finish=lambda r: compression.decompress(r, ctx),
                     reduce_op=_resolve_op(average, op),
                     pre=prescale_factor, post=postscale_factor)


def allreduce_async_(tensor: Tensor, average: Optional[bool] = None,
                     name: Optional[str] = None,
                     op: Optional[ReduceOp] = None,
                     prescale_factor: float = 1.0,
                     postscale_factor: float = 1.0) -> int:
    """In-place async allreduce."""
    t = tensor.detach()
    return _dispatch(name, "allreduce", "allreduce", [t], outputs=[t],
                     finish=lambda _: tensor,
                     reduce_op=_resolve_op(average, op),
                     pre=prescale_factor, post=postscale_factor)


class _AllreduceFunction(torch.autograd.Function):
    """Differentiable allreduce: the gradient goes through an allreduce
    with the same op."""

    @staticmethod
    def forward(ctx, tensor, average, name, op, prescale_factor,
                postscale_factor):
        ctx.op = _resolve_op(average, op)
        ctx.scales = (prescale_factor, postscale_factor)
        return synchronize(allreduce_async(tensor, average, name, op,
                                           prescale_factor, postscale_factor))

    @staticmethod
    def backward(ctx, grad_output):
        # Adasum's gradient is Average's (the JAX frontend's choice)
        op = Average if ctx.op == Adasum else ctx.op
        reduced = allreduce(grad_output.contiguous(), op=op,
                            prescale_factor=ctx.scales[0],
                            postscale_factor=ctx.scales[1])
        return reduced, None, None, None, None, None


def allreduce(tensor: Tensor, average: Optional[bool] = None,
              name: Optional[str] = None, compression=Compression.none,
              op: Optional[ReduceOp] = None, prescale_factor: float = 1.0,
              postscale_factor: float = 1.0) -> Tensor:
    """Synchronous allreduce into a new tensor; differentiable."""
    compressed, ctx = compression.compress(tensor)
    if compressed.requires_grad:
        out = _AllreduceFunction.apply(compressed, average, name, op,
                                       prescale_factor, postscale_factor)
    else:
        out = synchronize(allreduce_async(compressed, average, name, op,
                                          prescale_factor, postscale_factor))
    return compression.decompress(out, ctx)


def allreduce_(tensor: Tensor, average: Optional[bool] = None,
               name: Optional[str] = None, op: Optional[ReduceOp] = None,
               prescale_factor: float = 1.0,
               postscale_factor: float = 1.0) -> Tensor:
    """Synchronous in-place allreduce."""
    return synchronize(allreduce_async_(tensor, average, name, op,
                                        prescale_factor, postscale_factor))


# ---------------------------------------------------------- grouped allreduce
def _grouped(tensors, average, name, op, pre, post, inplace) -> int:
    # one negotiation entry for the whole group: it fuses atomically
    ts = [t.detach() for t in tensors]
    return _dispatch(name, "grouped_allreduce", "grouped_allreduce", ts,
                     outputs=ts if inplace else None,
                     finish=(lambda _: list(tensors)) if inplace else None,
                     reduce_op=_resolve_op(average, op), pre=pre, post=post)


def grouped_allreduce_async(tensors: Sequence[Tensor],
                            average: Optional[bool] = None,
                            name: Optional[str] = None,
                            op: Optional[ReduceOp] = None,
                            prescale_factor: float = 1.0,
                            postscale_factor: float = 1.0) -> int:
    return _grouped(tensors, average, name, op, prescale_factor,
                    postscale_factor, False)


def grouped_allreduce_async_(tensors: Sequence[Tensor],
                             average: Optional[bool] = None,
                             name: Optional[str] = None,
                             op: Optional[ReduceOp] = None,
                             prescale_factor: float = 1.0,
                             postscale_factor: float = 1.0) -> int:
    return _grouped(tensors, average, name, op, prescale_factor,
                    postscale_factor, True)


def grouped_allreduce(tensors: Sequence[Tensor],
                      average: Optional[bool] = None,
                      name: Optional[str] = None,
                      op: Optional[ReduceOp] = None,
                      prescale_factor: float = 1.0,
                      postscale_factor: float = 1.0) -> List[Tensor]:
    return synchronize(grouped_allreduce_async(
        tensors, average, name, op, prescale_factor, postscale_factor))


def grouped_allreduce_(tensors: Sequence[Tensor],
                       average: Optional[bool] = None,
                       name: Optional[str] = None,
                       op: Optional[ReduceOp] = None,
                       prescale_factor: float = 1.0,
                       postscale_factor: float = 1.0) -> List[Tensor]:
    return synchronize(grouped_allreduce_async_(
        tensors, average, name, op, prescale_factor, postscale_factor))


# ------------------------------------------------------------------ allgather
def allgather_async(tensor: Tensor, name: Optional[str] = None) -> int:
    return _dispatch(name, "allgather", "allgather", [tensor.detach()])


class _AllgatherFunction(torch.autograd.Function):
    """Backward: sum-allreduce the gathered gradient, keep this rank's
    rows."""

    @staticmethod
    def forward(ctx, tensor, name):
        ctx.rows = tensor.shape[0] if tensor.dim() else 1
        return synchronize(allgather_async(tensor, name))

    @staticmethod
    def backward(ctx, grad_output):
        reduced = allreduce(grad_output.contiguous(), op=Sum)
        return reduced.narrow(0, _rt.get().rank() * ctx.rows, ctx.rows), None


def allgather(tensor: Tensor, name: Optional[str] = None) -> Tensor:
    """Every rank's tensor (one shape on every rank) concatenated along
    dim 0, in rank order; differentiable."""
    if tensor.requires_grad:
        return _AllgatherFunction.apply(tensor, name)
    return synchronize(allgather_async(tensor, name))


def allgather_ragged_async(tensor: Tensor, name: Optional[str] = None
                           ) -> int:
    """``allgather_async`` whose dim 0 may differ across ranks."""
    return _dispatch(name, "allgather", "allgather_ragged",
                     [tensor.detach()])


def sparse_allreduce_async(tensor: Tensor, name: Optional[str] = None,
                           op: ReduceOp = Average):
    """Allreduce a sparse COO tensor by gathering every rank's indices and
    values (duplicates sum when used).  As in the reference, returns a
    callable that waits and yields the reduced sparse tensor."""
    eng = engine()
    name = name or eng.auto_name("sparse_allreduce")
    t = tensor.coalesce()
    idx = allgather_ragged_async(t._indices().transpose(0, 1).contiguous(),
                                 f"{name}.indices")
    val = allgather_ragged_async(t._values(), f"{name}.values")
    size = _rt.get().size()

    def handle():
        indices = synchronize(idx)
        values = synchronize(val)
        if op == Average:
            values = values / size
        return torch.sparse_coo_tensor(indices.transpose(0, 1), values,
                                       t.shape)
    return handle


# ------------------------------------------------------------------ broadcast
def broadcast_async(tensor: Tensor, root_rank: int = 0,
                    name: Optional[str] = None) -> int:
    return _dispatch(name, "broadcast", "broadcast", [tensor.detach()],
                     root=root_rank)


def broadcast_async_(tensor: Tensor, root_rank: int = 0,
                     name: Optional[str] = None) -> int:
    t = tensor.detach()
    return _dispatch(name, "broadcast", "broadcast", [t], outputs=[t],
                     finish=lambda _: tensor, root=root_rank)


class _BroadcastFunction(torch.autograd.Function):
    """Backward: sum-allreduce the gradient; only the root keeps it."""

    @staticmethod
    def forward(ctx, tensor, root_rank, name):
        ctx.is_root = _rt.get().rank() == root_rank
        return synchronize(broadcast_async(tensor, root_rank, name))

    @staticmethod
    def backward(ctx, grad_output):
        reduced = allreduce(grad_output.contiguous(), op=Sum)
        if not ctx.is_root:
            reduced = torch.zeros_like(reduced)
        return reduced, None, None


def broadcast(tensor: Tensor, root_rank: int = 0,
              name: Optional[str] = None) -> Tensor:
    """``root_rank``'s tensor, on every rank; differentiable."""
    if tensor.requires_grad:
        return _BroadcastFunction.apply(tensor, root_rank, name)
    return synchronize(broadcast_async(tensor, root_rank, name))


def broadcast_(tensor: Tensor, root_rank: int = 0,
               name: Optional[str] = None) -> Tensor:
    return synchronize(broadcast_async_(tensor, root_rank, name))


# ------------------------------------------------------------------- alltoall
def alltoall_async(tensor: Tensor, splits: Optional[Tensor] = None,
                   name: Optional[str] = None) -> int:
    # the splits are metadata: read to the host at submission
    sp = None if splits is None else [int(s) for s in splits.tolist()]
    return _dispatch(name, "alltoall", "alltoall", [tensor.detach()],
                     splits=sp)


class _AlltoallFunction(torch.autograd.Function):
    """Backward: alltoall the gradient with the received splits."""

    @staticmethod
    def forward(ctx, tensor, splits, name):
        output, recv = synchronize(alltoall_async(tensor, splits, name))
        ctx.recv_splits = recv
        ctx.mark_non_differentiable(recv)
        return output, recv

    @staticmethod
    def backward(ctx, grad_output, _grad_splits):
        out, _ = synchronize(alltoall_async(grad_output.contiguous(),
                                            ctx.recv_splits))
        return out, None, None


def alltoall(tensor: Tensor, splits: Optional[Tensor] = None,
             name: Optional[str] = None):
    """Send ``splits[i]`` rows (default: an equal share) to rank i and
    receive each rank's rows for this one; returns ``(output,
    received_splits)`` when ``splits`` is given, else the output."""
    if tensor.requires_grad:
        output, recv = _AlltoallFunction.apply(tensor, splits, name)
    else:
        output, recv = synchronize(alltoall_async(tensor, splits, name))
    return (output, recv) if splits is not None else output


# -------------------------------------------------------------- reducescatter
def reducescatter_async(tensor: Tensor, name: Optional[str] = None,
                        op: ReduceOp = Average,
                        prescale_factor: float = 1.0,
                        postscale_factor: float = 1.0) -> int:
    return _dispatch(name, "reducescatter", "reducescatter",
                     [tensor.detach()], reduce_op=_resolve_op(None, op),
                     pre=prescale_factor, post=postscale_factor)


def reducescatter(tensor: Tensor, name: Optional[str] = None,
                  op: ReduceOp = Average, prescale_factor: float = 1.0,
                  postscale_factor: float = 1.0) -> Tensor:
    """The reduction of every rank's tensor, rows split over the ranks:
    rank i keeps rows ``[i * r, (i + 1) * r)``, r = rows / size."""
    return synchronize(reducescatter_async(tensor, name, op, prescale_factor,
                                           postscale_factor))


# --------------------------------------------------------------- sync helpers
def synchronize(handle: int):
    """Wait for an async op and return its result.  On the card the
    caller's stream waits for the op's done event; the host does not."""
    eng = engine()
    op, finish = eng.handle_op(handle)
    try:
        result = eng.wait(op)
    finally:
        eng.release(handle)
    return finish(result) if finish is not None else result


def poll(handle: int) -> bool:
    """True when the op behind ``handle`` has finished."""
    eng = engine()
    return eng.poll(eng.handle_op(handle)[0])


def barrier(name: Optional[str] = None) -> None:
    """Every rank reaches this point before any passes it (on the card: in
    the caller's stream order)."""
    rt = _rt.get()
    token = torch.zeros(1, dtype=torch.int32, device=rt.device)
    synchronize(_dispatch(name, "barrier", "barrier", [token]))


def join(device: int = -1) -> int:
    """Signal that this rank has no more collectives and block until every
    rank has joined, meanwhile taking part in the others' collectives with
    zeros; returns the last rank to join."""
    del device  # collectives run on the runtime's device
    return engine().join()


def stats() -> Dict[str, Any]:
    """Counts of what the engine ran: ``responses`` (controller
    responses), ``names`` (ops in them), ``collectives`` (launched after
    packing), ``zero_names`` (ops this rank answered with zeros), and
    ``wait_ms``, the host's time blocked waiting for responses."""
    return dict(engine().stats)

