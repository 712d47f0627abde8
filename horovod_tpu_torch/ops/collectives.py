"""Eager collectives over the runtime's process group: the port of
``horovod_tpu/ops/collectives.py``'s data plane.

The semantics are per process, as in reference Horovod: a rank is a
process, it passes one tensor per call, and ``size()`` counts processes.
(The JAX package works per chip: a process's tensor is held by each of its
local chips, and ``Sum`` sums over chips, ``horovod_tpu/torch/mpi_ops.py``
:10-14.  The two agree where each process drives one chip.)  The group is
NCCL on a CUDA device and gloo on the CPU, and CUDA tensors stay on the
card: there is no host copy of the data.

The negotiated API (``ops/negotiated.py``) runs these on its side stream:
``allreduce_`` and ``broadcast_`` (a list of same-dtype tensors, packed
into one buffer for one collective), ``allgather``, ``allgather_ragged``,
``alltoall``, ``reducescatter`` and ``barrier_``.  Each enqueues its work
on the current stream.  Only the ragged gather and ``alltoall`` with
splits read sizes back to the host; the data stays on the card.
``launch`` and ``wait_for`` are the side stream's two ends: the collective
waits for the caller's stream, and the caller's stream waits for the
collective.

The measurement plane's hooks are here, as in the JAX module: each
collective runs inside a ``HOROVOD_<KIND>`` profiler range (NVTX on a
card; ``utils/profiler.py``) and counts into ``hvd_collective_ops_total``,
``hvd_collective_bytes_total`` and ``hvd_collective_latency_seconds`` (the
host-side latency of the call: on a CUDA device the enqueue, since the
collective itself runs on the side stream), and ``launch`` with ``names``
traces the batch it runs as one EXEC span per name on the runtime's
timeline.  The EXEC span's width is the collective's: on a CUDA device a
start event recorded on the side stream before the batch and the done
event recorded after it, resolved by the timeline's writer thread once
the done event has completed (``Timeline.record_op`` with ``events``),
with no synchronization for the trace's sake; on the CPU the batch has
finished when ``launch`` returns and the host-measured duration stands.
Either span is anchored at the host time of the enqueue.
"""

from __future__ import annotations

import functools
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..common.reduce_op import Average, ReduceOp
from ..utils import metrics as _metrics
from ..utils import profiler as _profiler
from . import fusion, spmd

Tensor = torch.Tensor


def _rec(op: str, nbytes: int, t0: float) -> None:
    """Metrics of one collective call: count, payload bytes and host-side
    latency since ``t0`` (``time.perf_counter``)."""
    _metrics.COLLECTIVE_OPS.inc(op=op)
    _metrics.COLLECTIVE_BYTES.inc(nbytes, op=op)
    _metrics.COLLECTIVE_LATENCY.observe(time.perf_counter() - t0, op=op)


def _ranged(kind: str):
    """Run the collective inside a ``HOROVOD_<KIND>`` range
    (``utils/profiler.py`` ``annotate``), as the JAX collectives open
    theirs: a profiler capture attributes the device work to the op."""
    name = f"HOROVOD_{kind.upper()}"

    def wrap(fn):
        @functools.wraps(fn)
        def ranged(*args, **kwargs):
            with _profiler.annotate(name):
                return fn(*args, **kwargs)
        return ranged
    return wrap


def _nbytes(tensors: Sequence[Tensor]) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _size() -> int:
    return dist.get_world_size()


def _bucket(tensors: Sequence[Tensor]) -> fusion.Bucket:
    """All of ``tensors`` as one fusion bucket (they share a dtype)."""
    bucket = fusion.Bucket(tensors[0].dtype)
    for i, t in enumerate(tensors):
        bucket.add(i, tuple(t.shape), t.numel() * t.element_size())
    return bucket


def _packed(fn: Callable[[Tensor], Tensor], tensors: Sequence[Tensor],
            outputs: List[Tensor]) -> List[Tensor]:
    """Apply ``fn`` (an in-place collective on a flat buffer) to one new
    buffer holding every tensor and copy the result into ``outputs``."""
    bucket = _bucket(tensors)
    buf = fusion.pack_bucket(tensors, bucket)
    if len(tensors) == 1:  # a view of the caller's tensor: work on a copy
        buf = buf.clone()
    pieces: List[Optional[Tensor]] = [None] * len(tensors)
    fusion.unpack_bucket(fn(buf), bucket, pieces)
    for o, piece in zip(outputs, pieces):
        o.copy_(piece)
    return outputs


# ----------------------------------------------------------------- data plane
@_ranged("allreduce")
def allreduce_(tensors: Sequence[Tensor], op: ReduceOp = Average,
               prescale_factor: float = 1.0, postscale_factor: float = 1.0,
               outputs: Optional[Sequence[Tensor]] = None) -> List[Tensor]:
    """Reduce same-dtype ``tensors`` across ranks into ``outputs`` (default:
    in place): one collective over one packed buffer, or over the output
    itself when there is one contiguous output."""
    t0 = time.perf_counter()
    outputs = list(tensors if outputs is None else outputs)
    if len(tensors) == 1 and outputs[0].is_contiguous():
        if outputs[0] is not tensors[0]:
            outputs[0].copy_(tensors[0])
        spmd.allreduce(outputs[0], op, prescale_factor, postscale_factor)
    else:
        _packed(lambda buf: spmd.allreduce(buf, op, prescale_factor,
                                           postscale_factor),
                tensors, outputs)
    _rec("allreduce", _nbytes(tensors), t0)
    return outputs


@_ranged("broadcast")
def broadcast_(tensors: Sequence[Tensor], root_rank: int = 0,
               outputs: Optional[Sequence[Tensor]] = None) -> List[Tensor]:
    """Overwrite ``outputs`` (default: ``tensors``) on every rank with
    ``root_rank``'s ``tensors``: one collective, packed as ``allreduce_``."""
    t0 = time.perf_counter()
    outputs = list(tensors if outputs is None else outputs)
    if len(tensors) == 1 and outputs[0].is_contiguous():
        if outputs[0] is not tensors[0]:
            outputs[0].copy_(tensors[0])
        dist.broadcast(outputs[0], src=root_rank)
    else:
        def bcast(buf: Tensor) -> Tensor:
            dist.broadcast(buf, src=root_rank)
            return buf
        _packed(bcast, tensors, outputs)
    _rec("broadcast", _nbytes(tensors), t0)
    return outputs


@_ranged("allgather")
def allgather(tensor: Tensor) -> Tensor:
    """Every rank's ``tensor`` (the same shape on every rank) concatenated
    along dim 0, in rank order; a 0-dim tensor counts as one row.  Two-level
    under HOROVOD_HIERARCHICAL_ALLGATHER (``spmd.allgather``)."""
    t0 = time.perf_counter()
    out = spmd.allgather(tensor.reshape(1) if tensor.dim() == 0 else tensor)
    _rec("allgather", _nbytes([tensor]), t0)
    return out


@_ranged("allgather")
def allgather_ragged(tensor: Tensor) -> Tensor:
    """``allgather`` whose dim 0 may differ across ranks: the row counts
    are gathered first (read back to the host), then the rows, padded to
    the longest."""
    t = tensor.contiguous()
    rows = allgather(torch.tensor([t.shape[0]], dtype=torch.int64,
                                  device=t.device)).tolist()
    longest = max(rows)
    if t.shape[0] < longest:
        pad = t.new_zeros((longest - t.shape[0],) + tuple(t.shape[1:]))
        t = torch.cat([t, pad])
    full = allgather(t).view((len(rows), longest) + tuple(t.shape[1:]))
    return torch.cat([full[i, :n] for i, n in enumerate(rows)])


@_ranged("alltoall")
def alltoall(tensor: Tensor, splits: Optional[Sequence[int]] = None
             ) -> Tuple[Tensor, Tensor]:
    """Send ``splits[i]`` rows (default: an equal share) of ``tensor`` to
    rank i and receive rank i's rows for this rank; returns ``(output,
    received_splits)``, the splits as an int64 CPU tensor."""
    n = _size()
    t = tensor.contiguous()
    if splits is None:
        if t.shape[0] % n:
            raise ValueError(f"alltoall without splits needs rows "
                             f"({t.shape[0]}) divisible by size ({n})")
        send = [t.shape[0] // n] * n
    else:
        send = [int(s) for s in splits]
        if len(send) != n or sum(send) != t.shape[0]:
            raise ValueError(f"splits {send} must have {n} entries summing "
                             f"to the {t.shape[0]} rows")
    if splits is None:
        recv = send
    else:
        theirs = torch.empty(n, dtype=torch.int64, device=t.device)
        dist.all_to_all_single(theirs, torch.tensor(send, dtype=torch.int64,
                                                    device=t.device))
        recv = theirs.tolist()
    out = t.new_empty((sum(recv),) + tuple(t.shape[1:]))
    t0 = time.perf_counter()
    dist.all_to_all_single(out, t, recv, send)
    _rec("alltoall", _nbytes([t]), t0)
    return out, torch.tensor(recv, dtype=torch.int64)


@_ranged("reducescatter")
def reducescatter(tensor: Tensor, op: ReduceOp = Average,
                  prescale_factor: float = 1.0,
                  postscale_factor: float = 1.0) -> Tensor:
    """Reduce across ranks and keep this rank's share of the rows: rank i
    gets rows ``[i * r, (i + 1) * r)``, r = rows / size."""
    n = _size()
    if tensor.dim() == 0 or tensor.shape[0] % n:
        raise ValueError(f"reducescatter needs rows divisible by size ({n})")
    rows = tensor.shape[0] // n
    t0 = time.perf_counter()
    if dist.get_backend() != "nccl":  # gloo: reduce every row, keep ours
        buf = allreduce_([tensor.clone(memory_format=torch.contiguous_format)],
                         op, prescale_factor, postscale_factor)[0]
        return buf.narrow(0, dist.get_rank() * rows, rows).clone()
    buf = spmd.scale_(tensor.clone(memory_format=torch.contiguous_format),
                      prescale_factor)
    out = buf.new_empty((rows,) + tuple(tensor.shape[1:]))
    dist.reduce_scatter_tensor(out, buf, op=spmd.torch_op(op))
    out = spmd.scale_(out, postscale_factor,
                      n if op == ReduceOp.AVERAGE else 1)
    _rec("reducescatter", _nbytes([tensor]), t0)
    return out


@_ranged("barrier")
def barrier_(device: torch.device) -> None:
    """Every rank reaches this point before any passes it (on the card: in
    stream order)."""
    t0 = time.perf_counter()
    dist.all_reduce(torch.zeros(1, dtype=torch.int32, device=device))
    _rec("barrier", 0, t0)


# --------------------------------------------------------- side streams
_SIDE: Dict[torch.device, "torch.cuda.Stream"] = {}


def side_stream(device: torch.device) -> "torch.cuda.Stream":
    """The stream collectives of ``device`` run on, one per device."""
    stream = _SIDE.get(device)
    if stream is None:
        stream = _SIDE[device] = torch.cuda.Stream(device)
    return stream


def launch(fn: Callable[[], object], tensors: Sequence[Tensor],
           device: torch.device,
           ready: Optional[Sequence["torch.cuda.Event"]] = None,
           names: Sequence[str] = (), nbytes: int = 0):
    """Run ``fn`` and return ``(result, done event)``.  On a CUDA device
    ``fn`` runs on the side stream, after ``ready`` (events recorded on the
    callers' streams when the inputs were handed over; default: the
    current stream's work so far); ``tensors`` are the caller's tensors it
    touches, kept from the allocator until the side stream is past them.
    On the CPU ``fn`` has finished when this returns, and the event is
    None.  With ``names`` and an active timeline, ``fn``'s work is traced
    as an EXEC span of ``nbytes`` on each name's lane (module docstring)."""
    from .. import runtime as _rt
    tl = _rt.get().timeline if names and _rt.is_initialized() else None
    if device.type != "cuda":
        if tl is None:
            return fn(), None
        ts_us, t0 = tl.now_us(), time.perf_counter()
        result = fn()
        dur_us = (time.perf_counter() - t0) * 1e6
        for name in names:
            tl.record_op(name, "EXEC", nbytes, duration_us=dur_us,
                         ts_us=ts_us)
        return result, None
    side = side_stream(device)
    if ready is None:
        side.wait_stream(torch.cuda.current_stream(device))
    else:
        for ev in ready:
            side.wait_event(ev)
    start = None
    if tl is not None:
        ts_us = tl.now_us()
        start = torch.cuda.Event(enable_timing=True)
        start.record(side)
    with torch.cuda.stream(side):
        result = fn()
    for t in tensors:
        t.record_stream(side)
    done = torch.cuda.Event(enable_timing=start is not None)
    done.record(side)
    if start is not None:
        for name in names:
            tl.record_op(name, "EXEC", nbytes, ts_us=ts_us,
                         events=(start, done))
    return result, done


def _tensors_of(result) -> List[Tensor]:
    if torch.is_tensor(result):
        return [result]
    if isinstance(result, (list, tuple)):
        return [t for r in result for t in _tensors_of(r)]
    return []


def wait_for(result, done: Optional["torch.cuda.Event"],
             device: torch.device):
    """Make the current stream of ``device`` wait for ``done`` and hand
    ``result`` to it (its tensors were made on the side stream)."""
    if done is not None:
        stream = torch.cuda.current_stream(device)
        stream.wait_event(done)
        for t in _tensors_of(result):
            if t.is_cuda:
                t.record_stream(stream)
    return result
