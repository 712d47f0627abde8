"""Negotiated dispatch over the native controller: the port of
``horovod_tpu/ops/negotiated.py``, and the engine under the eager torch API
(``horovod_tpu_torch/torch/mpi_ops.py``).

Ranks reach their collectives in different orders (autograd hooks fire in
whatever order the backward produces gradients).  Each op is therefore
submitted to the controller under its name with a signature, and runs only
when its response arrives; every rank receives the same responses in the
same order, so every rank issues the same collectives in the same order.
A response is a batch of names the controller fused (same op, same leading
dtype, under the fusion threshold); the batch's allreduces and broadcasts
are packed into one buffer per reduction (or root) and dtype, for one
collective each.

Signatures use the JAX package's dialect, ``dtype:shape:kind:extra``
(joined by ``+`` for a group): ``extra`` is the reduce op or the root rank.
A rank that has joined (``join``) answers responses for names it never
submitted with zero tensors rebuilt from the signatures, packed into the
response's collectives as its peers pack their tensors, so their
collectives complete.

On a CUDA device an op's collective runs on a side stream, which first
waits for an event recorded on the submitting stream when the op was
handed over; finishing records a done event, and ``wait`` makes the
caller's stream wait for it.  Nothing crosses to the host but sizes
(ragged gathers, alltoall splits).

``Engine`` pumps responses on the caller's thread: at every submission
(without waiting) and in ``wait``, ``poll`` and ``join``.  Without a
controller (one process, ``HOROVOD_CONTROLLER`` not ``tcp``) an op runs at
submission.  The synchronous form of an op is ``wait(submit(op))``.

With a timeline active, each negotiated name gets the reference's
lifecycle on its lane (the JAX negotiated path's,
``horovod_tpu/ops/negotiated.py``): NEGOTIATE from submission to the
agreed response, QUEUE from the response to the enqueue of its batch, and
the EXEC span of the batch's collectives (``collectives.launch``); each
response batch marks a cycle (``HOROVOD_TIMELINE_MARK_CYCLES``).  The
stall inspector watches every name from submission to its response, and
the submission-to-response age lands in ``hvd_negotiation_age_seconds``.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..common import basics as _basics
from ..common.exceptions import HorovodInternalError
from ..common.reduce_op import ReduceOp, Sum
from ..utils import metrics as _metrics
from . import collectives as C
from . import spmd

Tensor = torch.Tensor

SIG_DTYPE = {
    torch.float32: "f32", torch.float64: "f64", torch.float16: "f16",
    torch.bfloat16: "bf16", torch.int32: "i32", torch.int64: "i64",
    torch.int16: "i16", torch.int8: "i8", torch.uint8: "u8",
    torch.bool: "b1",
}
_SIG_DTYPE_INV = {v: k for k, v in SIG_DTYPE.items()}

# the op code a kind is submitted under
OP_OF_KIND = {
    "allreduce": _basics.OP_ALLREDUCE,
    "grouped_allreduce": _basics.OP_ALLREDUCE,
    "allgather": _basics.OP_ALLGATHER,
    "allgather_ragged": _basics.OP_ALLGATHER,
    "broadcast": _basics.OP_BROADCAST,
    "alltoall": _basics.OP_ALLTOALL,
    "reducescatter": _basics.OP_REDUCESCATTER,
    "barrier": _basics.OP_BARRIER,
}


def signature(t: Tensor, kind: str, extra: str = "") -> str:
    """One tensor's consistency key.  Its leading token is the dtype (the
    controller fuses same-dtype batches); a ragged gather and an alltoall
    write dim 0 as 0, so ranks with different row counts agree."""
    dims = list(t.shape)
    if kind in ("allgather_ragged", "alltoall") and dims:
        dims[0] = 0
    shape = "x".join(str(s) for s in dims)
    return f"{SIG_DTYPE.get(t.dtype, str(t.dtype))}:{shape}:{kind}:{extra}"


def parse_signature(sig: str) -> Tuple[torch.dtype, Tuple[int, ...], str, str]:
    """``(dtype, shape, kind, extra)`` of one tensor's signature."""
    dt, shape, kind, extra = sig.split(":", 3)
    if dt not in _SIG_DTYPE_INV:
        raise HorovodInternalError(f"unknown dtype token {dt!r} in {sig!r}")
    dims = tuple(int(s) for s in shape.split("x") if s)
    return _SIG_DTYPE_INV[dt], dims, kind, extra


def zeros_from_signature(sig: str, device: torch.device) -> List[Tensor]:
    """The zero tensors a joined rank contributes for a (possibly grouped)
    signature."""
    out = []
    for part in sig.split("+"):
        dtype, dims, _, _ = parse_signature(part)
        out.append(torch.zeros(dims, dtype=dtype, device=device))
    return out


class Op:
    """One named collective of this rank: what it was asked to do, its
    result and its completion."""

    __slots__ = ("name", "kind", "tensors", "outputs", "reduce_op", "pre",
                 "post", "root", "splits", "sig", "nbytes", "ready", "done",
                 "finished", "result", "error", "submitted")

    def __init__(self, name: str, kind: str, tensors: Sequence[Tensor],
                 outputs: Optional[Sequence[Tensor]] = None,
                 reduce_op: ReduceOp = Sum, pre: float = 1.0,
                 post: float = 1.0, root: int = 0,
                 splits: Optional[Sequence[int]] = None):
        self.name = name
        self.kind = kind
        self.tensors = list(tensors)
        self.outputs = None if outputs is None else list(outputs)
        self.reduce_op = ReduceOp(reduce_op)
        self.pre, self.post, self.root = pre, post, root
        self.splits = splits
        extra = {"allreduce": str(int(reduce_op)),
                 "grouped_allreduce": str(int(reduce_op)),
                 "reducescatter": str(int(reduce_op)),
                 "broadcast": str(root)}.get(kind, "")
        self.sig = "+".join(signature(t, kind, extra) for t in self.tensors)
        self.nbytes = sum(t.numel() * t.element_size() for t in self.tensors)
        self.ready = None
        self.done = None
        self.finished = False
        self.result: Any = None
        self.error: Optional[BaseException] = None
        self.submitted = 0.0  # time.monotonic() at submission


def _dummy(sig: str, device: torch.device) -> Op:
    """The op a joined rank runs for a name it never submitted."""
    tensors = zeros_from_signature(sig, device)
    _, _, kind, extra = parse_signature(sig.split("+")[0])
    if kind == "alltoall":
        raise HorovodInternalError(
            "alltoall is not supported while this rank has joined (Join "
            "covers allreduce, allgather, broadcast and reducescatter)")
    op = int(extra) if extra and kind != "broadcast" else int(Sum)
    return Op("", kind, tensors, reduce_op=ReduceOp(op),
              root=int(extra) if kind == "broadcast" and extra else 0)


def run_batch(op_type: int, ops: Sequence[Op]) -> int:
    """Run one response's collectives on the current stream, in order, and
    return how many were launched.  Allreduces are packed by (reduce op,
    dtype) and broadcasts by (root, dtype): keys every rank reads from the
    same signatures, so every rank packs alike (Adasum, whose dot
    products are per tensor, runs one recursion per tensor).  Other kinds
    run one collective each.  Sets each op's ``result``."""
    if op_type not in (_basics.OP_ALLREDUCE, _basics.OP_BROADCAST):
        for op in ops:
            op.result = _run_one(op)
        return len(ops)
    leaves = []  # (key, src, out, op)
    for op in ops:
        if op.outputs is None:
            op.outputs = [torch.empty_like(
                t, memory_format=torch.contiguous_format) for t in op.tensors]
        first = op.root if op_type == _basics.OP_BROADCAST else op.reduce_op
        leaves += [((first, t.dtype), t, o, op)
                   for t, o in zip(op.tensors, op.outputs)]
    keys = list(dict.fromkeys(leaf[0] for leaf in leaves))
    launched = len(keys)
    for key in keys:
        part = [leaf for leaf in leaves if leaf[0] == key]
        srcs, outs = [p[1] for p in part], [p[2] for p in part]
        if op_type == _basics.OP_BROADCAST:
            C.broadcast_(srcs, key[0], outputs=outs)
            continue
        if key[0] == ReduceOp.ADASUM:
            # Adasum combines each tensor as its own vector: packing would
            # take dot products across tensors
            for p in part:
                C.allreduce_([p[1]], key[0], p[3].pre, p[3].post,
                             outputs=[p[2]])
            launched += len(part) - 1
            continue
        scales = {(p[3].pre, p[3].post) for p in part}
        if len(scales) == 1:
            C.allreduce_(srcs, key[0], *scales.pop(), outputs=outs)
            continue
        # scales are this rank's own: apply them around one collective
        srcs = [s * p[3].pre if p[3].pre != 1.0 else s
                for s, p in zip(srcs, part)]
        C.allreduce_(srcs, key[0], outputs=outs)
        for o, p in zip(outs, part):
            spmd.scale_(o, p[3].post)
    for op in ops:
        op.result = (op.outputs if op.kind == "grouped_allreduce"
                     else op.outputs[0])
    return launched


def _run_one(op: Op):
    t = op.tensors[0]
    if op.kind == "barrier":
        C.barrier_(t.device)
        return None
    if op.kind == "allgather":
        out = C.allgather(t)
    elif op.kind == "allgather_ragged":
        out = C.allgather_ragged(t)
    elif op.kind == "alltoall":
        return C.alltoall(t, op.splits)
    elif op.kind == "reducescatter":
        out = C.reducescatter(t, op.reduce_op, op.pre, op.post)
    else:
        raise HorovodInternalError(f"unknown collective kind {op.kind!r}")
    if op.outputs is not None:
        return op.outputs[0].copy_(out)
    return out


class Engine:
    """This process's eager collectives: the pending ops by name, the
    integer handles of submitted ops (the reference's handle manager), the
    controller they are negotiated through (None: run at submission), and
    counts of what ran."""

    def __init__(self, runtime):
        self._rt = runtime
        self.device: torch.device = runtime.device
        self.core = runtime.ensure_core()
        self._lock = threading.RLock()
        self._pending: Dict[str, Op] = {}
        self._joined = False
        self._counter = 0
        self._handles: Dict[int, Tuple[Op, Optional[Callable]]] = {}
        self._next_handle = itertools.count()
        self.stats = {"responses": 0, "names": 0, "collectives": 0,
                      "zero_names": 0, "wait_ms": 0.0}

    def auto_name(self, prefix: str) -> str:
        with self._lock:
            self._counter += 1
            return f"{prefix}.noname.{self._counter}"

    def handle(self, op: Op, finish: Optional[Callable] = None) -> int:
        """A new integer handle for ``op``; ``finish`` maps its result to
        what the handle's wait returns."""
        with self._lock:
            h = next(self._next_handle)
            self._handles[h] = (op, finish)
            return h

    def handle_op(self, handle: int) -> Tuple[Op, Optional[Callable]]:
        with self._lock:
            if handle not in self._handles:
                raise ValueError(f"unknown handle {handle}")
            return self._handles[handle]

    def release(self, handle: int) -> None:
        with self._lock:
            del self._handles[handle]

    # ------------------------------------------------------------ submit
    def submit(self, op: Op) -> Op:
        """Hand ``op`` over: record its ready event, then run it (no
        controller) or submit it and pump what has arrived."""
        for t in op.tensors + (op.outputs or []):
            if t.device != self.device:
                raise ValueError(
                    f"{op.kind} {op.name!r}: tensor on {t.device}, but the "
                    f"runtime's collectives run on {self.device}")
        if self.device.type == "cuda":
            op.ready = torch.cuda.Event()
            op.ready.record(torch.cuda.current_stream(self.device))
        with self._lock:
            if self._joined:
                raise HorovodInternalError(
                    f"{op.name!r} submitted after this rank joined")
            if self.core is None:
                self._execute(OP_OF_KIND[op.kind], [op], [op.sig],
                              op.nbytes)
                return op
            self._pending[op.name] = op
        op.submitted = time.monotonic()
        rt = self._rt
        if rt.timeline is not None:
            rt.timeline.begin(op.name, "NEGOTIATE")
        if rt.stall_inspector is not None:
            rt.stall_inspector.record_submit(op.name)
        self.core.submit(op.name, op.sig, OP_OF_KIND[op.kind], op.nbytes)
        self.pump()
        return op

    # ----------------------------------------------------------- execute
    def _execute(self, op_type: int, ops: List[Optional[Op]],
                 sigs: Sequence[str], nbytes: int) -> None:
        mine = [op for op in ops if op is not None]
        # a joined rank's zeros are made on the current stream, which the
        # side stream then waits for as a whole
        ready = None if len(mine) < len(ops) else [
            op.ready for op in mine if op.ready is not None]
        ops = [op if op is not None else _dummy(sig, self.device)
               for op, sig in zip(ops, sigs)]
        touched = [t for op in ops for t in op.tensors + (op.outputs or [])]
        try:
            launched, done = C.launch(lambda: run_batch(op_type, ops),
                                      touched, self.device, ready,
                                      names=[op.name for op in mine],
                                      nbytes=nbytes)
        except BaseException as e:
            for op in mine:
                op.error, op.finished = e, True
            raise
        for op in mine:
            op.done, op.finished = done, True
        self.stats["collectives"] += launched

    def _execute_response(self, resp) -> None:
        if resp.type == "ERROR":
            err = HorovodInternalError(f"controller error: {resp.error}")
            for name in resp.names:
                op = self._pending.pop(name, None)
                if op is not None:
                    op.error, op.finished = err, True
            raise err
        if resp.type != "OK":
            return
        ops = [self._pending.pop(name, None) for name in resp.names]
        self.stats["responses"] += 1
        self.stats["names"] += len(resp.names)
        self.stats["zero_names"] += sum(op is None for op in ops)
        rt = self._rt
        tl = rt.timeline
        if tl is not None:
            tl.mark_cycle()
            arrival_us = tl.now_us()
        now = time.monotonic()
        for op in ops:
            if op is None:
                continue
            if rt.stall_inspector is not None:
                rt.stall_inspector.record_complete(op.name)  # observes age
            else:
                _metrics.NEGOTIATION_AGE.observe(now - op.submitted)
            if tl is not None:
                # agreed: negotiation over, queued behind its batch-mates
                tl.end(op.name, "NEGOTIATE", ts_us=arrival_us)
                tl.begin(op.name, "QUEUE", ts_us=arrival_us)
                tl.end(op.name, "QUEUE")
        self._execute(resp.op, ops, resp.sigs, resp.total_bytes)

    def pump(self) -> None:
        """Run every response that has arrived, without waiting."""
        if self.core is None:
            return
        with self._lock:
            resp = self.core.poll()
            while resp is not None:
                self._execute_response(resp)
                resp = self.core.poll()

    def _pump_until(self, finished: Callable[[], bool],
                    timeout_s: float, what: str):
        """Run responses as they arrive until ``finished()``; return a
        JOIN_DONE or SHUTDOWN response if one comes first.  The time spent
        here is the host's wait for negotiation (``stats["wait_ms"]``)."""
        start = time.monotonic()
        try:
            while not finished():
                with self._lock:
                    resp = self.core.poll() or self.core.wait(
                        timeout_s=min(1.0, timeout_s))
                    if resp is not None:
                        if resp.type in ("JOIN_DONE", "SHUTDOWN"):
                            return resp
                        self._execute_response(resp)
                        continue
                if time.monotonic() > start + timeout_s:
                    raise HorovodInternalError(
                        f"timed out after {timeout_s} s waiting for {what} "
                        "(stalled peer?)")
            return None
        finally:
            self.stats["wait_ms"] += (time.monotonic() - start) * 1e3

    def wait(self, op: Op, timeout_s: float = 300.0):
        """Pump until ``op`` ran, make the current stream wait for it, and
        return its result."""
        if not op.finished:
            self._pump_until(lambda: op.finished, timeout_s,
                             f"negotiated collective {op.name!r}")
        if not op.finished:
            raise HorovodInternalError(
                f"{op.name!r} never ran: every rank joined or the controller "
                "shut down")
        if op.error is not None:
            raise op.error
        return C.wait_for(op.result, op.done, self.device)

    def poll(self, op: Op) -> bool:
        self.pump()
        return op.finished and (op.done is None or op.done.query())

    def drain(self, timeout_s: float = 300.0) -> None:
        """Pump until every op submitted so far has run."""
        if self.core is not None:
            self._pump_until(lambda: not self._pending, timeout_s,
                             "the pending collectives")

    def join(self, timeout_s: float = 300.0) -> int:
        """No more collectives from this rank: answer peers' collectives
        with zeros until every rank has joined; returns the last rank to
        join."""
        if self.core is None:
            return self._rt.size() - 1
        self.drain(timeout_s)
        with self._lock:
            self._joined = True
        try:
            self.core.join()
            resp = self._pump_until(lambda: False, timeout_s,
                                    "the other ranks to join")
        finally:
            with self._lock:
                self._joined = False
        if resp is None or resp.type != "JOIN_DONE":
            raise HorovodInternalError("the controller shut down during join")
        return resp.total_bytes
