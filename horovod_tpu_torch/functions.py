"""Broadcast parameters, optimizer state and objects from a root rank, and
gather objects: the port of ``horovod_tpu/functions.py``
(``broadcast_parameters``, ``broadcast_optimizer_state``,
``broadcast_object``, ``allgather_object``), Horovod's startup and resume
convention: rank 0 loads, every other rank receives.

These call the process group directly, in the same order on every rank;
the eager API's negotiated forms are in ``horovod_tpu_torch.torch``.
"""

from __future__ import annotations

import pickle
from typing import Any, Iterable, List, Mapping, Optional, Tuple, Union

import torch
import torch.distributed as dist

from . import runtime as _rt

Params = Union[Mapping[str, torch.Tensor], Iterable[Tuple[str, torch.Tensor]],
               Iterable[torch.Tensor]]


def _tensors(params: Params):
    if isinstance(params, Mapping):
        return [t for _, t in sorted(params.items())]
    out = []
    for item in params:
        out.append(item[1] if isinstance(item, tuple) else item)
    return out


@torch.no_grad()
def broadcast_parameters(params: Params, root_rank: int = 0) -> None:
    """Overwrite every rank's tensors in place with ``root_rank``'s.
    ``params`` is a ``state_dict()``, ``named_parameters()`` or a sequence
    of tensors, in the same order on every rank."""
    for t in _tensors(params):
        dist.broadcast(t.data, src=root_rank)


def _broadcast_any_device(t: torch.Tensor, root_rank: int) -> None:
    # NCCL broadcasts CUDA tensors only; torch keeps some optimizer state
    # (AdamW's step count) on the CPU.
    if t.device.type == "cpu" and dist.get_backend() == "nccl":
        tmp = t.to(_rt.resolve_device())
        dist.broadcast(tmp, src=root_rank)
        t.copy_(tmp)
    else:
        dist.broadcast(t, src=root_rank)


def create_optimizer_state(optimizer: torch.optim.Optimizer) -> None:
    """Give an optimizer that has not stepped yet its state, as the
    reference does: one step of the wrapped class (not of a distributed
    wrapper, whose step would wait for the other ranks) with zero
    gradients.  The step may move the parameters (AdamW's weight decay
    applies to a zero gradient too): broadcast them afterwards."""
    if optimizer.state:
        return
    if isinstance(optimizer, torch.optim.LBFGS):
        raise ValueError("cannot broadcast torch.optim.LBFGS state")
    given = []
    for group in optimizer.param_groups:
        for p in group["params"]:
            if p.requires_grad and p.grad is None:
                p.grad = torch.zeros_like(p)
                given.append(p)
    cls = type(optimizer)
    while cls.__dict__.get("_hvd_wrapper"):
        cls = cls.__mro__[1]
    cls.step(optimizer)
    for p in given:
        p.grad = None


def state_items(optimizer: torch.optim.Optimizer):
    """``((group, index, key), state, key)`` for every state entry of every
    parameter, in the same order on every rank: parameters by their place
    in ``param_groups``, keys sorted."""
    for gi, group in enumerate(optimizer.param_groups):
        for pi, p in enumerate(group["params"]):
            state = optimizer.state.get(p, {})
            for key in sorted(state):
                yield (gi, pi, key), state, key


@torch.no_grad()
def broadcast_optimizer_state(optimizer: torch.optim.Optimizer,
                              root_rank: int = 0) -> None:
    """Overwrite every rank's optimizer state in place with ``root_rank``'s:
    tensors by broadcast, other values by one object broadcast.  A rank
    whose optimizer has not stepped creates its state first
    (``create_optimizer_state``), so every rank makes the same
    broadcasts."""
    create_optimizer_state(optimizer)
    scalars = {}
    for where, state, key in state_items(optimizer):
        if torch.is_tensor(state[key]):
            _broadcast_any_device(state[key], root_rank)
        else:
            scalars[where] = state[key]
    if scalars:
        scalars = broadcast_object(scalars, root_rank)
        for where, state, key in state_items(optimizer):
            if where in scalars:
                state[key] = scalars[where]


def _bytes_tensor(payload: bytes, device: torch.device) -> torch.Tensor:
    return torch.frombuffer(bytearray(payload), dtype=torch.uint8).to(device)


def broadcast_object(obj: Any, root_rank: int = 0,
                     name: Optional[str] = None) -> Any:
    """``root_rank``'s picklable ``obj`` on every rank: the pickle's length
    is broadcast first, then its bytes."""
    del name  # the collectives here are not negotiated
    rt = _rt.get()
    if rt.size() == 1:
        return obj
    payload = pickle.dumps(obj) if rt.rank() == root_rank else b""
    size = torch.tensor([len(payload)], dtype=torch.int64, device=rt.device)
    dist.broadcast(size, src=root_rank)
    buf = torch.zeros(int(size.item()), dtype=torch.uint8, device=rt.device)
    if rt.rank() == root_rank:
        buf.copy_(_bytes_tensor(payload, rt.device))
    dist.broadcast(buf, src=root_rank)
    return pickle.loads(buf.cpu().numpy().tobytes())


def allgather_object(obj: Any, name: Optional[str] = None) -> List[Any]:
    """Every rank's picklable ``obj``, in rank order."""
    del name
    rt = _rt.get()
    if rt.size() == 1:
        return [obj]
    payload = pickle.dumps(obj)
    sizes = [torch.zeros(1, dtype=torch.int64, device=rt.device)
             for _ in range(rt.size())]
    dist.all_gather(sizes, torch.tensor([len(payload)], dtype=torch.int64,
                                        device=rt.device))
    lengths = [int(s.item()) for s in sizes]
    buf = torch.zeros(max(lengths), dtype=torch.uint8, device=rt.device)
    buf[:len(payload)] = _bytes_tensor(payload, rt.device)
    parts = [torch.empty_like(buf) for _ in range(rt.size())]
    dist.all_gather(parts, buf)
    return [pickle.loads(p[:n].cpu().numpy().tobytes())
            for p, n in zip(parts, lengths)]
