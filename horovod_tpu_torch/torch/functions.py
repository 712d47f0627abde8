"""Broadcast parameters, optimizer state and objects on the eager API: the
port of ``horovod_tpu/torch/functions.py`` (the reference's
``horovod.torch`` functions).  Every collective here is negotiated, so the
ranks may reach them in any order; the broadcasts of one call are submitted
together, and the controller fuses them.
"""

from __future__ import annotations

import collections.abc
import pickle
from typing import Any, Iterable, List, Mapping, Tuple, Union

import torch

from .. import runtime as _rt
from ..functions import create_optimizer_state, state_items
from . import mpi_ops


def _broadcast_all(named: Iterable[Tuple[str, torch.Tensor]],
                   root_rank: int) -> None:
    """In-place broadcasts of ``(name, tensor)`` pairs, all submitted before
    the first wait.  A tensor off the runtime's device (a CPU step count
    under NCCL) goes through a copy on the device."""
    device = _rt.get().device
    pending = []
    for name, t in named:
        wire = t if t.device == device else t.to(device)
        pending.append((t, wire, mpi_ops.broadcast_async_(
            wire, root_rank=root_rank, name=name)))
    for t, wire, handle in pending:
        mpi_ops.synchronize(handle)
        if wire is not t:
            t.copy_(wire)


@torch.no_grad()
def broadcast_parameters(params: Union[Mapping[str, torch.Tensor],
                                       Iterable[Tuple[str, torch.Tensor]]],
                         root_rank: int = 0) -> None:
    """Overwrite a ``state_dict()`` or ``named_parameters()`` in place with
    ``root_rank``'s; non-tensor entries of a mutable mapping are replaced
    by the root's through one object broadcast."""
    items = sorted(params.items()) if isinstance(params, Mapping) \
        else list(params)
    scalars = {}
    tensors = []
    for name, p in items:
        if torch.is_tensor(p):
            tensors.append((f"bcast.{name}", p.data))
        elif p is not None:
            scalars[name] = p
    _broadcast_all(tensors, root_rank)
    if scalars:
        synced = broadcast_object(scalars, root_rank, name="bcast.scalars")
        if isinstance(params, collections.abc.MutableMapping):
            params.update(synced)


@torch.no_grad()
def broadcast_optimizer_state(optimizer: torch.optim.Optimizer,
                              root_rank: int = 0) -> None:
    """Overwrite every rank's optimizer state in place with
    ``root_rank``'s.  A rank whose optimizer has not stepped creates its
    state first, with one zero-gradient step of the wrapped class, so every
    rank makes the same broadcasts; that step may move the parameters, so
    broadcast them afterwards."""
    create_optimizer_state(optimizer)
    tensors, scalars = [], {}
    for where, state, key in state_items(optimizer):
        if torch.is_tensor(state[key]):
            tensors.append(("opt.{}.{}.{}".format(*where), state[key]))
        else:
            scalars[where] = state[key]
    _broadcast_all(tensors, root_rank)
    if scalars:
        synced = broadcast_object(scalars, root_rank, name="opt.scalars")
        for where, state, key in state_items(optimizer):
            if where in synced:
                state[key] = synced[where]


def broadcast_object(obj: Any, root_rank: int = 0,
                     name: str = "broadcast_object") -> Any:
    """``root_rank``'s picklable ``obj`` on every rank: the pickle's length
    is broadcast first, then its bytes."""
    rt = _rt.get()
    is_root = rt.rank() == root_rank
    payload = pickle.dumps(obj) if is_root else b""
    size = mpi_ops.broadcast(
        torch.tensor([len(payload)], dtype=torch.int64, device=rt.device),
        root_rank, name=f"{name}.sz")
    buf = torch.zeros(int(size.item()), dtype=torch.uint8, device=rt.device)
    if is_root:
        buf.copy_(torch.frombuffer(bytearray(payload), dtype=torch.uint8))
    buf = mpi_ops.broadcast(buf, root_rank, name=f"{name}.data")
    return pickle.loads(buf.cpu().numpy().tobytes())


def allgather_object(obj: Any, name: str = "allgather_object") -> List[Any]:
    """Every rank's picklable ``obj``, in rank order."""
    rt = _rt.get()
    payload = torch.frombuffer(bytearray(pickle.dumps(obj)),
                               dtype=torch.uint8).to(rt.device)
    sizes = mpi_ops.allgather(
        torch.tensor([payload.numel()], dtype=torch.int64, device=rt.device),
        name=f"{name}.sz").tolist()
    padded = torch.zeros((1, max(sizes)), dtype=torch.uint8, device=rt.device)
    padded[0, :payload.numel()] = payload
    rows = mpi_ops.allgather(padded, name=f"{name}.data").cpu()
    return [pickle.loads(rows[i, :n].numpy().tobytes())
            for i, n in enumerate(sizes)]
