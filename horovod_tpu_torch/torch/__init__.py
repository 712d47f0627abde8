"""The eager torch API: the port of ``horovod_tpu/torch`` (the reference's
``horovod.torch`` surface) on the port's runtime.

    import horovod_tpu_torch.torch as hvd
    hvd.init()                       # cuda:<local_rank>; device="cpu": gloo
    opt = hvd.DistributedOptimizer(opt, named_parameters=model.named_parameters())
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    hvd.broadcast_optimizer_state(opt, root_rank=0)

Collectives are negotiated through the port's own native controller
(``ops/negotiated.py``) and run on the runtime's device; a rank is a
process.  ``op=Adasum`` runs the XOR-partner recursion of
``parallel/adasum.py`` per tensor, and ``DistributedOptimizer(op=Adasum)``
combines each step's local update.  ``elastic`` holds ``TorchState``,
``ElasticSampler`` and ``run`` (``torch/elastic.py``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .. import (init, shutdown, is_initialized, rank, size, local_rank,
                local_size, cross_rank, cross_size, is_homogeneous)
from .. import runtime as _rt
from ..common.exceptions import HorovodInternalError, HostsUpdatedInterrupt
from ..common.reduce_op import (ReduceOp, Average, Sum, Adasum, Min, Max,
                                Product)
from .compression import Compression
from .mpi_ops import (allreduce, allreduce_, allreduce_async,
                      allreduce_async_, grouped_allreduce,
                      grouped_allreduce_, grouped_allreduce_async,
                      grouped_allreduce_async_, allgather, allgather_async,
                      broadcast, broadcast_, broadcast_async,
                      broadcast_async_, alltoall, alltoall_async,
                      reducescatter, reducescatter_async,
                      sparse_allreduce_async, synchronize, poll, join,
                      barrier)
from .optimizer import DistributedOptimizer
from .functions import (broadcast_parameters, broadcast_optimizer_state,
                        broadcast_object, allgather_object)
from .sync_batch_norm import SyncBatchNorm
from . import elastic


def process_rank() -> int:
    """This process's rank (a rank is a process here)."""
    return rank()


def process_size() -> int:
    return size()


def mesh():
    """The one-dimensional device mesh of the ranks."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(_rt.get().device.type, (size(),))


def check_extension(ext_name: str = "horovod_tpu_torch.csrc") -> None:
    """Raise ImportError when the native controller cannot be built or
    loaded."""
    try:
        from ..common.basics import load_library
        load_library()
    except Exception as e:
        raise ImportError(f"native core unavailable for {ext_name}: {e}"
                          ) from e


def tpu_built() -> bool:
    return False


def xla_built() -> bool:
    return False


def mpi_built() -> bool:
    return False


def nccl_built() -> bool:
    return dist.is_nccl_available()


def gloo_built() -> bool:
    return dist.is_gloo_available()


def ccl_built() -> bool:
    return False


def ddl_built() -> bool:
    return False


def cuda_built() -> bool:
    return torch.version.cuda is not None


def rocm_built() -> bool:
    return torch.version.hip is not None


def mpi_enabled() -> bool:
    return False


def gloo_enabled() -> bool:
    return _rt.get().device.type == "cpu"


def mpi_threads_supported() -> bool:
    return False


def start_timeline(file_path: str, mark_cycles: bool = False) -> None:
    """Start writing this rank's Chrome-trace timeline to ``file_path``:
    every negotiated op's NEGOTIATE, QUEUE and EXEC phases (reference:
    horovod_start_timeline, operations.cc:740-769)."""
    _rt.get().start_timeline(file_path, mark_cycles=mark_cycles)


def stop_timeline() -> None:
    _rt.get().stop_timeline()


__all__ = [
    "check_extension",
    "init", "shutdown", "is_initialized", "rank", "size", "local_rank",
    "local_size", "cross_rank", "cross_size", "process_rank", "process_size",
    "mesh", "is_homogeneous",
    "ReduceOp", "Average", "Sum", "Adasum", "Min", "Max", "Product",
    "Compression",
    "allreduce", "allreduce_", "allreduce_async", "allreduce_async_",
    "grouped_allreduce", "grouped_allreduce_", "grouped_allreduce_async",
    "grouped_allreduce_async_", "allgather", "allgather_async",
    "broadcast", "broadcast_", "broadcast_async", "broadcast_async_",
    "alltoall", "alltoall_async", "reducescatter", "reducescatter_async",
    "sparse_allreduce_async", "synchronize", "poll", "join", "barrier",
    "DistributedOptimizer",
    "broadcast_parameters", "broadcast_optimizer_state", "broadcast_object",
    "allgather_object", "SyncBatchNorm", "elastic",
    "HorovodInternalError", "HostsUpdatedInterrupt",
    "tpu_built", "xla_built", "mpi_built", "nccl_built", "gloo_built",
    "ccl_built", "ddl_built", "cuda_built", "rocm_built", "mpi_enabled",
    "gloo_enabled", "mpi_threads_supported", "start_timeline",
    "stop_timeline",
]
