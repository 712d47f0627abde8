"""horovod_tpu_torch: the PyTorch/CUDA port of horovod_tpu.

Data-parallel training in the Horovod idiom, over ``torch.distributed``
(NCCL on CUDA, gloo on the CPU), with hand-written Hopper kernels where the
JAX package has Pallas TPU kernels (flash attention, forward and backward),
per-bucket wire formats for the gradient sync (bf16/fp16 casts, the int8
quantized ring, two-level routing, error feedback; ``ops/wire.py``), the
pipelined microbatch sync (``ops/overlap.py``), ZeRO weight-update
sharding at levels 1-3 (``parallel/zero.py``), 3D layouts
(``parallel/layout.py``), sequence parallelism (Ulysses and the ring, whose
flash variant runs the Hopper kernels per hop; ``parallel/sequence.py``),
expert parallelism with the MoE Llama (``parallel/expert.py``,
``models/moe_llama.py``), Adasum (``parallel/adasum.py``), the input
pipeline with device prefetch (``data/``), a continuous-batching
serving engine over a paged KV pool (``horovod_tpu_torch.serve``), and
Horovod's eager torch API, negotiated through the port's own copy of the
native controller (``horovod_tpu_torch.torch``).

    import horovod_tpu_torch as hvd
    hvd.init()                       # device cuda:<local_rank>; device="cpu" for gloo
    opt = hvd.DistributedOptimizer(torch.optim.AdamW(model.parameters()),
                                   named_parameters=model.named_parameters())
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)

Jobs start under the port's own launcher, ``python -m
horovod_tpu_torch.runner.launch -np N python3 train.py`` (``runner/``), or
from a program with ``hvd.run(fn, np=N)``.  The measurement plane
(``utils/``: the metrics registry, the timeline with its clock sync,
autotuning, the stall inspector) is reached through ``hvd.autotuner()``,
``hvd.metrics_snapshot()`` and ``hvd.start_timeline``/``stop_timeline``,
and through the launcher's ``--metrics-port``, ``--timeline-filename``,
``--timeline-merge`` and ``--autotune`` flags.  The perf plane
(``perf/``: the step ledger, the memory sampler, the cost model, the
regression gate) is ``hvd.perf`` with ``hvd.perf_report()``, the
profiler ``hvd.profiler``; ``GET /perf`` and ``launch doctor`` read them.
The forensics planes: ``hvd.postmortem`` (``record_step(i)`` stamps the
heartbeats; the launcher's ``--postmortem DIR`` writes postmortem.json,
``launch doctor DIR`` renders it), ``hvd.chaos`` (``step(i)`` clocks a
``--chaos`` spec's faults), ``hvd.watch`` (alert rules and the fleet
series behind ``--alerts``, ``GET /alerts`` and ``GET /series``) and
``hvd.sentinel`` (``wrap(step)`` watches the gradient norm, nonfinite
values and the loss).  Elastic training: ``hvd.elastic`` (``TreeState``,
``run``, the driver behind the launcher's ``--min-np``/``--max-np``/
``--host-discovery-script``).  The scenario plane: ``hvd.scenario``
(seeded workload traces, fault storms, the deterministic replay harness
behind the launcher's ``--scenario``); ``hvd.tune`` searches
hyperparameters over the native Gaussian process; ``hvd.probe_backend()``
asks a child process whether a card answers.

The package imports neither JAX nor ``horovod_tpu``; the pieces it shares
with the JAX package (reduce ops, knobs, exceptions, the native core's
sources) are its own copies.
"""

from __future__ import annotations

from . import runtime as _rt
from . import chaos, elastic, perf, postmortem, serve, watch
from .watch import sentinel
from .utils import profiler
from .data.loader import prefetch
from .common.reduce_op import (ReduceOp, Average, Sum, Adasum, Min, Max,
                               Product)
from .functions import (broadcast_parameters, broadcast_optimizer_state,
                        broadcast_object, allgather_object)
from .ops import overlap, spmd, wire
from .ops.compression import Compression
from .ops.flash_attention import flash_attention
from .optimizer import (DistributedOptimizer, sync_gradients,
                        sync_gradients_ef, wire_residual_report)
from .parallel.adasum import adasum_allreduce, adasum_hierarchical
from .parallel.data_parallel import (cast_params, make_microbatched_train_step,
                                     make_scanned_train_step, make_train_step)
from .parallel.expert import make_moe_fn
from .parallel.sequence import (make_ring_attn_fn, make_ulysses_attn_fn,
                                ring_attention, ulysses_attention)
from .runner.api import run
from .runtime import init, shutdown, is_initialized
from .utils.probe import probe_backend
from . import scenario, tune

__version__ = "0.3.0"


def rank() -> int:
    """Global rank of this process (one process per device)."""
    return _rt.get().rank()


def size() -> int:
    """Number of processes in the job."""
    return _rt.get().size()


def local_rank() -> int:
    return _rt.get().local_rank()


def local_size() -> int:
    return _rt.get().local_size()


def cross_rank() -> int:
    """Host index of this process."""
    return _rt.get().cross_rank()


def cross_size() -> int:
    return _rt.get().cross_size()


def is_homogeneous() -> bool:
    """True when every host runs the same number of processes."""
    rt = _rt.get()
    return rt.size() == rt.local_size() * rt.cross_size()


def autotuner():
    """The live autotuner when HOROVOD_AUTOTUNE is enabled, else None
    (reference: ParameterManager, parameter_manager.{h,cc}).  Feed it step
    measurements via ``autotuner().measure(nbytes=...)``."""
    return _rt.get().autotuner


def metrics_snapshot() -> dict:
    """Point-in-time snapshot of every metric family this process records
    (native controller counters and histograms, collectives and fusion,
    the stall inspector, the serving engine) as a JSON-able dict: the same
    payload workers publish for the ``/metrics`` fleet view."""
    return _rt.get().metrics_snapshot()


def perf_report() -> dict:
    """This rank's step-time attribution report: the measured compute /
    exposed-comm / host-input / stall decomposition (summing exactly to
    the measured step), the roofline model's predicted step and its
    drift, the native per-op aggregates, the memory section and the local
    verdict; the payload workers publish for ``GET /perf``.  Record steps
    with ``hvd.perf.timed_step()`` or ``hvd.perf.record_step``."""
    return perf.report()


def start_timeline(file_path: str, mark_cycles: bool = False) -> None:
    """Start writing the Chrome-trace timeline of this rank to
    ``file_path`` (reference: horovod_start_timeline)."""
    _rt.get().start_timeline(file_path, mark_cycles=mark_cycles)


def stop_timeline() -> None:
    """Stop the timeline and close its file (reference:
    horovod_stop_timeline)."""
    _rt.get().stop_timeline()


__all__ = [
    "init", "shutdown", "is_initialized",
    "rank", "size", "local_rank", "local_size", "cross_rank", "cross_size",
    "is_homogeneous", "autotuner", "metrics_snapshot", "start_timeline",
    "stop_timeline",
    "ReduceOp", "Average", "Sum", "Adasum", "Min", "Max", "Product",
    "DistributedOptimizer", "sync_gradients", "sync_gradients_ef",
    "wire_residual_report", "Compression", "spmd", "wire", "overlap",
    "broadcast_parameters", "broadcast_optimizer_state", "broadcast_object",
    "allgather_object",
    "flash_attention", "make_train_step", "make_microbatched_train_step",
    "make_scanned_train_step", "cast_params", "serve", "prefetch",
    "adasum_allreduce", "adasum_hierarchical", "ring_attention",
    "ulysses_attention", "make_ring_attn_fn", "make_ulysses_attn_fn",
    "make_moe_fn", "run", "perf", "perf_report", "profiler",
    "postmortem", "chaos", "watch", "sentinel", "elastic", "scenario",
    "tune", "probe_backend",
]
