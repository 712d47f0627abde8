"""Training-quality sentinels: watch the MODEL, not just the machinery; the
port of ``horovod_tpu/watch/sentinel.py``.

  * :func:`sentinel_stats` — the step's scalars on the device: the global
    gradient norm over the finite mass, the nonfinite element count and
    the loss.  With a process group the square-sum and count are summed
    and the loss averaged over it, so every rank reaches the same verdict
    (the JAX version's ``psum``/``pmean`` over ``axis_name``); the three
    ride ONE packed ``[sq, bad, loss]`` tensor, so the reduction is one
    collective: a ``dist.all_reduce``, or, while the negotiated engine is
    up, an allreduce negotiated through it like the hook-driven
    optimizer's, so that no rank pairs it with another collective;
  * :func:`record` — the host-side sink, unchanged: the ``hvd_sentinel_*``
    families that ride the metrics publisher, the loss EMA and its
    divergence, and on a nonfinite step the counter the committed
    ``sentinel-nonfinite`` critical rule watches, an explicit native
    flight dump (reason ``nan``), a timeline instant and a warning;
  * :func:`wrap` — the drop-in: wraps a step whose output carries
    ``(loss, grads, ...)`` and returns its output unchanged.

Delivery.  JAX hands the scalars to the host with ``jax.debug.callback``,
asynchronously.  Here the packed tensor is copied without blocking into
pinned host memory behind a CUDA event; a later call of the wrapped step
records every earlier step whose event has completed, in order, and
:func:`drain` records the rest (the step ends with it at exit).  The
sentinel itself never synchronizes the device: at most
:data:`MAX_PENDING` steps wait, and only beyond that does the oldest one's
event get waited on.  Every step is still recorded, against its own step
number.  On the CPU the scalars are recorded at once.

Knobs: ``HOROVOD_SENTINEL`` (kill switch: off, :func:`wrap` returns the
step untouched) and ``HOROVOD_SENTINEL_INTERVAL`` (EMA/gauge cadence in
recorded steps; nonfinite is checked on every step).
"""

from __future__ import annotations

import atexit
import collections
import math
import threading
from typing import Any, Callable, Dict, Optional, Tuple

# Loss EMA smoothing: ~50-step horizon, the scale at which "diverging"
# is distinguishable from batch noise on the toy and real losses alike.
EMA_ALPHA = 0.02
# device steps whose scalars may wait for the host before the oldest one's
# event is waited on
MAX_PENDING = 4
# gradient elements one concatenated copy holds: the sentinel's transient
# memory is about this many elements twice over, a byte an element for the
# NaN mask and four for the norm's float32 copy (2.3 GB for bf16)
RUN_ELEMENTS = 1 << 28
# the name the packed scalars are negotiated under on the engine's path
# (one name every step: each reduction is waited on before the next)
REDUCE_NAME = "hvd.sentinel.packed"


class _SentinelState:
    def __init__(self):
        self.lock = threading.Lock()
        self.step = 0                 # auto-advanced when record() gets None
        self.ema: Optional[float] = None
        self.recorded = 0
        self.last_nonfinite_step = -1
        self.dump_paths: list = []    # test-visible: flight dumps written
        # (pinned host tensor, event) per step not yet recorded, oldest first
        self.pending: "collections.deque" = collections.deque()


_state = _SentinelState()


def reset() -> None:
    """Test hook: forget EMA/step state (module-global)."""
    global _state
    _state = _SentinelState()


def _knob(name: str):
    from ..common.knobs import current
    return current(name)


def enabled() -> bool:
    return bool(_knob("HOROVOD_SENTINEL"))


# ------------------------------------------------------------ device side
def _group(axis_name: Any):
    """The process group a ``wrap(axis_name=...)`` reduces over: None for
    none, a ``torch.distributed`` group as given, any other value the
    runtime's whole group (the JAX ``axis_name`` names the data axis)."""
    if axis_name is None:
        return None
    import torch.distributed as dist
    if isinstance(axis_name, dist.ProcessGroup):
        return axis_name
    return dist.group.WORLD


def packed_stats(loss, grads=None, axis_name: Any = None):
    """``[sq, bad, loss]`` as one float32 tensor on the loss's device: the
    square-sum of the finite gradient elements, the nonfinite element
    count (the loss's own nonfiniteness included) and the loss, reduced
    over ``axis_name``'s group with ONE collective (sum, :func:`_sum_over`;
    the loss then divided by the group's size).  No host
    synchronization."""
    import torch
    loss = torch.as_tensor(loss).detach()
    dev = loss.device
    loss = loss.to(torch.float32).reshape(())
    sq = torch.zeros((), dtype=torch.float32, device=dev)
    bad = torch.zeros((), dtype=torch.float32, device=dev)
    for run in _runs([g for g in _leaves(grads) if g is not None]):
        # one copy of the run's leaves, so a handful of launches covers
        # them all; nonfinite elements poison a plain square-sum, so they
        # are counted, zeroed, and the norm is the finite mass's: both
        # signals stay informative on a partially bad gradient
        flat = torch.cat([g.detach().reshape(-1) for g in run])
        if torch.finfo(flat.dtype).bits > 32:
            flat = flat.float()  # the JAX sentinel's float32 view
        # x - x is 0 where x is finite and NaN where it is NaN or
        # infinite; as 0 and 1 in the run's dtype it sums into float32
        # without the cast copy a sum of booleans makes (exact below 2**24
        # nonfinite elements a run, as the JAX sentinel's float32 count)
        marks = (flat - flat).nan_to_num_(nan=1.0)
        bad = bad + marks.sum(dtype=torch.float32)
        flat.nan_to_num_(nan=0.0, posinf=0.0, neginf=0.0)
        # in float32, as the JAX sentinel squares (on a card the norm
        # makes a float32 copy of a bf16 run first: a third of its cost)
        sq = sq + torch.linalg.vector_norm(
            flat, dtype=torch.float32).square()
    bad = bad + (~torch.isfinite(loss)).to(torch.float32)
    packed = torch.stack([sq, bad, loss])
    group = _group(axis_name)
    if group is not None:
        import torch.distributed as dist
        packed = _sum_over(packed, group) / torch.tensor(
            [1.0, 1.0, float(dist.get_world_size(group))], device=dev)
    return packed


def _sum_over(packed, group):
    """``packed`` summed over ``group``.  While this rank's negotiated
    engine is up (the hook-driven optimizer, any eager op), its
    collectives run when each rank pumps its responses, at a different
    point on each rank: a collective issued beside them could pair with a
    gradient bucket on a peer.  The sum is then negotiated through the
    engine under one name, as theirs are (the caller's stream waits for
    it; the host waits for the agreement only).  Otherwise it is one
    ``dist.all_reduce``."""
    import torch.distributed as dist
    from .. import runtime as _rt
    eng = _rt.get().eager if _rt.is_initialized() else None
    if eng is None or eng.core is None:
        dist.all_reduce(packed, group=group)
        return packed
    if group is not dist.group.WORLD:
        raise ValueError(
            "the sentinel reduces over a process group of its own while the "
            "negotiated engine is up, whose collectives it could pair with "
            "on a peer: reduce over the runtime's group (axis_name='hvd')")
    from ..ops.negotiated import Op
    return eng.wait(eng.submit(Op(REDUCE_NAME, "allreduce", [packed])))


def _runs(leaves):
    """The leaves grouped by dtype and device, in runs of at most
    RUN_ELEMENTS elements (a larger leaf runs alone): what one
    concatenated copy holds."""
    groups: Dict[Any, list] = {}
    for g in leaves:
        groups.setdefault((g.dtype, g.device), []).append(g)
    for group in groups.values():
        run, size = [], 0
        for g in group:
            if run and size + g.numel() > RUN_ELEMENTS:
                yield run
                run, size = [], 0
            run.append(g)
            size += g.numel()
        if run:
            yield run


def _leaves(grads):
    if grads is None:
        return []
    if isinstance(grads, dict):
        return [v for k in grads for v in _leaves(grads[k])]
    if isinstance(grads, (list, tuple)):
        return [v for g in grads for v in _leaves(g)]
    return [grads]


def sentinel_stats(loss, grads=None, axis_name: Any = None
                   ) -> Dict[str, Any]:
    """The step's sentinel scalars ``{"loss", "grad_norm", "nonfinite"}``,
    each a float32 0-d tensor on the loss's device (:func:`packed_stats`
    unpacked; ``grad_norm`` is the square root of the finite mass)."""
    packed = packed_stats(loss, grads, axis_name=axis_name)
    return {"loss": packed[2], "grad_norm": packed[0].sqrt(),
            "nonfinite": packed[1]}


# -------------------------------------------------------------- host side
def record(stats: Dict[str, Any], step: Optional[int] = None,
           core: Any = None) -> Dict[str, float]:
    """Sink one step's concrete sentinel scalars: update the
    hvd_sentinel_* families, the loss EMA/divergence, and — on a
    nonfinite step — fire the flight dump + alert chain.  Returns the
    recorded row (tests and callers can assert on it)."""
    loss = float(stats.get("loss", float("nan")))
    grad_norm = float(stats.get("grad_norm", float("nan")))
    nonfinite = float(stats.get("nonfinite", 0.0))
    from ..utils import metrics as M
    with _state.lock:
        if step is None:
            step = _state.step
        _state.step = int(step) + 1
        _state.recorded += 1
        interval = max(1, int(_knob("HOROVOD_SENTINEL_INTERVAL")))
        update_gauges = (_state.recorded % interval) == 0 or \
            _state.recorded == 1
        ema = _state.ema
        if update_gauges and math.isfinite(loss):
            ema = loss if ema is None else \
                (1.0 - EMA_ALPHA) * ema + EMA_ALPHA * loss
            _state.ema = ema
    bad = nonfinite > 0 or not math.isfinite(loss) \
        or not math.isfinite(grad_norm)
    row = {"step": int(step), "loss": loss, "grad_norm": grad_norm,
           "nonfinite": nonfinite,
           "ema": ema if ema is not None else loss,
           "divergence": (loss / ema) if (ema and math.isfinite(loss)
                                          and ema > 0) else 1.0}
    if update_gauges:
        M.SENTINEL_STEPS.inc()
        M.SENTINEL_LOSS.set(loss)
        M.SENTINEL_GRAD_NORM.set(grad_norm)
        if ema is not None:
            M.SENTINEL_LOSS_EMA.set(ema)
            M.SENTINEL_LOSS_DIVERGENCE.set(row["divergence"])
    if bad:
        _on_nonfinite(int(step), nonfinite, core=core)
    return row


def _on_nonfinite(step: int, count: float, core: Any = None) -> None:
    """The nonfinite chain: counter + step gauge (what the committed
    `sentinel-nonfinite` critical rule and its context ride), a native
    flight dump (reason ``nan`` — the postmortem plane's black box taken
    NOW, while the bad step's spans are still in the ring), a timeline
    instant, and a loud log line naming the step."""
    from ..utils import metrics as M
    with _state.lock:
        already = _state.last_nonfinite_step == step
        _state.last_nonfinite_step = step
    if already:
        return  # one verdict per step, however many records land on it
    M.SENTINEL_NONFINITE.inc()
    M.SENTINEL_LAST_NONFINITE_STEP.set(step)
    dump = _flight_dump(step, core=core)
    try:
        from ..utils.timeline import trace_instant
        trace_instant("alerts", "sentinel.nonfinite",
                      args={"step": step, "count": count})
    except Exception:
        pass
    try:
        from ..common import hvdlogging as log
        log.warning(
            "sentinel: NONFINITE training step %d (%s nonfinite values)%s",
            step, int(count), f"; flight dump: {dump}" if dump else "")
    except Exception:
        pass


def _flight_dump(step: int, core: Any = None) -> Optional[str]:
    """Explicit native flight dump for a nonfinite step.  Uses the
    caller's core, else the initialized runtime's (never forces a core
    into existence: a run without the controller has nothing to dump).
    The path derives from HOROVOD_FLIGHT_RECORD (the postmortem plane's
    per-rank path) with a ``.nan`` suffix so a later crash record never
    overwrites the divergence evidence."""
    path = str(_knob("HOROVOD_FLIGHT_RECORD") or "")
    if core is None:
        try:
            from .. import runtime as _rt
            if _rt.is_initialized():
                core = _rt.get().core
        except Exception:
            core = None
    if core is None or not getattr(core, "_h", True):
        return None
    if not path:
        return None
    path = f"{path}.nan"
    try:
        if core.flight_dump(path, reason=f"nan step={step}"):
            with _state.lock:
                _state.dump_paths.append(path)
            return path
    except Exception:
        pass  # forensics must never take the training loop down
    return None


def _record_packed(host) -> None:
    sq, bad, loss = (float(v) for v in host.tolist())
    try:
        record({"loss": loss, "grad_norm": math.sqrt(sq)
                if sq >= 0 else float("nan"), "nonfinite": bad})
    except Exception:
        pass  # telemetry must never take the step down


def deliver(packed) -> None:
    """Queue one step's packed scalars for :func:`record`.  A CPU tensor
    is recorded now; a CUDA tensor is copied without blocking into pinned
    memory behind an event, and recorded once the event has completed."""
    import torch
    if packed.device.type != "cuda":
        _record_packed(packed)
        return
    host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
    host.copy_(packed, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    with _state.lock:
        _state.pending.append((host, event))
    _drain(block=False)


def _drain(block: bool) -> None:
    """Record the pending steps in order: those whose event completed,
    the oldest beyond :data:`MAX_PENDING`, and with ``block`` every one."""
    while True:
        with _state.lock:
            if not _state.pending:
                return
            host, event = _state.pending[0]
            over = len(_state.pending) > MAX_PENDING
            if not (block or over or event.query()):
                return
            _state.pending.popleft()
        event.synchronize()
        _record_packed(host)


def drain() -> None:
    """Record every step still waiting for its scalars (waits for their
    events).  Runs at exit; call it before reading the sentinel's
    families or alerts at a point of your choosing."""
    _drain(block=True)


atexit.register(drain)


# ----------------------------------------------------------------- wrap
def wrap(step_fn: Callable, axis_name: Any = None,
         extract: Optional[Callable[[Any], Tuple[Any, Any]]] = None
         ) -> Callable:
    """Sentinel-wrap a train step: same signature, same outputs, plus
    the sentinel scalars recorded host-side without a device sync.
    ``extract(out) -> (loss, grads)`` defaults to ``(out[0], out[1])`` for
    tuple outputs and ``(out, None)`` for a bare loss; ``grads`` is a
    tensor or a list, tuple or dict of them.  ``axis_name``: None
    computes this rank's scalars; a ``torch.distributed`` group, or any
    other value for the runtime's whole group, reduces them over it (call
    the step on every rank of the group).  Under the hook-driven
    optimizer (``horovod_tpu_torch.torch``) the gradients are reduced in
    place from the backward on (on the card, on a side stream): read them
    after ``optimizer.synchronize()``, then ``with
    optimizer.skip_synchronize(): optimizer.step()``.  With
    HOROVOD_SENTINEL=0 the step is returned untouched (the kill switch
    costs nothing)."""
    if not enabled():
        return step_fn

    def _default_extract(out):
        if isinstance(out, (tuple, list)) and len(out) >= 2:
            return out[0], out[1]
        return out, None

    pick = extract or _default_extract

    def wrapped(*args, **kwargs):
        out = step_fn(*args, **kwargs)
        loss, grads = pick(out)
        deliver(packed_stats(loss, grads, axis_name=axis_name))
        return out

    return wrapped
