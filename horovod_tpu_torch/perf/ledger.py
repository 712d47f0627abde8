"""The step-time decomposition ledger: the port of
``horovod_tpu/perf/ledger.py``, the measured half of the perf plane.

Every recorded step is split into four components that sum exactly to the
measured wall time:

  * ``host_input_s``   measured host-side input wait (``data/loader.py``
    ``prefetch`` feeds it; ``add_input_wait`` for custom loops);
  * ``compute_s``      the cost model's FLOPs over the chip's peak;
  * ``exposed_comm_s`` the cost model's non-overlapped comm bytes over the
    link class's bandwidth (the ``hvd_overlap_*`` gauges' model);
  * ``stall_s``        the residual: time the model cannot attribute.

When the model prices more than the measured step leaves room for, the
modeled components are scaled down to fit and the overshoot stays
observable as ``model_drift_ratio`` (> 1: the model over-predicts).

The module-global ledger backs ``hvd.perf_report()`` and the
``hvd_perf_*`` families; :class:`PerfPublisher` PUTs each rank's report to
the rendezvous KV scope ``perf``, which ``GET /perf`` merges
(:func:`merge_perf_reports`) and ``launch doctor --perf`` renders.

Where the port departs from the JAX ledger:

  * ``timed_step`` synchronizes the runtime's CUDA device before it reads
    the clock on exit: kernels launch asynchronously, so without it the
    block would time the host's enqueue, not the step.  On the CPU it
    adds nothing.
  * The chip is resolved from the runtime's device, not defaulted to
    ``"cpu"``: ``"h100"`` on an H100, ``"cpu"`` on the CPU or without a
    runtime (:func:`resolve_chip`).  Any other card, and any chip name
    the cost model has no peak for, raises at ``configure``: the JAX
    ``peak_flops`` would price it as a v5e.
  * The link is resolved the same way (``perf.resolve_link``): NVLink for
    CUDA ranks on one host, ``"loopback"`` on the CPU or without a
    runtime, ``"dcn"`` across hosts.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.request
from typing import Any, Callable, Dict, List, Optional

PERF_SCOPE = "perf"
REPORT_VERSION = 1

# Bottleneck verdicts, in the order the doctor renders them.
VERDICTS = ("compute-bound", "comm-bound", "input-bound", "stall-bound",
            "straggler-bound")


def resolve_chip(device=None) -> str:
    """The cost model's chip name for ``device`` (default: the runtime's
    device; ``"cpu"`` without a runtime): ``"h100"`` for an H100,
    ``"cpu"`` for the CPU.  Any other CUDA card raises: the cost model has
    no peak for it, and pricing it as a TPU would be wrong."""
    if device is None:
        from .. import runtime as _rt
        if not _rt.is_initialized():
            return "cpu"
        device = _rt.get().device
    import torch
    device = torch.device(device)
    if device.type == "cpu":
        return "cpu"
    if device.type == "cuda":
        name = torch.cuda.get_device_name(device)
        if "H100" in name:
            return "h100"
        raise ValueError(
            f"perf: no peak FLOP/s for the card {name!r} in "
            "perf/costmodel.py PEAK_TFLOPS; pass configure(chip=...) with "
            "one of its entries")
    raise ValueError(f"perf: no chip for device type {device.type!r}")


def _check_chip(chip: str) -> str:
    from .costmodel import PEAK_TFLOPS
    if chip not in PEAK_TFLOPS:
        raise ValueError(
            f"unknown chip {chip!r}; the cost model prices "
            f"{', '.join(sorted(PEAK_TFLOPS))} (perf/costmodel.py)")
    return str(chip)


def _default_link() -> str:
    from .. import runtime as _rt
    if not _rt.is_initialized():
        return "loopback"
    from . import resolve_link
    return resolve_link(_rt.get().knobs)


def _sync_device() -> None:
    """Wait for the runtime's CUDA device (nothing on the CPU)."""
    from .. import runtime as _rt
    if _rt.is_initialized():
        dev = _rt.get().device
        if dev.type == "cuda":
            import torch
            torch.cuda.synchronize(dev)


class PerfLedger:
    """Per-process decomposition ledger.  Thread-safe; cheap enough to
    record every step."""

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self._steps = 0
            self._sum = {"step": 0.0, "compute": 0.0, "exposed_comm": 0.0,
                         "host_input": 0.0, "stall": 0.0}
            self._last: Optional[Dict[str, float]] = None
            self._pending_input = 0.0
            self._drift_sum = 0.0
            self._drift_n = 0
            # model inputs (configure()); None = component unmodeled
            self._flops: Optional[float] = None
            self._comm_bytes: Optional[float] = None
            self._overlap_fraction = 0.0
            # None = resolve from the runtime at first use
            self._chip: Optional[str] = None
            self._link: Optional[str] = None
            self._zero: Optional[Dict[str, Any]] = None
            self._layout: Optional[Dict[str, Any]] = None

    # ------------------------------------------------------------ configure
    def configure(self, *, flops_per_step: Optional[float] = None,
                  comm_bytes_per_step: Optional[float] = None,
                  overlap_fraction: Optional[float] = None,
                  chip: Optional[str] = None,
                  link: Optional[str] = None,
                  zero_model: Optional[Dict[str, Any]] = None,
                  layout_model: Optional[Dict[str, Any]] = None) -> None:
        """Set the cost-model inputs the decomposition prices steps with.
        Unset components stay as they were; an unconfigured model
        attributes everything beyond measured input wait to ``stall``.
        The chip and link resolve from the runtime when neither this call
        nor an earlier one named them (module docstring).

        ``zero_model`` describes the ZeRO workload (``{"n_params",
        "world"}`` required, plus ``level``, ``opt_slots``, ``k``,
        ``wire_format``, ``ef``) and makes :meth:`report` carry the
        per-level what-if table (``costmodel.zero_level_table``).
        ``layout_model`` describes the 3D-layout workload the same way
        (``{"n_params", "world"}`` plus the Llama descriptor fields and
        the solver's options) and makes :meth:`report` carry the ranked
        candidate table (``costmodel.solve_layout``)."""
        from .costmodel import LINK_CLASSES
        for what, m in (("zero_model", zero_model),
                        ("layout_model", layout_model)):
            if m is not None:
                for req in ("n_params", "world"):
                    if req not in m:
                        raise ValueError(
                            f"{what} needs {req!r}; got {sorted(m)}")
        if chip is not None:
            chip = _check_chip(chip)
        elif self._chip is None:
            chip = resolve_chip()
        if link is not None and link not in LINK_CLASSES:
            raise ValueError(f"unknown link class {link!r}; valid: "
                             f"{', '.join(LINK_CLASSES)}")
        if overlap_fraction is not None and \
                not 0.0 <= overlap_fraction <= 1.0:
            raise ValueError(f"overlap_fraction {overlap_fraction} "
                             "outside [0, 1]")
        with self._lock:
            if zero_model is not None:
                self._zero = dict(zero_model)
            if layout_model is not None:
                self._layout = dict(layout_model)
            if flops_per_step is not None:
                self._flops = float(flops_per_step)
            if comm_bytes_per_step is not None:
                self._comm_bytes = float(comm_bytes_per_step)
            if overlap_fraction is not None:
                self._overlap_fraction = float(overlap_fraction)
            if chip is not None:
                self._chip = chip
            if link is not None:
                self._link = str(link)

    def chip(self) -> str:
        """The chip the ledger prices compute with: the configured one,
        else resolved from the runtime as it stands."""
        with self._lock:
            chip = self._chip
        return chip if chip is not None else resolve_chip()

    def link(self) -> str:
        """The link class the ledger prices comm with: the configured
        one, else resolved from the runtime as it stands."""
        with self._lock:
            link = self._link
        return link if link is not None else _default_link()

    def zero_model(self) -> Optional[Dict[str, Any]]:
        """The configured ZeRO workload (or None): the geometry the memory
        plane attributes and reconciles (``perf/memstats.py``)."""
        with self._lock:
            return dict(self._zero) if self._zero else None

    def layout_model(self) -> Optional[Dict[str, Any]]:
        """The configured 3D-layout workload (or None)."""
        with self._lock:
            return dict(self._layout) if self._layout else None

    def configure_from_overlap_gauges(self) -> bool:
        """Adopt the overlap plane's byte model (the ``hvd_overlap_*``
        gauges, ``ops/overlap.py``) as the comm leg: the microbatch
        plane's exposed bytes, when it recorded anything.  True when the
        gauges were live."""
        from ..utils import metrics as M
        exposed = M.OVERLAP_EXPOSED_BYTES.value(plane="microbatch")
        frac = M.OVERLAP_FRACTION.value(plane="microbatch")
        if exposed <= 0.0 and frac <= 0.0:
            return False
        # the gauge already holds EXPOSED bytes: overlap 0, so they are
        # not discounted twice
        self.configure(comm_bytes_per_step=exposed, overlap_fraction=0.0)
        return True

    # --------------------------------------------------------------- record
    def add_input_wait(self, seconds: float) -> None:
        """Accumulate host-side input wait since the last recorded step."""
        if seconds > 0:
            with self._lock:
                self._pending_input += float(seconds)

    def record_step(self, step_time_s: float) -> Dict[str, float]:
        """Split one measured step and fold it into the ledger.  Returns
        the step's decomposition; its components sum to ``step_time_s``
        exactly."""
        from .costmodel import link_bandwidth, peak_flops
        chip, link = self.chip(), self.link()
        dt = max(float(step_time_s), 0.0)
        with self._lock:
            host_input = min(self._pending_input, dt)
            self._pending_input = 0.0
            compute = (self._flops / peak_flops(chip)
                       if self._flops else 0.0)
            comm = ((self._comm_bytes * (1.0 - self._overlap_fraction)
                     / link_bandwidth(link))
                    if self._comm_bytes else 0.0)
            modeled = compute + comm
            avail = dt - host_input
            if dt > 0:
                self._drift_sum += (modeled + host_input) / dt
                self._drift_n += 1
            if modeled > avail and modeled > 0:
                # over-prediction: scale the modeled components into the
                # measured budget; the drift ratio keeps the overshoot
                scale = max(avail, 0.0) / modeled
                compute *= scale
                comm *= scale
                stall = 0.0
            else:
                stall = avail - modeled
            row = {"step": dt, "compute": compute, "exposed_comm": comm,
                   "host_input": host_input, "stall": stall}
            for k, v in row.items():
                self._sum[k] += v
            self._steps += 1
            self._last = row
        self._update_metrics(row)
        return {f"{k}_s" if k != "step" else "step_time_s": v
                for k, v in row.items()}

    def timed_step(self):
        """``with ledger.timed_step() as t: <one train step>``: times the
        block and records it (``t.row`` is then the step's decomposition).
        On a CUDA runtime the exit waits for the device before it reads
        the clock (module docstring)."""
        ledger = self

        class _Timer:
            row: Optional[Dict[str, float]] = None

            def __enter__(self):
                self._t0 = time.perf_counter()
                return self

            def __exit__(self, *exc):
                if exc[0] is None:
                    _sync_device()
                    self.row = ledger.record_step(
                        time.perf_counter() - self._t0)
                return False

        return _Timer()

    def _update_metrics(self, row: Dict[str, float]) -> None:
        from ..utils import metrics as M
        M.PERF_STEPS.inc()
        M.PERF_STEP_TIME.observe(row["step"])
        for comp in ("compute", "exposed_comm", "host_input", "stall"):
            M.PERF_COMPONENT.set(row[comp], component=comp)
        drift = self.model_drift_ratio()
        if drift is not None:
            M.PERF_MODEL_DRIFT.set(drift)

    # --------------------------------------------------------------- report
    def model_drift_ratio(self) -> Optional[float]:
        """Mean modeled/measured ratio over the recorded steps."""
        if not self._drift_n:
            return None
        return self._drift_sum / self._drift_n

    def report(self) -> Dict[str, Any]:
        """The per-rank perf report: the measured decomposition's means,
        the model's predicted step, their deltas and the local verdict.
        JSON-able; the payload the publisher PUTs to scope ``perf``."""
        from .costmodel import predicted_step_time, zero_level_table
        chip, link = self.chip(), self.link()
        with self._lock:
            steps = self._steps
            sums = dict(self._sum)
            last = dict(self._last) if self._last else None
            flops, comm_bytes = self._flops, self._comm_bytes
            overlap = self._overlap_fraction
            drift = (self._drift_sum / self._drift_n
                     if self._drift_n else None)
            zero = dict(self._zero) if self._zero else None
            layout = dict(self._layout) if self._layout else None
        mean = {k: (v / steps if steps else 0.0) for k, v in sums.items()}
        decomposition = {
            "compute_s": mean["compute"],
            "exposed_comm_s": mean["exposed_comm"],
            "host_input_s": mean["host_input"],
            "stall_s": mean["stall"],
        }
        fractions = {k: (v / mean["step"] if mean["step"] else 0.0)
                     for k, v in decomposition.items()}
        predicted = predicted_step_time(
            flops or 0.0, comm_bytes or 0.0, chip=chip, link=link,
            overlap_fraction=overlap,
            input_seconds=mean["host_input"]) if steps else None
        report: Dict[str, Any] = {
            "version": REPORT_VERSION,
            "time": time.time(),
            "steps": steps,
            "step_time_s": {"mean": mean["step"],
                            "last": last["step"] if last else None},
            "decomposition": decomposition,
            "fractions": fractions,
            "verdict": local_verdict(fractions) if steps else None,
            "model": {"flops_per_step": flops,
                      "comm_bytes_per_step": comm_bytes,
                      "overlap_fraction": overlap,
                      "chip": chip, "link": link},
            "predicted": predicted,
            "model_drift_ratio": drift,
        }
        if predicted and mean["step"] > 0:
            report["predicted_vs_measured"] = {
                "step_delta_s": predicted["step_s"] - mean["step"],
                "step_ratio": predicted["step_s"] / mean["step"],
            }
        if zero is not None:
            report["zero"] = {
                "active_level": zero.get("level"),
                "model": zero,
                "levels": zero_level_table(
                    zero["n_params"], zero["world"],
                    opt_slots=int(zero.get("opt_slots", 2)),
                    k=int(zero.get("k", 1)),
                    wire_format=str(zero.get("wire_format", "none")),
                    ef=bool(zero.get("ef", False)),
                    chip=chip, link=link, flops_per_step=flops),
            }
        ops = native_op_stats()
        if ops:
            report["native_ops"] = ops
        # the memory plane's section, once the sampler has run
        from . import memstats
        mem = memstats.report_section()
        if mem is not None:
            report["memory"] = mem
        if layout is not None:
            report["layout"] = self._layout_section(
                layout, report, chip, link, flops, mean["step"])
        return report

    @staticmethod
    def _layout_section(layout: Dict[str, Any], report: Dict[str, Any],
                        chip: str, link: str, flops: Optional[float],
                        mean_step: float) -> Dict[str, Any]:
        from .costmodel import solve_layout
        world = int(layout["world"])
        cap = layout.get("mem_cap_bytes")
        if cap is None:
            cap = (report.get("memory") or {}).get(
                "measured", {}).get("headroom_bytes")
        n_heads = int(layout.get("n_heads", world))
        model = {
            "n_params": layout["n_params"],
            "dim": int(layout.get("dim", 0)),
            "n_layers": int(layout.get("n_layers", world)),
            "n_heads": n_heads,
            "n_kv_heads": int(layout.get("n_kv_heads", n_heads)),
            "batch": int(layout.get("batch", world)),
            "seq": int(layout.get("seq", 1)),
            "itemsize": float(layout.get("itemsize", 4.0)),
            "flops_per_step": float(layout.get("flops_per_step",
                                               flops or 0.0)),
        }
        sol = solve_layout(
            model, world, mem_cap_bytes=cap,
            levels=tuple(layout.get("levels", (1, 2, 3))),
            wires=tuple(layout.get("wires", ("none",))),
            overlap_depths=tuple(layout.get("overlap_depths", (0,))),
            k=int(layout.get("k", 1)),
            n_micro=int(layout.get("n_micro", 4)),
            chip=chip, link=link, ef=bool(layout.get("ef", False)))
        # the row this rank trains with, which may rank below the winner;
        # drift is judged against its prediction
        active_req = layout.get("active")
        active = None
        if isinstance(active_req, dict):
            for row in sol["candidates"]:
                if all(row["layout"].get(a) == active_req.get(a)
                       for a in ("dp", "tp", "pp")) and \
                   (active_req.get("zero_level") is None or
                        row["zero_level"] == active_req["zero_level"]):
                    active = row
                    break
        judged = active or sol["chosen"]
        section: Dict[str, Any] = {
            "model": model,
            "world": world,
            "mem_cap_bytes": cap,
            "n_candidates": sol["n_candidates"],
            "chosen": sol["chosen"],
            "active": active,
            "candidates": sol["candidates"][:16],
            "candidates_truncated": sol["n_candidates"] > 16,
        }
        if mean_step > 0:
            section["predicted_vs_measured"] = {
                "step_delta_s": judged["step_s"] - mean_step,
                "step_ratio": judged["step_s"] / mean_step,
            }
        from ..utils import metrics as M
        M.LAYOUT_CANDIDATES.set(sol["n_candidates"])
        M.LAYOUT_CHOSEN_RANK.set(judged["rank"])
        M.LAYOUT_PREDICTED_STEP.set(judged["step_s"])
        return section


def local_verdict(fractions: Dict[str, float]) -> str:
    """One rank's bottleneck: the dominant component of the mean
    decomposition (straggler-bound is a fleet verdict that
    :func:`merge_perf_reports` adds)."""
    order = (("exposed_comm_s", "comm-bound"),
             ("host_input_s", "input-bound"),
             ("stall_s", "stall-bound"),
             ("compute_s", "compute-bound"))
    best = max(order, key=lambda kv: fractions.get(kv[0], 0.0))
    return best[1]


# ------------------------------------------------------------- native leg
def native_op_stats(core=None, top: int = 10) -> List[Dict[str, Any]]:
    """Top per-op-name enqueue->done aggregates of the native core
    (``CoordinationCore.op_stats``), largest total latency first; empty
    when no core is up (a run that negotiates nothing)."""
    if core is None:
        from .. import runtime as _rt
        if not _rt.is_initialized():
            return []
        core = _rt.get().core
    if core is None or not getattr(core, "_h", None):
        return []
    stats = core.op_stats()
    rows = sorted(stats.items(), key=lambda kv: -kv[1]["sum_us"])[:top]
    return [{"name": name,
             "count": s["count"],
             "bytes": s["bytes"],
             "mean_us": (s["sum_us"] / s["count"]) if s["count"] else 0.0,
             "max_us": s["max_us"]}
            for name, s in rows]


def import_op_stats(core) -> None:
    """Fold the native per-op aggregates into the
    ``hvd_perf_native_op_*`` families (called from the runtime's metrics
    snapshot); cumulative values import with ``set_total``."""
    from ..utils import metrics as M
    for row in native_op_stats(core, top=32):
        M.PERF_NATIVE_OP_US.set_total(row["count"] * row["mean_us"],
                                      name=row["name"])
        M.PERF_NATIVE_OP_BYTES.set_total(row["bytes"], name=row["name"])


# ---------------------------------------------------------- module global
GLOBAL = PerfLedger()


def configure(**kw) -> None:
    GLOBAL.configure(**kw)


def add_input_wait(seconds: float) -> None:
    GLOBAL.add_input_wait(seconds)


def record_step(step_time_s: float) -> Dict[str, float]:
    return GLOBAL.record_step(step_time_s)


def timed_step():
    return GLOBAL.timed_step()


def report() -> Dict[str, Any]:
    return GLOBAL.report()


def reset() -> None:
    GLOBAL.reset()


# -------------------------------------------------------------- publisher
class PerfPublisher:
    """Background thread PUT-ing this rank's perf report to the rendezvous
    KV (scope ``perf``, key ``rank.N``) so ``GET /perf`` serves the merged
    view: ``utils/metrics.py`` ``MetricsPublisher``'s shape, with a final
    publish on ``close()``."""

    SCOPE = PERF_SCOPE

    def __init__(self, addr: str, port: int, rank: int,
                 report_fn: Callable[[], Dict[str, Any]] = report,
                 interval: float = 5.0):
        self.addr = addr
        self.port = int(port)
        self.rank = int(rank)
        self.interval = max(0.1, float(interval))
        self._report_fn = report_fn
        # one publish at a time, each taking its payload inside: a
        # payload taken earlier never lands after a newer one (the
        # loop's publishes beside publish_now and close)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if self.addr and self.port:
            self._thread = threading.Thread(target=self._loop, daemon=True)
            self._thread.start()

    def publish_now(self, retries: int = 3) -> bool:
        with self._lock:
            return self._publish(retries=retries)

    def _publish(self, retries: int = 3) -> bool:
        if not (self.addr and self.port):
            return False
        try:
            rep = self._report_fn()
            rep["rank"] = self.rank
            body = json.dumps(rep).encode()
            # sharded KV: the perf scope may live on a shard server
            from ..runner.http_client import resolve_kv_addr
            addr, port, _ = resolve_kv_addr(self.addr, self.port,
                                            self.SCOPE)
            url = (f"http://{addr}:{port}/{self.SCOPE}/"
                   f"rank.{self.rank}")
            delay = 0.1
            for attempt in range(retries + 1):
                try:
                    req = urllib.request.Request(url, data=body,
                                                 method="PUT")
                    with urllib.request.urlopen(req, timeout=5):
                        pass
                    return True
                except Exception:
                    if attempt >= retries:
                        raise
                    time.sleep(delay)
                    delay = min(delay * 2, 1.0)
            return True
        except Exception:
            return False  # attribution must never take the job down

    def _loop(self) -> None:
        self.publish_now()
        while not self._stop.wait(self.interval):
            self.publish_now()

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
        self.publish_now()


# ------------------------------------------------------------- fleet merge
def merge_perf_reports(stored: Dict[str, bytes],
                       straggler_ratio: float = 1.5) -> Dict[str, Any]:
    """The ``GET /perf`` payload: every rank's report plus the fleet
    verdict.  Straggler-bound (one rank's mean step beyond
    ``straggler_ratio`` x the peers' median) outranks the component
    verdicts."""
    ranks: Dict[str, Any] = {}
    for key in sorted(stored):
        try:
            rep = json.loads(stored[key])
        except (ValueError, TypeError):
            continue  # a torn PUT must not break the whole view
        rank = str(rep.get("rank", key.rsplit(".", 1)[-1]))
        ranks[rank] = rep
    fleet: Dict[str, Any] = {"verdict": None, "ranks": len(ranks)}
    rows = [(r, rep["step_time_s"]["mean"]) for r, rep in ranks.items()
            if rep.get("steps") and rep.get("step_time_s", {}).get("mean")]
    if rows:
        fleet["step_time_by_rank"] = {r: t for r, t in rows}
        slowest_rank, slowest = max(rows, key=lambda rt: rt[1])
        peers = sorted(t for r, t in rows if r != slowest_rank)
        if peers:
            peer_median = peers[len(peers) // 2]
            if peer_median > 0 and slowest > straggler_ratio * peer_median:
                fleet["verdict"] = "straggler-bound"
                fleet["straggler"] = {"rank": slowest_rank,
                                      "step_time_s": slowest,
                                      "peer_median_s": peer_median}
        if fleet["verdict"] is None:
            agg = {"compute_s": 0.0, "exposed_comm_s": 0.0,
                   "host_input_s": 0.0, "stall_s": 0.0}
            n = 0
            for _, rep in ranks.items():
                d = rep.get("decomposition")
                if d:
                    n += 1
                    for k in agg:
                        agg[k] += d.get(k, 0.0)
            if n:
                total = sum(agg.values())
                fleet["verdict"] = local_verdict(
                    {k: (v / total if total else 0.0)
                     for k, v in agg.items()})
                fleet["decomposition"] = {k: v / n for k, v in agg.items()}
    # the rank closest to its cap paces an out-of-memory failure
    mem_rows = [(r, rep["memory"]) for r, rep in ranks.items()
                if isinstance(rep.get("memory"), dict)]
    if mem_rows:
        worst_rank, worst = max(
            mem_rows,
            key=lambda rm: rm[1].get("measured", {}).get("watermark", 0.0)
            or 0.0)
        fleet["memory"] = {
            "ranks": len(mem_rows),
            "bytes_in_use_total": sum(
                m.get("measured", {}).get("bytes_in_use", 0) or 0
                for _, m in mem_rows),
            "worst_watermark": {
                "rank": worst_rank,
                "watermark": worst.get("measured", {}).get("watermark"),
                "headroom_bytes": worst.get("measured",
                                            {}).get("headroom_bytes"),
            },
            "drift_ratio_by_rank": {
                r: m.get("model_drift_ratio") for r, m in mem_rows},
        }
    return {"version": REPORT_VERSION, "time": time.time(),
            "fleet": fleet, "ranks": ranks}
