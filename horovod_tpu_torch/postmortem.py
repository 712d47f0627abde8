"""Postmortem plane: crash forensics for a fleet that died; the port of
``horovod_tpu/postmortem.py``, its taxonomy and postmortem.json unchanged.
The native half is the port's own copy of the core
(``csrc/core/postmortem.cc``, bound in ``common/basics.py``).

The metrics plane answers "how is the run doing", the tracing plane
"where did the time go"; this module answers "why did the run die".
Three pieces cooperate (docs/postmortem.md):

  * csrc/core/postmortem.cc — the native **flight recorder**: fatal-signal /
    std::terminate handlers (plus an explicit ``hvd_core_flight_dump``)
    write a versioned flight-record file with the trace-ring tail,
    metrics snapshot, tensor-queue/transport state and last-progress
    cycle stamp.  :func:`parse_flight_record` reads it back.
  * utils/health.py — per-rank **heartbeats** on the aligned fleet clock
    (KV scope ``health``, served at ``GET /health``), plus the
    launcher-side :class:`~horovod_tpu_torch.utils.health.HealthMonitor`.
  * this module — the **postmortem.json** builder the launcher runs on
    abnormal exit (:func:`build_postmortem`): per-rank exit taxonomy,
    collected flight records, log tails, condensed final metrics, and
    the fleet-clock-ordered last events, topped by a suspect
    classification.  ``launch doctor`` renders it root-cause-first
    (runner/doctor.py).

The suspect taxonomy is closed — kill / stall / kv_blackout / transport
/ torn_commit / unknown — mirroring the chaos plane's fault kinds
(docs/chaos.md), which is also how it is verified: a chaos-injected
fault must come back out of the postmortem with the right rank and name.
"""

from __future__ import annotations

import json
import os
import signal as _signal
import time
from typing import Any, Dict, List, Optional, Tuple

from .utils.health import record_step  # noqa: F401  (public step hook)

SCHEMA = "hvd-postmortem-v1"
FLIGHT_HEADER = "hvd_flight_v"

# Closed suspect taxonomy (docs/postmortem.md#taxonomy).
SUSPECTS = ("kill", "stall", "kv_blackout", "transport", "torn_commit",
            "oom", "unknown")

# SIGKILL arrives as rc -9 from the launcher's waitpid or as the shell
# convention 128+9 when a wrapper re-reported it.
_SIGKILL_RCS = (-9, 137)


def _mem_watermark(heartbeat: Optional[Dict[str, Any]]) -> Optional[float]:
    """The device-memory watermark the final heartbeat carried (the
    memory plane stamps it, utils/health.py), or None."""
    mem = (heartbeat or {}).get("mem") or {}
    wm = mem.get("watermark")
    try:
        return float(wm) if wm is not None else None
    except (TypeError, ValueError):
        return None


def _pressure_threshold() -> float:
    try:
        from .common.knobs import current
        return float(current("HOROVOD_MEM_HIGH_WATERMARK"))
    except Exception:
        return 0.9  # registry default (common/knobs.py)

# The stall inspector's documented hard-exit status (utils/stall.py).
STALL_SHUTDOWN_EXIT = 42


# ------------------------------------------------------------ flight record
def parse_flight_record(path_or_text: str) -> Dict[str, Any]:
    """Parse a native flight record (csrc/postmortem.cc WriteFlightRecord).

    Accepts a file path or the raw text.  Returns ``{"version", "reason",
    "rank", "size", "now_us", "health": {...}, "metrics": {...},
    "trace": [(ts_us, phase, cat, name, arg), ...], "trace_dropped",
    "complete"}`` — ``complete`` is False when the ``[end]`` marker is
    missing (the write was torn by the crash it was recording).  Unknown
    keys and sections are ignored, mirroring the hvd_core_metrics
    versioning contract."""
    if "\n" not in path_or_text and os.path.exists(path_or_text):
        with open(path_or_text) as f:
            text = f.read()
    else:
        text = path_or_text
    lines = text.splitlines()
    if not lines or not lines[0].startswith(FLIGHT_HEADER):
        raise ValueError(
            f"not a flight record (want '{FLIGHT_HEADER}N' header): "
            f"{lines[:1]!r}")
    out: Dict[str, Any] = {
        "version": int(lines[0].split(FLIGHT_HEADER, 1)[1]),
        "reason": "?", "rank": -1, "size": 0, "now_us": 0,
        "health": {}, "metrics": {}, "trace": [], "trace_dropped": 0,
        "complete": False,
    }
    section = ""
    for line in lines[1:]:
        line = line.strip()
        if not line:
            continue
        if line.startswith("[") and line.endswith("]"):
            section = line[1:-1]
            if section == "end":
                out["complete"] = True
            continue
        parts = line.split()
        if section == "trace":
            if parts[0] == "trace_dropped" and len(parts) == 2:
                out["trace_dropped"] = int(parts[1])
            elif len(parts) >= 5:
                try:
                    out["trace"].append((int(parts[0]), parts[1], parts[2],
                                         parts[3], int(parts[4])))
                except ValueError:
                    continue  # torn tail line from the crash
        elif section in ("health", "metrics"):
            if len(parts) == 2:
                try:
                    out[section][parts[0]] = int(parts[1])
                except ValueError:
                    continue
        elif not section:  # header
            if parts[0] == "reason":
                out["reason"] = line.split(" ", 1)[1] if len(parts) > 1 \
                    else "?"
            elif len(parts) == 2:
                try:
                    out[parts[0]] = int(parts[1])
                except ValueError:
                    continue
    return out


# ------------------------------------------------------------ exit taxonomy
def classify_exit(rc: Optional[int], by_launcher: bool = False,
                  supervision_cause: Optional[str] = None,
                  heartbeat: Optional[Dict[str, Any]] = None) -> str:
    """One worker exit -> taxonomy label.

    ``supervision_cause`` ("stall" / "heartbeat-lost") wins: when the
    launcher itself killed the worker on a verdict, the SIGABRT it died
    of is the cure, not the disease.  ``by_launcher`` marks fail-fast
    terminations of SURVIVORS after another rank failed — collateral,
    never the first failure.  rc 42 is the stall inspector's documented
    hard-exit status (utils/stall.py).

    ``heartbeat`` is the rank's FINAL heartbeat: a SIGKILL/rc-137 exit
    whose heartbeat carried a device-memory watermark at or above the
    pressure threshold classifies as suspected ``oom`` — the kernel's
    OOM killer sends exactly that signal, and the memory plane put the
    evidence on the wire before dying (docs/memory.md#oom)."""
    if supervision_cause:
        return supervision_cause
    if by_launcher:
        return "terminated"
    if rc is None:
        return "unknown"
    if rc == 0:
        return "clean"
    if rc in _SIGKILL_RCS:
        wm = _mem_watermark(heartbeat)
        if wm is not None and wm >= _pressure_threshold():
            return "oom"
    if rc < 0:
        try:
            return f"signal:{_signal.Signals(-rc).name}"
        except ValueError:
            return f"signal:{-rc}"
    if rc == STALL_SHUTDOWN_EXIT:
        return "stall"
    return f"error:{rc}"


_COLLATERAL = ("clean", "terminated")


def _condense_metrics(snapshot: Dict[str, Any]) -> Dict[str, Any]:
    """The postmortem-relevant slice of a full metrics snapshot: chaos
    injections by kind, transport resilience counters, stall warnings.
    Full snapshots carry every histogram bucket — too heavy to embed
    per rank in an artifact meant for humans."""
    fams = snapshot.get("families", {})

    def total(name: str) -> float:
        return sum(s.get("value", 0)
                   for s in fams.get(name, {}).get("samples", []))

    chaos: Dict[str, float] = {}
    for s in fams.get("hvd_chaos_injections_total", {}).get("samples", []):
        kind = s.get("labels", {}).get("kind")
        if kind and s.get("value"):
            chaos[kind] = s["value"]
    return {
        "chaos_injections": chaos,
        "chaos_faults_native": total("hvd_chaos_faults_native_total"),
        "transport_reconnects": total("hvd_transport_reconnects_total"),
        "transport_reconnect_failures": total(
            "hvd_transport_reconnect_failures_total"),
        "stall_warnings": total("hvd_stall_warnings_total"),
    }


# -------------------------------------------------------------- suspect
def classify_suspect(info: Dict[str, Any]) -> Tuple[str, List[str]]:
    """(classification, evidence) for ONE rank's collected forensics
    (the ``ranks[r]`` shape build_postmortem assembles).  Precedence runs
    most-specific-first: a torn commit also looks like a kill, a chaos
    kill also exits nonzero — the closed taxonomy keeps the verdict
    deterministic."""
    cls = info.get("exit", {}).get("classification", "unknown")
    tail = (info.get("log_tail") or "").lower()
    fr = info.get("flight_record") or {}
    met = info.get("metrics") or {}
    chaos = met.get("chaos_injections", {})

    if "crash_commit" in tail or "chaos: crashing rank" in tail \
            or chaos.get("crash_commit"):
        return "torn_commit", ["log/metrics show a crash injected inside "
                               "a fastcommit window"]
    if "kv blackout" in tail or "kv_blackout" in tail \
            or chaos.get("kv_blackout"):
        return "kv_blackout", ["log/metrics show rendezvous-KV operations "
                               "failing before the exit"]
    if cls == "oom":
        wm = _mem_watermark(info.get("heartbeat"))
        return "oom", [
            "SIGKILL with the final heartbeat's device-memory watermark "
            f"at {wm:.0%} of the cap — the kernel OOM-killer signature "
            "(docs/memory.md#oom)" if wm is not None else
            "SIGKILL with memory pressure in the final heartbeat"]
    if cls in ("stall", "heartbeat-lost"):
        return "stall", [f"supervision verdict: {cls} beyond the "
                         "heartbeat timeout"]
    if fr.get("metrics", {}).get("transport_reconnect_failures") \
            or fr.get("health", {}).get("transport_healthy") == 0 \
            or "controller transport failure" in tail:
        return "transport", ["flight record / log shows the controller "
                             "transport dead (retry budget exhausted or "
                             "peer gone)"]
    if cls.startswith("signal:") or "chaos: killing rank" in tail \
            or chaos.get("kill"):
        ev = [f"exit classification {cls}"]
        if "chaos: killing rank" in tail or chaos.get("kill"):
            ev.append("chaos injector logged the kill")
        return "kill", ev
    return "unknown", [f"exit classification {cls} matches no known "
                       "failure signature"]


# --------------------------------------------------------------- builder
def _flight_events_wall(rank: int, fr: Dict[str, Any],
                        hb: Optional[Dict[str, Any]],
                        limit: int = 10) -> List[Dict[str, Any]]:
    """Map the flight record's ring-relative trace tail onto the fleet
    clock.  Anchor: the heartbeat carries BOTH the aligned wall time and
    the core's ring clock (``core.now_us``) sampled together, so
    ring_epoch_wall = hb.time - hb.core.now_us/1e6 and every span maps
    to wall seconds.  Without a heartbeat-borne anchor the spans stay
    unmapped (listed in the rank detail, absent from the timeline)."""
    core = (hb or {}).get("core") or {}
    if not fr.get("trace") or not core.get("now_us") or not (hb or {}).get(
            "time"):
        return []
    epoch = float(hb["time"]) - float(core["now_us"]) / 1e6
    out = []
    for ts, phase, cat, name, arg in fr["trace"][-limit:]:
        out.append({"t": epoch + ts / 1e6, "rank": rank, "kind": "span",
                    "name": name, "phase": phase, "cat": cat, "arg": arg})
    return out


def build_postmortem(job: Dict[str, Any],
                     exits: Dict[int, Dict[str, Any]],
                     health_view: Optional[Dict[str, Any]] = None,
                     flight_records: Optional[Dict[int, Dict[str, Any]]]
                     = None,
                     log_tails: Optional[Dict[int, str]] = None,
                     metric_snapshots: Optional[Dict[int, Dict[str, Any]]]
                     = None) -> Dict[str, Any]:
    """Assemble postmortem.json from everything the launcher collected.

    ``exits``: rank -> {"rc", "time" (fleet wall seconds), "by_launcher",
    "cause" (supervision verdict, optional)}.  ``health_view`` is the
    fleet_health() shape; flight records are already parsed dicts.  The
    returned object is self-contained: ``launch doctor`` renders it with
    no access to the dead job."""
    health_ranks = (health_view or {}).get("ranks", {})
    ranks: Dict[str, Any] = {}
    events: List[Dict[str, Any]] = []
    for r in sorted(exits):
        e = exits[r]
        hb_info = health_ranks.get(str(r)) or {}
        hb = hb_info.get("heartbeat")
        classification = classify_exit(e.get("rc"),
                                       bool(e.get("by_launcher")),
                                       e.get("cause"), heartbeat=hb)
        fr = (flight_records or {}).get(r)
        snap = (metric_snapshots or {}).get(r)
        info: Dict[str, Any] = {
            "exit": {"rc": e.get("rc"), "time": e.get("time"),
                     "by_launcher": bool(e.get("by_launcher")),
                     "classification": classification},
            "heartbeat": hb,
            "heartbeat_age_s": hb_info.get("age_s"),
            "flight_record": fr,
            "log_tail": (log_tails or {}).get(r),
            "metrics": _condense_metrics(snap) if snap else None,
        }
        ranks[str(r)] = info
        if e.get("time") is not None:
            events.append({"t": e["time"], "rank": r, "kind": "exit",
                           "name": classification})
        if hb and hb.get("time") is not None:
            events.append({"t": hb["time"], "rank": r, "kind": "heartbeat",
                           "name": f"step={hb.get('step')}"})
        if fr:
            events.extend(_flight_events_wall(r, fr, hb))
    events.sort(key=lambda ev: ev["t"])

    failures = [(info["exit"]["time"], int(r)) for r, info in ranks.items()
                if info["exit"]["classification"] not in _COLLATERAL
                and info["exit"]["time"] is not None]
    first_failure = None
    suspect: Dict[str, Any] = {"rank": None, "classification": "unknown",
                               "evidence": []}
    if failures:
        _, first_rank = min(failures)
        first_failure = {
            "rank": first_rank,
            "time": ranks[str(first_rank)]["exit"]["time"],
            "classification": ranks[str(first_rank)]["exit"]
            ["classification"],
        }
        # OOM suspects by pressure, not by time: the kernel kills the
        # biggest consumer, and exit times race — the rank whose final
        # heartbeat sat highest above the watermark is the one that
        # blew the cap (docs/memory.md#oom).
        oom_ranks = [int(r) for r, info in ranks.items()
                     if info["exit"]["classification"] == "oom"]
        if oom_ranks:
            suspect_rank = max(
                oom_ranks,
                key=lambda r: _mem_watermark(
                    ranks[str(r)].get("heartbeat")) or 0.0)
        else:
            suspect_rank = first_rank
        classification, evidence = classify_suspect(
            ranks[str(suspect_rank)])
        suspect = {"rank": suspect_rank, "classification": classification,
                   "evidence": evidence}
    return {
        "schema": SCHEMA,
        "created": time.time(),
        "job": job,
        "ranks": ranks,
        "first_failure": first_failure,
        "suspect": suspect,
        "events": events,
    }


def write_postmortem(pm: Dict[str, Any], path: str) -> str:
    with open(path, "w") as f:
        json.dump(pm, f, indent=1)
    return path


def load_postmortem(path: str) -> Dict[str, Any]:
    """Load postmortem.json; accepts the file or the directory holding
    it (the launch --postmortem DIR)."""
    if os.path.isdir(path):
        path = os.path.join(path, "postmortem.json")
    with open(path) as f:
        pm = json.load(f)
    if pm.get("schema") != SCHEMA:
        raise ValueError(f"{path}: schema {pm.get('schema')!r} is not "
                         f"{SCHEMA}")
    return pm
