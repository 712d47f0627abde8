"""The port's launcher: ``python -m horovod_tpu_torch.runner.launch``.

The port of ``horovod_tpu/runner/launch.py`` (the ``hvdrun`` /
``horovodrun`` equivalent; reference: horovod/runner/launch.py:242-771).
It parses the JAX launcher's flags, with the same spellings and aliases,
into ``HOROVOD_*`` env knobs, computes slot assignments, starts the
rendezvous HTTP server, and spawns one worker process per slot — locally
via subprocess, remotely via ssh (reference: gloo_run.py:114-273):

    python -m horovod_tpu_torch.runner.launch -np 4 python3 train.py
    python -m horovod_tpu_torch.runner.launch --gpu python3 train.py

Each worker gets its slot's ``HOROVOD_RANK`` / ``SIZE`` / ``LOCAL_*`` /
``CROSS_*`` / ``HOSTNAME`` block, the rendezvous address
(``HOROVOD_RENDEZVOUS_ADDR`` / ``_PORT``), the controller port and, with
more than one rank, ``HOROVOD_COORDINATOR_ADDR``: rank 0's host and
``--coordinator-port``, where ``hvd.init()`` rendezvouses the
``torch.distributed`` group (NCCL on ``cuda:<local rank>``, gloo with
``device="cpu"``).  ``--gpu`` takes the slots from this host's visible
CUDA devices (``runner/gpu_discovery.py``); the launcher itself never
creates a CUDA context.

On the first worker that exits nonzero the launcher ends the others
(SIGTERM, then SIGKILL after 10 s) and returns that worker's code; Ctrl-C
returns 130.

``--serve DIR`` runs the serving fleet in place of a training command:
every slot runs ``python -m horovod_tpu_torch.serve.worker DIR`` over the
servable directory (``serve.save_servable``), and the rendezvous server is
the router (``POST /generate``, ``GET /serve/stats``, ``POST
/admin/drain``) on ``--serve-port`` (else ``HOROVOD_SERVE_PORT``, else an
ephemeral port the banner prints).  ``--replicas N --replica-id K`` stamp
``HOROVOD_SERVE_REPLICAS``/``_REPLICA_ID``; a launch with K > 0 joins the
router that replica 0's launch hosts (:func:`serve_router_join`), as the
JAX launcher's help describes the replicated tier.  ``--serve`` turns on
the metrics and heartbeat planes, as the JAX launcher does.

The measurement plane (``utils/``): ``--metrics-port P`` pins the
rendezvous server to P, whose ``GET /metrics`` serves the fleet's
Prometheus view, and turns on per-worker publishing and the end-of-run
straggler report (the live straggler check runs every
``HOROVOD_STRAGGLER_CHECK_SECS``); ``--timeline-filename``,
``--timeline-mark-cycles`` and ``--timeline-merge OUT`` (one merged,
rank-laned trace of the fleet written at job end, the one ``GET
/timeline`` serves live); ``--autotune`` and its ``--autotune-*`` knobs;
the stall inspector's ``--no-stall-check`` and
``--stall-shutdown-time-seconds``; ``--log-level`` and
``--log-hide-timestamp``.  Each stamps the JAX launcher's env knob.  Each
worker's exit counts into ``hvd_worker_exits_total`` by cause
(``postmortem.classify_exit``).

The forensics planes: ``--postmortem DIR`` (or ``HOROVOD_POSTMORTEM_DIR``)
arms each rank's flight recorder at ``DIR/flight.rank.N``, turns the
heartbeats on (``GET /health``) and keeps the workers' log tails under
``DIR/logs`` unless ``--output-filename`` says otherwise; the launcher
supervises the heartbeats (``utils/health.HealthMonitor``, patience
``HOROVOD_HEARTBEAT_TIMEOUT``), SIGABRTs a rank whose heartbeat went
silent or whose progress froze, so its flight recorder fires, and on an
abnormal exit writes ``DIR/postmortem.json``.  ``--alerts RULES`` merges
a rules file over the watch plane's defaults in the rendezvous's alert
engine (``GET /alerts``, ``GET /series``) and publishes the merged set at
KV scope ``alerts``; ``--chaos SPEC`` checks a fault-injection spec at
launch, publishes it at KV scope ``chaos`` for every rank's injector and
exports its transport faults as ``HOROVOD_CHAOS_*``.  ``--scenario SPEC``
checks a scenario spec (``horovod_tpu_torch/scenario``) at launch,
publishes it at KV scope ``scenario`` as JSON, merges its storm with the
``--chaos`` spec into the one chaos plan the ranks install (a conflict
fails the launch) and installs its embedded alert rules under the
operator's ``--alerts``.

``doctor`` (``python -m horovod_tpu_torch.runner.launch doctor DIR``,
``--perf URL``, ``--serve URL``, ``--request RID URL``, ``--watch URL``)
renders a postmortem, the perf plane's ``GET /perf``, the fleet's
``/serve/stats`` and ``/serve/trace`` and the watch plane's ``/alerts``
and ``/series`` (``runner/doctor.py``); ``HOROVOD_PERF`` in a worker's environment starts
its perf-report publisher.

Elastic training: ``--min-np``, ``--max-np``, ``--host-discovery-script``,
``--elastic-timeout`` and ``--reset-limit`` hand the job to the elastic
driver (``elastic/driver.py``), which needs no ``-np``: it polls the
discovery script, runs reset rounds after a failure or a membership
change, and keeps its rendezvous server (with ``--serve``, the router, its
journal and the in-flight client streams) across them.

The few flags that have no meaning on a PyTorch stack
(:data:`NO_EFFECT`) are accepted with a warning, as the JAX launcher
accepts its CPU-affinity flags.  ``--mpi``,
``--gloo`` and ``--jsrun`` exit 2: the transport is ``torch.distributed``'s.
"""

from __future__ import annotations

import argparse
import datetime
import os
import shlex
import signal
import socket
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional

from . import hosts as hosts_mod
from .http_server import RendezvousServer

LOCAL_HOSTNAMES = {"localhost", "127.0.0.1", socket.gethostname()}
PROG = "python -m horovod_tpu_torch.runner.launch"

# flags with no meaning on this stack: accepted, with a warning
NO_EFFECT = {
    "binding_args": "--binding-args",
    "thread_affinity": "--thread-affinity",
    "mpi_threads_disable": "--mpi-threads-disable",
    "num_streams": "--num-streams",
}


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog=PROG,
        description="Launch distributed training of horovod_tpu_torch on "
                    "GPU hosts (horovodrun equivalent)")
    p.add_argument("-np", "--num-proc", type=int, required=False,
                   help="total number of worker processes")
    p.add_argument("--gpu", action="store_true",
                   help="take this host's slots from its visible CUDA "
                        "devices (nvidia-smi -L, cut by "
                        "CUDA_VISIBLE_DEVICES); -np defaults to their "
                        "count and may not exceed it")
    p.add_argument("--tpu", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("-H", "--hosts", "--hostnames", default=None,
                   help="comma-separated host:slots, e.g. h1:4,h2:4")
    p.add_argument("--hostfile", default=None,
                   help="file with one host:slots per line")
    p.add_argument("-p", "--ssh-port", type=int, default=None)
    p.add_argument("--ssh-identity-file", default=None)
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--version", action="store_true")
    p.add_argument("-cb", "--check-build", action="store_true",
                   help="print the build capability summary and exit")
    p.add_argument("--start-timeout", type=int, default=None,
                   help="seconds a worker waits for its peers at the "
                        "torch.distributed rendezvous "
                        "(HOROVOD_START_TIMEOUT)")
    p.add_argument("--network-interface", default=None,
                   help="network interface whose address workers should use "
                        "to reach the coordinator (e.g. ens3)")
    p.add_argument("--prefix-output-with-timestamp", action="store_true",
                   help="stamp every forwarded worker output line with "
                        "a timestamp and its rank")
    # transport selectors (reference: --mpi/--gloo/--jsrun/--tcp): the
    # port has one controller (native TCP) and one data plane
    # (torch.distributed); --tcp is a no-op and the others exit 2
    p.add_argument("--tcp", action="store_true",
                   help="use the TCP controller (always on; accepted for "
                        "reference compatibility)")
    p.add_argument("--mpi", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--gloo", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--jsrun", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--mpi-args", default=None, help=argparse.SUPPRESS)
    p.add_argument("--output-filename", default=None,
                   help="redirect each worker's stdout/stderr to "
                        "<dir>/rank.<N>/stdout|stderr")
    # --- tunables -> env knobs (reference: config_parser.py:1-202) ---
    p.add_argument("--fusion-threshold-mb", type=int, default=None)
    p.add_argument("--cycle-time-ms", type=float, default=None)
    p.add_argument("--cache-capacity", type=int, default=None)
    p.add_argument("--disable-cache", action="store_true",
                   help="disable the response/bucket-plan cache "
                        "(HOROVOD_CACHE_CAPACITY=0)")
    hier_ar = p.add_mutually_exclusive_group()
    hier_ar.add_argument("--hierarchical-allreduce", action="store_true",
                         default=None)
    hier_ar.add_argument("--no-hierarchical-allreduce",
                         dest="hierarchical_allreduce", action="store_false")
    hier_ag = p.add_mutually_exclusive_group()
    hier_ag.add_argument("--hierarchical-allgather", action="store_true",
                         default=None)
    hier_ag.add_argument("--no-hierarchical-allgather",
                         dest="hierarchical_allgather", action="store_false")
    p.add_argument("--num-streams", "--num-nccl-streams", dest="num_streams",
                   type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--mesh", default=None,
                   help="refused: the port lays out its ranks with "
                        "HOROVOD_LAYOUT (parallel/layout.py)")
    p.add_argument("--kv-shards", type=int, default=None, metavar="N",
                   help="partition the rendezvous KV across N shard "
                        "servers (HOROVOD_KV_SHARDS; docs/control-plane"
                        ".md); the shard address list is stamped into "
                        "worker env and published at KV scope 'kvshard'")
    # --- the measurement plane (utils/) ---
    p.add_argument("--metrics-port", type=int, default=None,
                   help="serve the fleet Prometheus view at "
                        "http://<driver>:PORT/metrics (pins the rendezvous "
                        "server to PORT) and enable per-worker metric "
                        "publishing + the end-of-run straggler report "
                        "(HOROVOD_METRICS)")
    p.add_argument("--timeline-filename", default=None,
                   help="each worker writes its Chrome-trace timeline "
                        "here (HOROVOD_TIMELINE)")
    p.add_argument("--timeline-merge", default=None, metavar="OUT_JSON",
                   help="write ONE merged, rank-laned Chrome/Perfetto "
                        "trace of the whole fleet at job end: every "
                        "worker records a timeline (per-rank files "
                        "OUT_JSON.rank.N.json unless --timeline-filename "
                        "is given) and publishes chunks to the "
                        "rendezvous, which also serves GET /timeline")
    tl_mc = p.add_mutually_exclusive_group()
    tl_mc.add_argument("--timeline-mark-cycles", action="store_true",
                       default=None,
                       help="mark negotiation cycles on the timeline "
                            "(HOROVOD_TIMELINE_MARK_CYCLES)")
    tl_mc.add_argument("--no-timeline-mark-cycles",
                       dest="timeline_mark_cycles", action="store_false")
    stall = p.add_mutually_exclusive_group()
    stall.add_argument("--stall-check", dest="no_stall_check",
                       action="store_false", default=None)
    stall.add_argument("--no-stall-check", action="store_true",
                       help="disable the stall inspector "
                            "(HOROVOD_STALL_CHECK_DISABLE)")
    p.add_argument("--stall-check-time-seconds",
                   "--stall-check-warning-time-seconds",
                   dest="stall_check_time_seconds", type=int, default=None,
                   help="warn when ranks disagree about a tensor for this "
                        "long (HOROVOD_STALL_CHECK_TIME_SECONDS)")
    p.add_argument("--stall-shutdown-time-seconds",
                   "--stall-check-shutdown-time-seconds",
                   dest="stall_shutdown_time_seconds", type=int,
                   default=None,
                   help="end a worker whose collective stalls this long "
                        "(HOROVOD_STALL_SHUTDOWN_TIME_SECONDS; 0 = never)")
    p.add_argument("--log-level", default=None,
                   choices=["trace", "debug", "info", "warning", "error",
                            "fatal"], help="HOROVOD_LOG_LEVEL")
    log_ts = p.add_mutually_exclusive_group()
    log_ts.add_argument("--log-hide-timestamp", "--log-without-timestamp",
                        dest="log_hide_timestamp", action="store_true",
                        default=None, help="HOROVOD_LOG_HIDE_TIME")
    log_ts.add_argument("--no-log-hide-timestamp", "--log-with-timestamp",
                        dest="log_hide_timestamp", action="store_false")
    p.add_argument("--gloo-timeout-seconds", type=int, default=None,
                   help="rendezvous KV client patience "
                        "(HOROVOD_GLOO_TIMEOUT_SECONDS)")
    p.add_argument("--binding-args", default=None, help=argparse.SUPPRESS)
    p.add_argument("--thread-affinity", default=None,
                   help=argparse.SUPPRESS)
    mpi_thr = p.add_mutually_exclusive_group()
    mpi_thr.add_argument("--mpi-threads-disable", action="store_true",
                         default=None, help=argparse.SUPPRESS)
    mpi_thr.add_argument("--no-mpi-threads-disable",
                         dest="mpi_threads_disable", action="store_false",
                         help=argparse.SUPPRESS)
    p.add_argument("--autotune", action="store_true",
                   help="Bayesian autotuning of the fusion threshold and "
                        "cycle time (HOROVOD_AUTOTUNE)")
    p.add_argument("--autotune-log-file", default=None,
                   help="CSV log of the tuned points (HOROVOD_AUTOTUNE_LOG)")
    p.add_argument("--autotune-warmup-samples", type=int, default=None)
    p.add_argument("--autotune-steps-per-sample", type=int, default=None)
    p.add_argument("--autotune-bayes-opt-max-samples", type=int,
                   default=None)
    p.add_argument("--autotune-gaussian-process-noise", type=float,
                   default=None)
    p.add_argument("--config-file", default=None,
                   help="YAML config (reference schema: params/autotune/"
                        "timeline/stall-check sections)")
    p.add_argument("--postmortem", default=None, metavar="DIR",
                   help="crash-forensics directory: workers arm the native "
                        "flight recorder (per-rank DIR/flight.rank.N) and "
                        "publish heartbeats served at GET /health; the "
                        "launcher supervises heartbeat loss and progress "
                        "stalls and on an abnormal exit writes "
                        "DIR/postmortem.json; render it with `launch "
                        "doctor DIR`")
    p.add_argument("--serve", default=None, metavar="CKPT_DIR",
                   help="serving mode (docs/serving.md): instead of a "
                        "training command, every slot runs a "
                        "continuous-batching inference worker over the "
                        "servable directory (serve.json + checkpoint); "
                        "the rendezvous server grows a POST /generate "
                        "router, GET /serve/stats and POST /admin/drain, "
                        "and the metrics and heartbeat planes are on "
                        "(HOROVOD_METRICS, HOROVOD_HEARTBEAT)")
    p.add_argument("--serve-port", type=int, default=None,
                   help="pin the rendezvous/router port for --serve "
                        "(HOROVOD_SERVE_PORT; default: the knob, else "
                        "an ephemeral port printed at startup)")
    p.add_argument("--serve-ttl", type=float, default=None,
                   help="seconds the serving fleet stays up before a "
                        "clean exit (0/omitted = until interrupted or "
                        "drained)")
    p.add_argument("--serve-device", default=None, metavar="DEVICE",
                   help="with --serve: the workers' device (passed as "
                        "their --device); default cuda:<local rank>, and "
                        "'cpu' is the only way onto the CPU")
    p.add_argument("--replicas", type=int, default=None,
                   help="with --serve: total serving replica fleets "
                        "behind the shared router "
                        "(HOROVOD_SERVE_REPLICAS)")
    p.add_argument("--replica-id", type=int, default=None,
                   help="with --serve: this launch's replica index "
                        "(0..replicas-1, HOROVOD_SERVE_REPLICA_ID); "
                        "replica 0 hosts the router, the rest join it at "
                        "--serve-port")
    p.add_argument("--alerts", default=None, metavar="RULES_YAML",
                   help="alert rules for the watch plane: checked at "
                        "launch, merged over the default rules by name, "
                        "published at KV scope 'alerts' and evaluated "
                        "by the rendezvous against the fleet series; "
                        "firing alerts at GET /alerts (follow them: "
                        "`launch doctor --watch URL`)")
    p.add_argument("--chaos", default=None, metavar="SPEC_YAML",
                   help="deterministic fault-injection spec: checked at "
                        "launch, published at KV scope 'chaos' so every "
                        "rank injects from one seeded plan; transport "
                        "faults export as HOROVOD_CHAOS_* env for the "
                        "native core")
    p.add_argument("--scenario", default=None, metavar="SPEC_YAML",
                   help="declarative workload scenario "
                        "(horovod_tpu_torch/scenario): checked at launch, "
                        "published at KV scope 'scenario'; its fault "
                        "storm merges with --chaos (a conflict fails the "
                        "launch) and its alert rules install under any "
                        "--alerts rules")
    p.add_argument("--min-np", type=int, default=None,
                   help="elastic: the fewest workers a round runs with "
                        "(default -np, else 1)")
    p.add_argument("--max-np", type=int, default=None,
                   help="elastic: the most workers a round runs with "
                        "(default -np, else unbounded)")
    p.add_argument("--host-discovery-script", default=None,
                   help="elastic: an executable printing the available "
                        "hosts, one host[:slots] a line; the driver polls "
                        "it and resets the round when the set changes")
    p.add_argument("--slots", "--slots-per-host", dest="slots", type=int,
                   default=None,
                   help="with --gpu: slots on this host (at most its "
                        "visible cards)")
    p.add_argument("--elastic-timeout", type=int, default=None,
                   help="elastic: seconds to wait for --min-np slots "
                        "(HOROVOD_ELASTIC_TIMEOUT)")
    p.add_argument("--reset-limit", type=int, default=None,
                   help="elastic: reset rounds before the job gives up "
                        "(HOROVOD_ELASTIC_RESET_LIMIT; 0 = unlimited)")
    # --- ports ---
    p.add_argument("--coordinator-port", type=int, default=29500)
    p.add_argument("--controller-port", type=int, default=29499)
    p.add_argument("command", nargs=argparse.REMAINDER,
                   help="training command")
    return p


def refused_flag(args: argparse.Namespace) -> Optional[str]:
    """The refusal message of a flag that names the JAX package's devices
    (``--mesh``, ``--tpu``), else None."""
    if getattr(args, "mesh", None):
        return (f"{PROG}: --mesh names the JAX package's device mesh; the "
                "port lays out its ranks with HOROVOD_LAYOUT "
                "(parallel/layout.py)")
    if getattr(args, "tpu", False):
        return (f"{PROG}: --tpu discovers a TPU slice; the port runs one "
                "process per CUDA device: use --gpu")
    return None


def config_file_to_env(path: str, env: Dict[str, str]) -> None:
    """YAML config -> env knobs (reference: config_parser.py:202 schema),
    as in the JAX launcher; ``params.mesh`` (the JAX package's device
    mesh) raises ValueError."""
    import yaml
    with open(path) as f:
        cfg = yaml.safe_load(f) or {}
    params = cfg.get("params", {})
    mapping = {
        "fusion_threshold_mb": lambda v: ("HOROVOD_FUSION_THRESHOLD",
                                          str(int(v) * 1024 * 1024)),
        "cycle_time_ms": lambda v: ("HOROVOD_CYCLE_TIME", str(v)),
        "cache_capacity": lambda v: ("HOROVOD_CACHE_CAPACITY", str(v)),
    }
    if "mesh" in params:
        raise ValueError(f"{path}: params.mesh names the JAX package's "
                         "device mesh; the port lays out its ranks with "
                         "HOROVOD_LAYOUT (parallel/layout.py)")
    for k, v in params.items():
        if k in mapping:
            name, val = mapping[k](v)
            env[name] = val
    tl = cfg.get("timeline", {})
    if tl.get("filename"):
        env["HOROVOD_TIMELINE"] = tl["filename"]
    if tl.get("mark_cycles"):
        env["HOROVOD_TIMELINE_MARK_CYCLES"] = "1"
    sc = cfg.get("stall_check", {})
    if sc.get("disable"):
        env["HOROVOD_STALL_CHECK_DISABLE"] = "1"
    if sc.get("warning_time_seconds") is not None:
        env["HOROVOD_STALL_CHECK_TIME_SECONDS"] = \
            str(sc["warning_time_seconds"])
    if sc.get("shutdown_time_seconds") is not None:
        env["HOROVOD_STALL_SHUTDOWN_TIME_SECONDS"] = \
            str(sc["shutdown_time_seconds"])
    at = cfg.get("autotune", {})
    if at.get("enabled"):
        env["HOROVOD_AUTOTUNE"] = "1"
    if at.get("log_file"):
        env["HOROVOD_AUTOTUNE_LOG"] = at["log_file"]


def args_to_env(args: argparse.Namespace) -> Dict[str, str]:
    """CLI flags win over config file, which wins over ambient env
    (reference: launch.py + config_parser layering)."""
    env: Dict[str, str] = {}
    if args.config_file:
        config_file_to_env(args.config_file, env)
    if args.fusion_threshold_mb is not None:
        env["HOROVOD_FUSION_THRESHOLD"] = str(
            args.fusion_threshold_mb * 1024 * 1024)
    if args.cycle_time_ms is not None:
        env["HOROVOD_CYCLE_TIME"] = str(args.cycle_time_ms)
    if args.cache_capacity is not None:
        env["HOROVOD_CACHE_CAPACITY"] = str(args.cache_capacity)
    if args.disable_cache:
        env["HOROVOD_CACHE_CAPACITY"] = "0"
    if args.hierarchical_allreduce is not None:
        env["HOROVOD_HIERARCHICAL_ALLREDUCE"] = \
            "1" if args.hierarchical_allreduce else "0"
    if args.hierarchical_allgather is not None:
        env["HOROVOD_HIERARCHICAL_ALLGATHER"] = \
            "1" if args.hierarchical_allgather else "0"
    if args.start_timeout is not None:
        env["HOROVOD_START_TIMEOUT"] = str(args.start_timeout)
    if args.metrics_port is not None:
        env["HOROVOD_METRICS"] = "1"
    if args.timeline_filename:
        env["HOROVOD_TIMELINE"] = args.timeline_filename
    if args.timeline_mark_cycles is not None:
        env["HOROVOD_TIMELINE_MARK_CYCLES"] = \
            "1" if args.timeline_mark_cycles else "0"
    if args.no_stall_check is not None:
        env["HOROVOD_STALL_CHECK_DISABLE"] = \
            "1" if args.no_stall_check else "0"
    if args.log_hide_timestamp is not None:
        env["HOROVOD_LOG_HIDE_TIME"] = \
            "1" if args.log_hide_timestamp else "0"
    if args.gloo_timeout_seconds is not None:
        env["HOROVOD_GLOO_TIMEOUT_SECONDS"] = \
            str(args.gloo_timeout_seconds)
    if args.stall_check_time_seconds is not None:
        env["HOROVOD_STALL_CHECK_TIME_SECONDS"] = \
            str(args.stall_check_time_seconds)
    if args.stall_shutdown_time_seconds is not None:
        env["HOROVOD_STALL_SHUTDOWN_TIME_SECONDS"] = \
            str(args.stall_shutdown_time_seconds)
    if args.log_level:
        env["HOROVOD_LOG_LEVEL"] = args.log_level
    if args.autotune:
        env["HOROVOD_AUTOTUNE"] = "1"
    if args.autotune_log_file:
        env["HOROVOD_AUTOTUNE_LOG"] = args.autotune_log_file
    if args.autotune_warmup_samples is not None:
        env["HOROVOD_AUTOTUNE_WARMUP_SAMPLES"] = \
            str(args.autotune_warmup_samples)
    if args.autotune_steps_per_sample is not None:
        env["HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE"] = \
            str(args.autotune_steps_per_sample)
    if args.autotune_bayes_opt_max_samples is not None:
        env["HOROVOD_AUTOTUNE_BAYES_OPT_MAX_SAMPLES"] = \
            str(args.autotune_bayes_opt_max_samples)
    if args.autotune_gaussian_process_noise is not None:
        env["HOROVOD_AUTOTUNE_GAUSSIAN_PROCESS_NOISE"] = \
            str(args.autotune_gaussian_process_noise)
    if args.elastic_timeout is not None:
        env["HOROVOD_ELASTIC_TIMEOUT"] = str(args.elastic_timeout)
    if args.reset_limit is not None:
        env["HOROVOD_ELASTIC_RESET_LIMIT"] = str(args.reset_limit)
    chaos_spec = merged_chaos_spec(args)
    if chaos_spec is not None:
        env["HOROVOD_CHAOS"] = "1"
        env.update(chaos_spec.transport_env())
    if getattr(args, "serve", None):
        # serving workers publish hvd_serve_* metrics and heartbeats like
        # any trainer; this launch's fleet is replica K of N behind a
        # shared router
        env.setdefault("HOROVOD_METRICS", "1")
        env.setdefault("HOROVOD_HEARTBEAT", "1")
        if getattr(args, "replicas", None) is not None:
            env["HOROVOD_SERVE_REPLICAS"] = str(args.replicas)
        if getattr(args, "replica_id", None) is not None:
            env["HOROVOD_SERVE_REPLICA_ID"] = str(args.replica_id)
    for dest, flag in NO_EFFECT.items():
        if getattr(args, dest, None) is not None:
            print(f"{PROG}: {flag} has no effect on the PyTorch port "
                  "(CPU-affinity, MPI-thread and stream-count knobs); "
                  "accepted for launch-script compatibility only",
                  file=sys.stderr)
    return env


def load_chaos_spec(args: argparse.Namespace):
    """The ``--chaos`` spec, parsed and checked once per launch (cached on
    the namespace, so the env and the KV publish share one parse: a typo'd
    spec fails the launch, not a worker mid-run), or None."""
    if not getattr(args, "chaos", None):
        return None
    if getattr(args, "_chaos_spec", None) is None:
        from ..chaos import load_spec
        args._chaos_spec = load_spec(args.chaos)
    return args._chaos_spec


def load_scenario_spec(args: argparse.Namespace):
    """The ``--scenario`` spec, parsed and checked once per launch (cached
    on the namespace, as :func:`load_chaos_spec`: a typo'd scenario fails
    the launch, not a worker mid-replay), or None."""
    if not getattr(args, "scenario", None):
        return None
    if getattr(args, "_scenario_spec", None) is None:
        from ..scenario import load_scenario
        args._scenario_spec = load_scenario(args.scenario)
    return args._scenario_spec


def merged_chaos_spec(args: argparse.Namespace):
    """The one chaos plan this launch distributes: the ``--chaos`` spec
    merged with the ``--scenario`` storm, whose logical-clock events land
    as step-scheduled events (``scenario.to_chaos_spec``) after the
    ``--chaos`` ones (``chaos.merge_specs``).  Conflicting scalars fail
    the launch (ValueError); None when neither side brings a plan."""
    if getattr(args, "_merged_chaos", None) is None:
        base = load_chaos_spec(args)
        scen = load_scenario_spec(args)
        storm_spec = None
        if scen is not None and scen.storm:
            from ..scenario import to_chaos_spec
            storm_spec = to_chaos_spec(scen.storm, scen.tick_s,
                                       seed=scen.seed)
        if base is not None and storm_spec is not None:
            from ..chaos import merge_specs
            args._merged_chaos = merge_specs(base, storm_spec)
        else:
            args._merged_chaos = base or storm_spec
    return args._merged_chaos


def publish_chaos_spec(args: argparse.Namespace,
                       rendezvous: RendezvousServer) -> None:
    """Put the (merged) chaos spec on the rendezvous KV (scope ``chaos``),
    so every rank, local or ssh-remote, installs its injector from one
    plan."""
    spec = merged_chaos_spec(args)
    if spec is None:
        return
    from ..chaos import KV_KEY, KV_SCOPE
    rendezvous.put(KV_SCOPE, KV_KEY, spec.to_json().encode())


def publish_scenario_spec(args: argparse.Namespace,
                          rendezvous: RendezvousServer) -> None:
    """Put the scenario spec on the rendezvous KV (scope ``scenario``) as
    JSON, so every rank (and any replay pointed at the fleet) reads one
    plan with no YAML parser."""
    spec = load_scenario_spec(args)
    if spec is None:
        return
    from ..scenario import KV_KEY, KV_SCOPE
    rendezvous.put(KV_SCOPE, KV_KEY, spec.to_json().encode())


def install_alert_rules(args: argparse.Namespace,
                        rendezvous: RendezvousServer) -> None:
    """Resolve the user ruleset (``--alerts`` > HOROVOD_ALERTS > none),
    merge it over the defaults in the rendezvous's alert engine and
    publish the merged set at KV scope ``alerts``; a ``--scenario`` spec's
    embedded rules join under the operator's (an operator rule of the same
    name wins).  A malformed rules file fails the launch (the parse raises
    ValueError), never a detector mid-run."""
    path = getattr(args, "alerts", None) \
        or os.environ.get("HOROVOD_ALERTS") or None
    rules = None
    if path:
        if getattr(args, "_alert_rules", None) is None:
            from ..watch import load_rules
            args._alert_rules = load_rules(path)
        rules = args._alert_rules
    scen = load_scenario_spec(args)
    if scen is not None and scen.alert_rules:
        from ..watch import parse_rules
        operator_names = {r.name for r in (rules or [])}
        scen_rules = [r for r in parse_rules(scen.alert_rules)
                      if r.name not in operator_names]
        rules = scen_rules + (rules or []) if scen_rules else rules
    rendezvous.install_alert_rules(rules)


def _pump_prefixed(stream, sink, rank: int, close_sink: bool) -> None:
    """Copy a child stream line-by-line, prefixing each line with a
    timestamp and the rank (reference: --prefix-output-with-timestamp).
    File sinks are closed at EOF; the process-wide std streams are not."""
    for raw in iter(stream.readline, b""):
        ts = datetime.datetime.now().strftime("%Y-%m-%d %H:%M:%S.%f")[:-3]
        sink.write(f"[{ts}]<rank {rank}> ".encode() + raw)
        sink.flush()
    stream.close()
    if close_sink:
        sink.close()


def join_output_pumps(proc, timeout: float = 10.0) -> None:
    """Drain a prefixed worker's forwarder threads after it exits —
    without this, output still buffered in the pipes (often the final
    traceback) is lost when the launcher exits."""
    for t in getattr(proc, "_hvd_pump_threads", ()):
        t.join(timeout=timeout)


def spawn_with_output(cmd: List[str], env: Dict[str, str],
                      output_filename: Optional[str], rank: int,
                      mode: str = "wb",
                      prefix_timestamp: bool = False) -> subprocess.Popen:
    """Spawn a worker, optionally redirecting its streams to
    <output_filename>/rank.<N>/stdout|stderr (reference:
    --output-filename).  ssh forwards remote streams, so launcher-side
    redirection covers both paths.  ``prefix_timestamp`` routes the
    streams through the launcher and stamps every line."""
    if not output_filename and not prefix_timestamp:
        return subprocess.Popen(cmd, env=env)
    if output_filename:
        d = os.path.join(output_filename, f"rank.{rank}")
        os.makedirs(d, exist_ok=True)
        out_path = os.path.join(d, "stdout")
        err_path = os.path.join(d, "stderr")
        if not prefix_timestamp:
            with open(out_path, mode) as out, open(err_path, mode) as err:
                # the child holds its own dups; drop the parent's handles
                return subprocess.Popen(cmd, env=env, stdout=out,
                                        stderr=err)
        sinks = (open(out_path, mode), open(err_path, mode))
        close_sink = True
    else:
        sinks = (sys.stdout.buffer, sys.stderr.buffer)
        close_sink = False
    try:
        proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE)
    except BaseException:
        if close_sink:
            for s in sinks:
                s.close()
        raise
    proc._hvd_pump_threads = [
        threading.Thread(target=_pump_prefixed,
                         args=(stream, sink, rank, close_sink),
                         daemon=True)
        for stream, sink in zip((proc.stdout, proc.stderr), sinks)]
    for t in proc._hvd_pump_threads:
        t.start()
    return proc


def check_build() -> str:
    """Capability summary, under the JAX launcher's headings (reference:
    launch.py check_build).  Framework rows probe importability here;
    NCCL and gloo are what this torch build's ``torch.distributed`` has,
    and the Hopper kernels need ``nvcc`` to build (``ops/_kernels.py``).
    Nothing here touches CUDA."""
    import importlib.util

    def probe(mod: str) -> bool:
        try:
            return importlib.util.find_spec(mod) is not None
        except (ImportError, ModuleNotFoundError, ValueError):
            return False

    def mark(flag: bool) -> str:
        return "[X]" if flag else "[ ]"

    nccl = gloo = False
    version = "not importable"
    if probe("torch"):
        import torch
        import torch.distributed as dist
        version = torch.__version__
        if dist.is_available():
            nccl, gloo = dist.is_nccl_available(), dist.is_gloo_available()
    try:
        from ..ops._kernels import nvcc_path
        nvcc = nvcc_path()
    except Exception:
        nvcc = None
    lines = [
        "horovod_tpu_torch (the PyTorch/CUDA port):", "",
        "Available Frameworks:",
        f"    {mark(probe('torch'))} PyTorch ({version})", "",
        "Available Controllers:",
        "    [X] TCP (native C++ coordination core, g++ at first use)",
        "    [ ] MPI", "",
        "Available Tensor Operations:",
        f"    {mark(nccl)} NCCL (torch.distributed)",
        f"    {mark(gloo)} Gloo (torch.distributed)",
        "    [X] Hierarchical two-level (host and cross-host groups)",
        "    [X] Adasum (recursive halving over point-to-point)",
        "    [ ] DDL",
        "    [ ] CCL",
        "    [ ] MPI", "",
        "Hopper kernels (flash attention, sm_90a):",
        f"    {mark(nvcc is not None)} nvcc"
        + (f" ({nvcc})" if nvcc else " (not found: the kernels cannot be "
           "built on this host)"),
    ]
    return "\n".join(lines)


def interface_address(ifname: str) -> str:
    """IPv4 address of a network interface (reference: --network-interface
    pins gloo/NCCL traffic to specific NICs; here it pins the rendezvous +
    coordinator address workers dial)."""
    import fcntl
    import struct
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        # SIOCGIFADDR
        packed = fcntl.ioctl(s.fileno(), 0x8915,
                             struct.pack("256s", ifname[:15].encode()))
        return socket.inet_ntoa(packed[20:24])
    finally:
        s.close()


def resolve_coord_host(rank0_hostname: str,
                       network_interface: Optional[str],
                       warn=None, has_remote_workers: bool = False) -> str:
    """The address workers dial for the coordinator: rank 0's host.

    When rank 0 is THIS machine: a NIC pin resolves to that interface's
    address (remotely dialable); otherwise loopback for all-local runs,
    but the real hostname when remote workers exist — they cannot dial
    127.0.0.1.  When rank 0 is remote, its NIC address can't be resolved
    launcher-side; ``warn`` is called and the hostname used as-is."""
    if _is_local(rank0_hostname):
        if network_interface:
            return interface_address(network_interface)
        if not has_remote_workers:
            return "127.0.0.1"
        if rank0_hostname == "localhost" or \
                rank0_hostname.startswith("127."):
            # any loopback alias is undialable from a remote worker
            return socket.gethostname()
        return rank0_hostname
    if network_interface and warn is not None:
        warn(f"--network-interface {network_interface} ignored — rank 0 "
             f"is on remote host {rank0_hostname}, whose NIC address "
             f"cannot be resolved launcher-side")
    return rank0_hostname


def resolve_hosts(args: argparse.Namespace) -> List[hosts_mod.HostInfo]:
    """The host list: ``--hostfile``, ``-H``, ``--gpu`` (this host's
    visible cards), the surrounding LSF allocation, else localhost with
    ``-np`` slots."""
    if args.hosts and args.hostfile:
        raise ValueError("use either --hosts or --hostfile, not both")
    gpu = getattr(args, "gpu", False)
    if gpu and (args.hosts or args.hostfile):
        raise ValueError("--gpu discovers the host list; drop -H/--hostfile")
    if args.hostfile:
        with open(args.hostfile) as f:
            spec = ",".join(line.strip() for line in f
                            if line.strip() and not line.startswith("#"))
        return hosts_mod.parse_hosts(spec)
    if args.hosts:
        return hosts_mod.parse_hosts(args.hosts)
    if gpu:
        from .gpu_discovery import discover_gpu_hosts
        found = discover_gpu_hosts(slots_per_host=args.slots)
        if found is None:
            raise ValueError(
                "--gpu: no CUDA device visible on this host (nvidia-smi -L "
                "lists none, or CUDA_VISIBLE_DEVICES hides them)")
        total = sum(h.slots for h in found)
        if args.num_proc and args.num_proc > total:
            raise ValueError(
                f"--gpu: -np {args.num_proc} exceeds the {total} CUDA "
                "device(s) this host shows; NCCL cannot put two ranks on "
                "one card")
        return found
    # LSF allocation (bsub): the scheduler already granted hosts/slots;
    # consume them so a bare launch works without -H.  -np beyond the
    # granted slots falls back to local launch (an interactive 1-slot bsub
    # shell must not break -np 4).
    from .lsf import lsf_hosts
    allocated = lsf_hosts()
    if allocated is not None:
        total = sum(h.slots for h in allocated)
        if args.num_proc and args.num_proc > total:
            print(f"{PROG}: LSF allocation present ({len(allocated)} "
                  f"hosts, {total} slots) but -np {args.num_proc} "
                  "exceeds its slots; launching locally",
                  file=sys.stderr)
            return [hosts_mod.HostInfo("localhost", args.num_proc or 1)]
        return allocated
    return [hosts_mod.HostInfo("localhost", args.num_proc or 1)]


def _is_local(hostname: str) -> bool:
    # any 127.0.0.0/8 address is this machine by definition
    return hostname in LOCAL_HOSTNAMES or hostname.startswith("127.")


def build_worker_command(slot: hosts_mod.SlotInfo, command: List[str],
                         env_updates: Dict[str, str],
                         ssh_port: Optional[int],
                         ssh_identity: Optional[str]) -> List[str]:
    """The exec vector for one slot: plain command locally, ssh wrapper
    remotely (reference: gloo_run.py:114-186)."""
    if _is_local(slot.hostname):
        return list(command)
    exports = " ".join(f"{k}={shlex.quote(v)}"
                       for k, v in sorted(env_updates.items()))
    remote = (f"cd {shlex.quote(os.getcwd())} && env {exports} "
              + " ".join(shlex.quote(c) for c in command))
    ssh_cmd = ["ssh", "-o", "StrictHostKeyChecking=no"]
    if ssh_port:
        ssh_cmd += ["-p", str(ssh_port)]
    if ssh_identity:
        ssh_cmd += ["-i", ssh_identity]
    ssh_cmd += [slot.hostname, remote]
    return ssh_cmd


def resolve_kv_shards(args: argparse.Namespace) -> int:
    """Rendezvous-KV shard count: flag > HOROVOD_KV_SHARDS env > 1.
    Validated here so a bad value fails the launch, not a worker."""
    if getattr(args, "kv_shards", None) is not None:
        n = int(args.kv_shards)
    else:
        try:
            n = int(os.environ.get("HOROVOD_KV_SHARDS", "") or 1)
        except ValueError:
            n = 1
    if n < 1:
        raise ValueError(f"--kv-shards {n} invalid; the rendezvous KV "
                         "needs at least one shard "
                         "(docs/control-plane.md)")
    return n


def stamp_kv_shard_env(updates: Dict[str, str], coord_host: str,
                       rendezvous: RendezvousServer,
                       kv_shards: int) -> None:
    """Worker-env half of the shard map contract: the count plus the
    primary-first address list every KV client routes with."""
    if kv_shards <= 1:
        return
    updates["HOROVOD_KV_SHARDS"] = str(kv_shards)
    updates["HOROVOD_KV_SHARD_ADDRS"] = ",".join(
        f"{coord_host}:{p}" for p in rendezvous.shard_ports)


def resolve_serve_port(args: argparse.Namespace) -> int:
    """--serve's router port: flag > HOROVOD_SERVE_PORT env > 0
    (ephemeral; the startup banner prints the bound port)."""
    if not getattr(args, "serve", None):
        return 0
    if getattr(args, "serve_port", None) is not None:
        return args.serve_port
    try:
        return int(os.environ.get("HOROVOD_SERVE_PORT", "") or 0)
    except ValueError:
        return 0


def serve_router_join(args: argparse.Namespace) -> Optional[tuple]:
    """``(addr, port)`` of the router a replica fleet other than replica 0
    joins, else None: replica 0's launch hosts the router at
    ``--serve-port`` (HOROVOD_SERVE_PORT) on this host, or on the host
    HOROVOD_RENDEZVOUS_ADDR names in the launcher's env, and the other
    replicas' workers serve through it under their scoped KV names
    (``serve/replica.py``).  The JAX launcher's help promises this, but
    every JAX launch starts a router of its own."""
    if not getattr(args, "serve", None) or not getattr(args, "replica_id",
                                                       None):
        return None
    port = resolve_serve_port(args)
    if not port:
        raise ValueError(f"--replica-id {args.replica_id} joins replica "
                         "0's router: give its port with --serve-port")
    return os.environ.get("HOROVOD_RENDEZVOUS_ADDR") or "127.0.0.1", port


def serve_worker_command(args: argparse.Namespace) -> List[str]:
    """The worker vector --serve substitutes for a training command: one
    continuous-batching inference worker per slot (serve/worker.py)."""
    cmd = [sys.executable, "-m", "horovod_tpu_torch.serve.worker",
           args.serve]
    if getattr(args, "serve_ttl", None):
        cmd += ["--ttl", str(args.serve_ttl)]
    if getattr(args, "serve_device", None):
        cmd += ["--device", args.serve_device]
    return cmd


def harvest_metric_snapshots(rendezvous: RendezvousServer) -> Dict:
    """rank -> snapshot dict from the rendezvous ``metrics`` scope (the
    shared source of the end-of-run report and the live straggler
    monitor)."""
    import json as _json
    snaps = {}
    for key, value in rendezvous.scope_items("metrics").items():
        if not key.startswith("rank."):
            continue
        try:
            snaps[int(key.split(".", 1)[1])] = _json.loads(value)
        except (ValueError, TypeError):
            continue
    return snaps


def report_stragglers(rendezvous: RendezvousServer, sink=None) -> None:
    """Harvest the workers' metric snapshots from the rendezvous KV and
    print the rank-0 straggler report (per-rank negotiation-age p50/p99,
    naming the slowest rank)."""
    from ..utils import metrics as M
    report = M.straggler_report(harvest_metric_snapshots(rendezvous))
    if report:
        print(report, file=sink or sys.stderr, flush=True)


def write_merged_timeline(rendezvous: RendezvousServer, path: str,
                          sink=None) -> bool:
    """Render the ``timeline`` KV scope as one merged Chrome/Perfetto JSON
    (``--timeline-merge``; the same merge GET /timeline serves live).
    Returns False when no worker published any chunk."""
    import json as _json
    from ..utils.timeline import merge_timeline_chunks
    merged = merge_timeline_chunks(rendezvous.scope_items("timeline"))
    have_events = any(e.get("ph") != "M" for e in merged["traceEvents"])
    with open(path, "w") as f:
        _json.dump(merged, f)
    print(f"{PROG}: merged timeline: {path} "
          f"({len(merged['traceEvents'])} events, "
          f"{len(merged['metadata']['clock_sync'])} rank clocks)"
          + ("" if have_events else " - no worker published trace chunks"),
          file=sink or sys.stderr, flush=True)
    return have_events


def _log_tail(output_filename: str, rank: int, limit: int = 4000) -> str:
    """The last bytes of a rank's redirected streams (stderr carries the
    tracebacks and the chaos and stall warnings the classifier keys
    on)."""
    tail = ""
    for stream in ("stdout", "stderr"):
        fp = os.path.join(output_filename, f"rank.{rank}", stream)
        try:
            with open(fp, errors="replace") as f:
                data = f.read()
        except OSError:
            continue
        if data.strip():
            tail += data[-limit:]
    return tail


def write_job_postmortem(rendezvous: RendezvousServer, postmortem_dir: str,
                         exits: Dict[int, dict], command: List[str],
                         np_: int, output_filename: Optional[str] = None,
                         sink=None) -> str:
    """Collect the fleet's forensics (the ranks' flight records, log
    tails, final heartbeats and condensed metric snapshots) and write
    ``DIR/postmortem.json`` (``postmortem.build_postmortem``).  The
    launcher calls it on an abnormal exit; ``launch doctor DIR`` renders
    it."""
    from .. import postmortem as PM
    from ..utils.health import fleet_health
    view = fleet_health(rendezvous.scope_items("health"),
                        rendezvous.scope_receipt_times("health"))
    flights = {}
    for rank in exits:
        p = os.path.join(postmortem_dir, f"flight.rank.{rank}")
        if os.path.exists(p):
            try:
                flights[rank] = PM.parse_flight_record(p)
            except (OSError, ValueError):
                continue  # a torn record is absent evidence, not a crash
    tails = {}
    if output_filename:
        for rank in exits:
            t = _log_tail(output_filename, rank)
            if t:
                tails[rank] = t
    pm = PM.build_postmortem(
        job={"np": np_, "command": list(command)},
        exits=exits, health_view=view, flight_records=flights,
        log_tails=tails,
        metric_snapshots=harvest_metric_snapshots(rendezvous))
    path = PM.write_postmortem(
        pm, os.path.join(postmortem_dir, "postmortem.json"))
    suspect = pm.get("suspect", {})
    print(f"{PROG}: postmortem: {path}: suspect rank "
          f"{suspect.get('rank')} ({suspect.get('classification')}); "
          f"render: {PROG} doctor {postmortem_dir}",
          file=sink or sys.stderr, flush=True)
    return path


class _Terminated(Exception):
    """SIGTERM to the launcher: end the workers as Ctrl-C does."""


def _raise_terminated(signum, frame):
    raise _Terminated()


def launch_static(args: argparse.Namespace, command: List[str],
                  rendezvous: Optional[RendezvousServer] = None,
                  extra_env: Optional[Dict[str, str]] = None) -> int:
    """Static run (reference: _run_static launch.py:528-618 + launch_gloo
    gloo_run.py:226-273): publish each slot's env to the ``rank`` scope,
    spawn, reap with fail-fast.  ``rendezvous`` (started, stopped here)
    lets a caller read what the workers put after the job (``run()``);
    ``extra_env`` joins every worker's env."""
    host_infos = resolve_hosts(args)
    np_ = args.num_proc or sum(h.slots for h in host_infos)
    slots = hosts_mod.get_host_assignments(host_infos, np_)
    kv_shards = resolve_kv_shards(args)
    join = serve_router_join(args)
    if join is not None and kv_shards > 1:
        raise ValueError("--kv-shards: a replica fleet that joins replica "
                         "0's router uses that router's KV")
    # --metrics-port pins the rendezvous server so /metrics is scrapeable
    # at a known address; metrics also engage via the ambient env knob,
    # and --serve implies them (the hvd_serve_* SLO families)
    metrics_enabled = (args.metrics_port is not None
                       or getattr(args, "serve", None) is not None
                       or os.environ.get("HOROVOD_METRICS", "") not in
                       ("", "0", "false"))
    # the postmortem plane: flight records, heartbeats, supervision and
    # postmortem.json on an abnormal exit
    postmortem_dir = (getattr(args, "postmortem", None)
                      or os.environ.get("HOROVOD_POSTMORTEM_DIR") or None)
    if postmortem_dir:
        os.makedirs(postmortem_dir, exist_ok=True)
        if not args.output_filename:
            # log tails are evidence: the classifier keys on stderr's
            # tracebacks and warnings
            args.output_filename = os.path.join(postmortem_dir, "logs")
    if rendezvous is None:
        # port priority: --metrics-port > --serve-port > HOROVOD_SERVE_PORT
        # > ephemeral
        rendezvous = RendezvousServer(
            port=0 if join else (args.metrics_port
                                 or resolve_serve_port(args)),
            shards=kv_shards)
        rendezvous.start()
    rdv_port = rendezvous.port
    if join is not None:
        print(f"{PROG}: serving {args.serve} as replica {args.replica_id}"
              f" behind the router at http://{join[0]}:{join[1]}",
              file=sys.stderr, flush=True)
    elif getattr(args, "serve", None):
        print(f"{PROG}: serving {args.serve}: POST http://"
              f"{socket.gethostname()}:{rdv_port}/generate  (stats: GET "
              "/serve/stats, drain: POST /admin/drain, metrics: GET "
              "/metrics)", file=sys.stderr, flush=True)
    publish_chaos_spec(args, rendezvous)
    publish_scenario_spec(args, rendezvous)
    install_alert_rules(args, rendezvous)
    for slot in slots:
        rendezvous.put("rank", str(slot.rank),
                       repr(slot.to_env()).encode())

    coord_host = resolve_coord_host(
        slots[0].hostname, args.network_interface,
        warn=lambda m: print(f"{PROG}: warning: {m}", file=sys.stderr),
        has_remote_workers=any(not _is_local(s.hostname) for s in slots))
    if kv_shards > 1:
        rendezvous.publish_shard_map(coord_host)
        print(f"{PROG}: rendezvous KV sharded {kv_shards}x: ports "
              f"{rendezvous.shard_ports}", file=sys.stderr, flush=True)
    knob_env = args_to_env(args)
    knob_env.update(extra_env or {})

    def spawn(slot: hosts_mod.SlotInfo) -> subprocess.Popen:
        # One env block serves both paths: local Popen env AND the ssh
        # `env k=v` export list — remote workers must see the rendezvous/
        # coordinator/controller addresses too.
        updates = dict(knob_env)
        updates.update(slot.to_env())
        updates["HOROVOD_RENDEZVOUS_ADDR"] = join[0] if join else coord_host
        updates["HOROVOD_RENDEZVOUS_PORT"] = str(join[1] if join
                                                 else rdv_port)
        updates["HOROVOD_CONTROLLER_PORT"] = str(args.controller_port)
        stamp_kv_shard_env(updates, coord_host, rendezvous, kv_shards)
        if args.timeline_merge and not updates.get("HOROVOD_TIMELINE") \
                and not os.environ.get("HOROVOD_TIMELINE"):
            # --timeline-merge without --timeline-filename: per-rank local
            # files beside the merged output (two local slots writing one
            # shared path would race)
            updates["HOROVOD_TIMELINE"] = \
                f"{args.timeline_merge}.rank.{slot.rank}.json"
        if postmortem_dir:
            # heartbeats feed /health and the supervision; the per-rank
            # flight record path arms the native recorder at init
            updates.setdefault("HOROVOD_HEARTBEAT", "1")
            updates["HOROVOD_FLIGHT_RECORD"] = os.path.join(
                postmortem_dir, f"flight.rank.{slot.rank}")
        if np_ > 1:
            updates["HOROVOD_COORDINATOR_ADDR"] = \
                f"{coord_host}:{args.coordinator_port}"
        env = dict(os.environ)
        env.update(updates)
        cmd = build_worker_command(slot, command, updates,
                                   args.ssh_port, args.ssh_identity_file)
        if args.verbose:
            print(f"{PROG}: rank {slot.rank} on {slot.hostname}: "
                  f"{' '.join(cmd)}", file=sys.stderr)
        return spawn_with_output(
            cmd, env, args.output_filename, slot.rank,
            prefix_timestamp=args.prefix_output_with_timestamp)

    procs: Dict[int, subprocess.Popen] = {}
    exits: Dict[int, dict] = {}
    exit_code = 0

    def reap(rank: int, proc: subprocess.Popen,
             cause: Optional[str] = None,
             by_launcher: bool = False) -> None:
        """Record one worker exit (its row of the postmortem, its cause
        in hvd_worker_exits_total); the first failure a worker made
        itself, or a supervision verdict, sets the job's code."""
        nonlocal exit_code
        rc = proc.wait()
        join_output_pumps(proc)
        exits[rank] = {"rc": rc, "time": time.time(), "cause": cause,
                       "by_launcher": by_launcher}
        from ..postmortem import classify_exit
        from ..utils import metrics as M
        M.WORKER_EXITS.inc(cause=classify_exit(rc, by_launcher, cause))
        if (rc != 0 or cause) and not by_launcher and exit_code == 0:
            exit_code = rc if rc != 0 else 1

    # live straggler check: needs the metrics plane's per-rank snapshots
    # and an explicit period (HOROVOD_STRAGGLER_CHECK_SECS > 0)
    monitor = None
    check_secs = float(os.environ.get("HOROVOD_STRAGGLER_CHECK_SECS",
                                      "0") or 0)
    if metrics_enabled and check_secs > 0:
        from ..utils.metrics import StragglerMonitor
        monitor = StragglerMonitor(
            lambda: harvest_metric_snapshots(rendezvous),
            interval=check_secs,
            log_fn=lambda msg: print(msg, file=sys.stderr, flush=True))
        monitor.start()

    # supervision: heartbeat-lost and progress-stall verdicts from the
    # fleet's health scope
    health_mon = None
    if postmortem_dir:
        from ..utils.health import HealthMonitor, fleet_health
        hb_timeout = float(os.environ.get("HOROVOD_HEARTBEAT_TIMEOUT",
                                          "10") or 10)
        health_mon = HealthMonitor(
            lambda: fleet_health(
                rendezvous.scope_items("health"),
                rendezvous.scope_receipt_times("health"),
                stale_after=hb_timeout),
            timeout=hb_timeout)

    main_thread = threading.current_thread() is threading.main_thread()
    old_term = signal.signal(signal.SIGTERM, _raise_terminated) \
        if main_thread else None
    try:
        for slot in slots:
            procs[slot.rank] = spawn(slot)
        while len(exits) < len(procs):
            progressed = False
            for rank, p in procs.items():
                if rank not in exits and p.poll() is not None:
                    reap(rank, p)
                    progressed = True
            live = [r for r in procs if r not in exits]
            if exit_code != 0 and live:
                # fail fast: end the rest (reference: gloo_run terminates
                # remaining workers on first failure), SIGKILL after a
                # bounded grace — a survivor blocked in a collective
                # otherwise holds the job until its backend times out
                for r in live:
                    if procs[r].poll() is None:
                        procs[r].terminate()
                deadline = time.time() + 10
                for r in live:
                    p = procs[r]
                    try:
                        p.wait(timeout=max(0.1, deadline - time.time()))
                    except subprocess.TimeoutExpired:
                        p.kill()
                    reap(r, p, by_launcher=True)
                break
            if health_mon is not None and live:
                for r, cause in health_mon.verdicts(live).items():
                    p = procs[r]
                    if p.poll() is None:
                        # SIGABRT, not SIGTERM: the abort trips the armed
                        # flight recorder, so the kill that confirms the
                        # stall also takes the rank's black box
                        print(f"{PROG}: rank {r}: {cause} beyond "
                              f"{health_mon.timeout:.0f}s; aborting for "
                              "forensics", file=sys.stderr, flush=True)
                        p.send_signal(signal.SIGABRT)
                        try:
                            p.wait(timeout=10)
                        except subprocess.TimeoutExpired:
                            p.kill()
                    reap(r, p, cause=cause)
                    progressed = True
            if not progressed:
                time.sleep(0.2)
        return exit_code
    except (KeyboardInterrupt, _Terminated) as e:
        sig = signal.SIGINT if isinstance(e, KeyboardInterrupt) \
            else signal.SIGTERM
        for p in procs.values():
            if p.poll() is None:
                p.send_signal(sig)
        deadline = time.time() + 10
        for p in procs.values():
            try:
                p.wait(timeout=max(0.1, deadline - time.time()))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        return 130 if sig == signal.SIGINT else 128 + signal.SIGTERM
    finally:
        if main_thread:
            signal.signal(signal.SIGTERM, old_term)
        if monitor is not None:
            monitor.stop()
        if metrics_enabled:
            report_stragglers(rendezvous)
        if args.timeline_merge:
            write_merged_timeline(rendezvous, args.timeline_merge)
        if postmortem_dir and exits and exit_code != 0:
            try:
                write_job_postmortem(rendezvous, postmortem_dir, exits,
                                     command, np_,
                                     output_filename=args.output_filename)
            except Exception as e:  # forensics must never mask the rc
                print(f"{PROG}: postmortem collection failed: {e}",
                      file=sys.stderr, flush=True)
        rendezvous.stop()


def run_commandline(argv: Optional[List[str]] = None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    if argv and argv[0] == "doctor":
        # the read side of the postmortem, perf and watch planes and the
        # serving views: no launch, no rendezvous, just the rendering
        from .doctor import main as doctor_main
        return doctor_main(argv[1:])
    args = make_parser().parse_args(argv)
    if args.version:
        from .. import __version__
        print(__version__)
        return 0
    if args.check_build:
        print(check_build())
        return 0
    refusal = refused_flag(args)
    if refusal:
        print(refusal, file=sys.stderr)
        return 2
    command = args.command
    if command and command[0] == "--":
        command = command[1:]
    if args.serve:
        if command:
            print(f"{PROG}: --serve supplies the worker command; drop the "
                  f"trailing command ({' '.join(command)})",
                  file=sys.stderr)
            return 2
        if args.replica_id is not None and args.replicas is None:
            print(f"{PROG}: --replica-id needs --replicas",
                  file=sys.stderr)
            return 2
        if args.replicas is not None and \
                not 0 <= (args.replica_id or 0) < args.replicas:
            print(f"{PROG}: --replica-id {args.replica_id} out of range "
                  f"for --replicas {args.replicas}", file=sys.stderr)
            return 2
        command = serve_worker_command(args)
    elif args.serve_device:
        print(f"{PROG}: --serve-device needs --serve", file=sys.stderr)
        return 2
    if not command:
        print(f"{PROG}: no training command given", file=sys.stderr)
        return 2
    if args.mpi or args.gloo or args.jsrun or args.mpi_args:
        which = ("--mpi" if args.mpi or args.mpi_args else
                 "--gloo" if args.gloo else "--jsrun")
        print(f"{PROG}: {which} requested, but the port's transport is "
              "torch.distributed's (NCCL on CUDA, gloo on the CPU) with the "
              "native TCP controller (see --check-build); drop the flag — "
              "--tcp is the default and only transport", file=sys.stderr)
        return 2
    elastic = args.host_discovery_script or args.min_np or args.max_np
    if args.num_proc is None and not (args.hosts or args.hostfile
                                      or args.gpu or elastic):
        # --gpu discovers the slots, so np defaults to their total in
        # launch_static exactly like an explicit -H
        print(f"{PROG}: -np required when no hosts are given",
              file=sys.stderr)
        return 2
    try:
        if elastic:
            from ..elastic.driver import run_elastic
            return run_elastic(args, command)
        return launch_static(args, command)
    except ValueError as e:
        print(f"{PROG}: {e}", file=sys.stderr)
        return 2
    except (TimeoutError, RuntimeError) as e:
        if not elastic:
            raise
        print(f"{PROG}: elastic: {e}", file=sys.stderr)
        return 1


def main() -> None:  # console entry point
    sys.exit(run_commandline())


if __name__ == "__main__":
    main()
