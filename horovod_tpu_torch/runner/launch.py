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

The JAX launcher also drives planes the port does not have yet.  Their
flags are refused with exit code 2 and the ROADMAP item that brings them
(:data:`REFUSED`), so no flag is ever silently ignored; the few flags that
have no meaning on a PyTorch stack (:data:`NO_EFFECT`) are accepted with a
warning, as the JAX launcher accepts its CPU-affinity flags.  ``--mpi``,
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

# dest -> (flag, what it needs, the ROADMAP queue 1 item that brings it)
REFUSED: Dict[str, tuple] = {
    "serve": ("--serve", "the serving fleet", "3.4"),
    "serve_port": ("--serve-port", "the serving fleet", "3.4"),
    "serve_ttl": ("--serve-ttl", "the serving fleet", "3.4"),
    "replicas": ("--replicas", "the serving fleet", "3.4"),
    "replica_id": ("--replica-id", "the serving fleet", "3.4"),
    "metrics_port": ("--metrics-port", "the metrics registry", "4.1"),
    "timeline_filename": ("--timeline-filename", "the timeline", "4.1"),
    "timeline_merge": ("--timeline-merge", "the timeline", "4.1"),
    "timeline_mark_cycles": ("--timeline-mark-cycles", "the timeline",
                             "4.1"),
    "autotune": ("--autotune", "autotuning", "4.1"),
    "autotune_log_file": ("--autotune-log-file", "autotuning", "4.1"),
    "autotune_warmup_samples": ("--autotune-warmup-samples", "autotuning",
                                "4.1"),
    "autotune_steps_per_sample": ("--autotune-steps-per-sample",
                                  "autotuning", "4.1"),
    "autotune_bayes_opt_max_samples": ("--autotune-bayes-opt-max-samples",
                                       "autotuning", "4.1"),
    "autotune_gaussian_process_noise": (
        "--autotune-gaussian-process-noise", "autotuning", "4.1"),
    "no_stall_check": ("--no-stall-check / --stall-check",
                       "the stall inspector", "4.1"),
    "stall_shutdown_time_seconds": ("--stall-shutdown-time-seconds",
                                    "the stall inspector", "4.1"),
    "log_level": ("--log-level", "the port's logging", "4.1"),
    "log_hide_timestamp": ("--log-hide-timestamp", "the port's logging",
                           "4.1"),
    "postmortem": ("--postmortem", "the postmortem plane", "4.3"),
    "alerts": ("--alerts", "the watch plane", "4.3"),
    "min_np": ("--min-np", "elastic training", "4.4"),
    "max_np": ("--max-np", "elastic training", "4.4"),
    "host_discovery_script": ("--host-discovery-script",
                              "elastic training", "4.4"),
    "elastic_timeout": ("--elastic-timeout", "elastic training", "4.4"),
    "reset_limit": ("--reset-limit", "elastic training", "4.4"),
    "chaos": ("--chaos", "the chaos plane", "4.5"),
    "scenario": ("--scenario", "the scenario plane", "4.5"),
}
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
    # the planes still to come (REFUSED): parsed so that they are refused
    # by name, never taken for part of the training command
    p.add_argument("--metrics-port", type=int, default=None,
                   help=argparse.SUPPRESS)
    p.add_argument("--timeline-filename", default=None,
                   help=argparse.SUPPRESS)
    p.add_argument("--timeline-merge", default=None, help=argparse.SUPPRESS)
    tl_mc = p.add_mutually_exclusive_group()
    tl_mc.add_argument("--timeline-mark-cycles", action="store_true",
                       default=None, help=argparse.SUPPRESS)
    tl_mc.add_argument("--no-timeline-mark-cycles",
                       dest="timeline_mark_cycles", action="store_false",
                       help=argparse.SUPPRESS)
    stall = p.add_mutually_exclusive_group()
    stall.add_argument("--stall-check", dest="no_stall_check",
                       action="store_false", default=None,
                       help=argparse.SUPPRESS)
    stall.add_argument("--no-stall-check", action="store_true",
                       help=argparse.SUPPRESS)
    p.add_argument("--stall-check-time-seconds",
                   "--stall-check-warning-time-seconds",
                   dest="stall_check_time_seconds", type=int, default=None,
                   help="warn when ranks disagree about a tensor for this "
                        "long (HOROVOD_STALL_CHECK_TIME_SECONDS)")
    p.add_argument("--stall-shutdown-time-seconds",
                   "--stall-check-shutdown-time-seconds",
                   dest="stall_shutdown_time_seconds", type=int,
                   default=None, help=argparse.SUPPRESS)
    p.add_argument("--log-level", default=None,
                   choices=["trace", "debug", "info", "warning", "error",
                            "fatal"], help=argparse.SUPPRESS)
    log_ts = p.add_mutually_exclusive_group()
    log_ts.add_argument("--log-hide-timestamp", "--log-without-timestamp",
                        dest="log_hide_timestamp", action="store_true",
                        default=None, help=argparse.SUPPRESS)
    log_ts.add_argument("--no-log-hide-timestamp", "--log-with-timestamp",
                        dest="log_hide_timestamp", action="store_false",
                        help=argparse.SUPPRESS)
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
                   help=argparse.SUPPRESS)
    p.add_argument("--autotune-log-file", default=None,
                   help=argparse.SUPPRESS)
    p.add_argument("--autotune-warmup-samples", type=int, default=None,
                   help=argparse.SUPPRESS)
    p.add_argument("--autotune-steps-per-sample", type=int, default=None,
                   help=argparse.SUPPRESS)
    p.add_argument("--autotune-bayes-opt-max-samples", type=int,
                   default=None, help=argparse.SUPPRESS)
    p.add_argument("--autotune-gaussian-process-noise", type=float,
                   default=None, help=argparse.SUPPRESS)
    p.add_argument("--config-file", default=None,
                   help="YAML config (reference schema: params and "
                        "stall_check sections)")
    p.add_argument("--postmortem", default=None, help=argparse.SUPPRESS)
    p.add_argument("--serve", default=None, help=argparse.SUPPRESS)
    p.add_argument("--serve-port", type=int, default=None,
                   help=argparse.SUPPRESS)
    p.add_argument("--serve-ttl", type=float, default=None,
                   help=argparse.SUPPRESS)
    p.add_argument("--replicas", type=int, default=None,
                   help=argparse.SUPPRESS)
    p.add_argument("--replica-id", type=int, default=None,
                   help=argparse.SUPPRESS)
    p.add_argument("--alerts", default=None, help=argparse.SUPPRESS)
    p.add_argument("--chaos", default=None, help=argparse.SUPPRESS)
    p.add_argument("--scenario", default=None, help=argparse.SUPPRESS)
    p.add_argument("--min-np", type=int, default=None,
                   help=argparse.SUPPRESS)
    p.add_argument("--max-np", type=int, default=None,
                   help=argparse.SUPPRESS)
    p.add_argument("--host-discovery-script", default=None,
                   help=argparse.SUPPRESS)
    p.add_argument("--slots", "--slots-per-host", dest="slots", type=int,
                   default=None,
                   help="with --gpu: slots on this host (at most its "
                        "visible cards)")
    p.add_argument("--elastic-timeout", type=int, default=None,
                   help=argparse.SUPPRESS)
    p.add_argument("--reset-limit", type=int, default=None,
                   help=argparse.SUPPRESS)
    # --- ports ---
    p.add_argument("--coordinator-port", type=int, default=29500)
    p.add_argument("--controller-port", type=int, default=29499)
    p.add_argument("command", nargs=argparse.REMAINDER,
                   help="training command")
    return p


def _refusal(flag: str, what: str, item: str) -> str:
    return (f"{PROG}: {flag} needs {what}, which the PyTorch port does not "
            f"have yet (ROADMAP queue 1 item {item})")


def refused_flag(args: argparse.Namespace) -> Optional[str]:
    """The refusal message of the first flag given whose plane the port
    does not have yet (:data:`REFUSED`), else None."""
    for dest, (flag, what, item) in REFUSED.items():
        val = getattr(args, dest, None)
        if val is not None and val is not False:
            return _refusal(flag, what, item)
    if getattr(args, "mesh", None):
        return (f"{PROG}: --mesh names the JAX package's device mesh; the "
                "port lays out its ranks with HOROVOD_LAYOUT "
                "(parallel/layout.py)")
    if getattr(args, "tpu", False):
        return (f"{PROG}: --tpu discovers a TPU slice; the port runs one "
                "process per CUDA device: use --gpu")
    return None


def config_file_to_env(path: str, env: Dict[str, str]) -> None:
    """YAML config -> env knobs (reference: config_parser.py:202 schema).
    The ``params`` and ``stall_check`` keys the port reads map as in the
    JAX launcher; a key of a plane still to come raises ValueError naming
    its ROADMAP item."""
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
    if tl.get("filename") or tl.get("mark_cycles"):
        raise ValueError(f"{path}: " + _refusal("timeline", "the timeline",
                                                "4.1"))
    sc = cfg.get("stall_check", {})
    if sc.get("disable") or sc.get("shutdown_time_seconds") is not None:
        raise ValueError(f"{path}: " + _refusal(
            "stall_check.disable / shutdown_time_seconds",
            "the stall inspector", "4.1"))
    if sc.get("warning_time_seconds") is not None:
        env["HOROVOD_STALL_CHECK_TIME_SECONDS"] = \
            str(sc["warning_time_seconds"])
    at = cfg.get("autotune", {})
    if at.get("enabled") or at.get("log_file"):
        raise ValueError(f"{path}: " + _refusal("autotune", "autotuning",
                                                "4.1"))


def args_to_env(args: argparse.Namespace) -> Dict[str, str]:
    """CLI flags win over config file, which wins over ambient env
    (reference: launch.py + config_parser layering).  Covers the knobs of
    the planes the port has; the others are refused before this runs
    (:func:`refused_flag`)."""
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
    if args.gloo_timeout_seconds is not None:
        env["HOROVOD_GLOO_TIMEOUT_SECONDS"] = \
            str(args.gloo_timeout_seconds)
    if args.stall_check_time_seconds is not None:
        env["HOROVOD_STALL_CHECK_TIME_SECONDS"] = \
            str(args.stall_check_time_seconds)
    for dest, flag in NO_EFFECT.items():
        if getattr(args, dest, None) is not None:
            print(f"{PROG}: {flag} has no effect on the PyTorch port "
                  "(CPU-affinity, MPI-thread and stream-count knobs); "
                  "accepted for launch-script compatibility only",
                  file=sys.stderr)
    return env


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
    if rendezvous is None:
        rendezvous = RendezvousServer(shards=kv_shards)
        rendezvous.start()
    rdv_port = rendezvous.port
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
        updates["HOROVOD_RENDEZVOUS_ADDR"] = coord_host
        updates["HOROVOD_RENDEZVOUS_PORT"] = str(rdv_port)
        updates["HOROVOD_CONTROLLER_PORT"] = str(args.controller_port)
        stamp_kv_shard_env(updates, coord_host, rendezvous, kv_shards)
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
             by_launcher: bool = False) -> None:
        """Record one worker exit; the first nonzero one a worker made
        itself sets the job's code.  (The JAX launcher also counts the
        exit into its metrics by cause: ROADMAP queue 1 items 4.1, 4.3.)"""
        nonlocal exit_code
        rc = proc.wait()
        join_output_pumps(proc)
        exits[rank] = {"rc": rc, "time": time.time(),
                       "by_launcher": by_launcher}
        if rc != 0 and not by_launcher and exit_code == 0:
            exit_code = rc

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
        rendezvous.stop()


def run_commandline(argv: Optional[List[str]] = None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    if argv and argv[0] == "doctor":
        print(_refusal("doctor", "the perf and postmortem reports", "4.2"),
              file=sys.stderr)
        return 2
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
    if args.num_proc is None and not (args.hosts or args.hostfile
                                      or args.gpu):
        # --gpu discovers the slots, so np defaults to their total in
        # launch_static exactly like an explicit -H
        print(f"{PROG}: -np required when no hosts are given",
              file=sys.stderr)
        return 2
    try:
        return launch_static(args, command)
    except ValueError as e:
        print(f"{PROG}: {e}", file=sys.stderr)
        return 2


def main() -> None:  # console entry point
    sys.exit(run_commandline())


if __name__ == "__main__":
    main()
