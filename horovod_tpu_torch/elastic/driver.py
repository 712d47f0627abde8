"""Elastic driver: discovery polling, rank-preserving reassignment, worker
lifecycle, reset rounds; the port of ``horovod_tpu/elastic/driver.py``.

Reference: horovod/runner/elastic/driver.py:68-314: a poll thread watches
the discovery script (driver.py:181-202); on a membership change or a
worker failure the driver recomputes slot assignments *preserving
existing ranks* (driver.py:233-276), blacklists hosts whose workers failed
(registration.py:51-130) and restarts the workers; it stops when min_np
cannot be met or the reset limit is hit.

As in the JAX package, every reset round restarts *all* worker processes
with fresh ``HOROVOD_SIZE``/``RANK`` env: a lost rank leaves NCCL peers
blocked, so the process group is rebuilt from new processes.  State
survives through ``TreeState`` durable commits plus rank 0's broadcast on
sync.

Three rules of the port:

- **Loopback aliases share the machine's cards.**  Two aliases of this
  machine (``localhost``, ``127.0.0.1``, ...) listed as two hosts give
  each alias local ranks from 0, and every worker takes ``cuda:<local
  rank>`` (``runtime.py``), so a round that takes slots from two aliases
  would put two ranks on one card, which NCCL cannot do.  A round that
  uses one alias (as after a blacklisting reset) is fine; on a machine
  that shows cards (``runner/gpu_discovery.py``), a round that mixes
  aliases raises ``ValueError`` saying so.  The driver assigns no cards
  of its own.
- **A blacklisting is no membership change.**  The driver drops a
  failed host from the hosts its discovery poll compares against, under
  the poll's lock; in the JAX driver the next poll reads the blacklisting
  as a change and can reset the round that replaced the failed one.
- **Ports across rounds.**  Every round reuses ``coordinator_port`` and
  ``controller_port``, as the JAX driver does.  The driver reaps every
  process of a round (SIGKILL after a 10 s grace) before the next round
  spawns, and then checks that both ports bind on this machine; if one is
  still held after a few seconds the driver fails at once, naming it,
  instead of letting the new round hang at its rendezvous.
"""

from __future__ import annotations

import errno
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional

from ..common import hvdlogging as log
from ..common.knobs import Knobs
from ..runner import hosts as hosts_mod
from ..runner.http_server import RendezvousServer
from ..utils import metrics as _metrics
from .discovery import HostDiscovery, HostDiscoveryScript, HostManager
from .worker import HOST_UPDATE_SCOPE, HOST_UPDATE_KEY

PORT_PATIENCE_S = 5.0  # how long a reused port may stay held after a reap
PROG = "python -m horovod_tpu_torch.runner.launch"


class WorkerStateRegistry:
    """Counts worker outcomes per reset round (reference:
    registration.py:28-130)."""

    SUCCESS, FAILURE = "success", "failure"

    def __init__(self):
        self._results: Dict[int, str] = {}
        self._lock = threading.Lock()

    def record(self, rank: int, outcome: str) -> None:
        with self._lock:
            self._results[rank] = outcome

    def failures(self) -> List[int]:
        with self._lock:
            return [r for r, o in self._results.items()
                    if o == self.FAILURE]

    def successes(self) -> List[int]:
        with self._lock:
            return [r for r, o in self._results.items()
                    if o == self.SUCCESS]

    def reset(self) -> None:
        with self._lock:
            self._results.clear()


def port_bindable(port: int) -> bool:
    """Whether ``port`` binds on this machine now (SO_REUSEADDR, as the
    torch.distributed store and the native controller bind: a socket in
    TIME_WAIT does not hold it, a live listener does)."""
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    try:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(("", port))
        return True
    except OSError as e:
        if e.errno in (errno.EADDRINUSE, errno.EACCES):
            return False
        raise
    finally:
        s.close()


class ElasticDriver:
    def __init__(self, discovery: HostDiscovery, min_np: int, max_np: int,
                 command: List[str],
                 env: Optional[Dict[str, str]] = None,
                 elastic_timeout: float = 600.0,
                 reset_limit: int = 0,
                 coordinator_port: int = 29500,
                 controller_port: int = 29499,
                 discovery_interval: float = 1.0,
                 output_filename: Optional[str] = None,
                 network_interface: Optional[str] = None,
                 prefix_output_with_timestamp: bool = False,
                 metrics_port: Optional[int] = None,
                 kv_shards: int = 1):
        self.host_manager = HostManager(discovery)
        self.min_np = min_np
        self.max_np = max_np
        self.command = command
        self.extra_env = env or {}
        self.elastic_timeout = elastic_timeout
        self.reset_limit = reset_limit
        self.coordinator_port = coordinator_port
        self.controller_port = controller_port
        self.discovery_interval = discovery_interval
        self.output_filename = output_filename
        self.network_interface = network_interface
        self.prefix_output_with_timestamp = prefix_output_with_timestamp
        self._spawned_ranks: set = set()
        self._round = 0  # reset-round number, exported to workers

        self.registry = WorkerStateRegistry()
        # the KV shard servers live in THIS driver process like the
        # primary, so they survive reset rounds with the journal and the
        # in-flight client streams
        self.kv_shards = max(1, int(kv_shards))
        self.rendezvous = RendezvousServer(port=metrics_port or 0,
                                           shards=self.kv_shards)
        self.rdv_port = self.rendezvous.start()
        self._host_update_counter = 0
        self._current_hosts: List[hosts_mod.HostInfo] = []
        # held around each discovery poll's compare-and-set and around a
        # blacklisting, so the poll never reads the driver's own
        # blacklisting as a membership change
        self._hosts_lock = threading.Lock()
        self._prev_assignment: Dict[str, List[int]] = {}
        self._procs: Dict[int, subprocess.Popen] = {}
        self._stop = threading.Event()
        self._hosts_changed = threading.Event()
        self._discovery_thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------- discovery
    def start_discovery(self) -> None:
        """Poll thread (reference: driver.py:181-202, 1 s interval)."""
        def loop():
            while not self._stop.wait(self.discovery_interval):
                with self._hosts_lock:
                    try:
                        cur, changed = \
                            self.host_manager.update_available_hosts(
                                self._current_hosts)
                    except Exception as e:
                        log.warning("elastic discovery failed: %s", e)
                        continue
                    if not changed:
                        continue
                    prev = {h.hostname for h in self._current_hosts}
                    now = {h.hostname for h in cur}
                    if now - prev:
                        _metrics.ELASTIC_HOSTS_ADDED.inc(len(now - prev))
                    if prev - now:
                        _metrics.ELASTIC_HOSTS_REMOVED.inc(len(prev - now))
                    self._current_hosts = cur
                    self._hosts_changed.set()
                    self._notify_host_update()
        self._discovery_thread = threading.Thread(target=loop, daemon=True)
        self._discovery_thread.start()

    def _notify_host_update(self) -> None:
        self._host_update_counter += 1
        self.rendezvous.put(HOST_UPDATE_SCOPE, HOST_UPDATE_KEY,
                            str(self._host_update_counter).encode())

    def wait_for_available_slots(self, min_np: int
                                 ) -> List[hosts_mod.HostInfo]:
        """Block until enough slots exist (reference: driver.py:145-180)."""
        deadline = time.time() + self.elastic_timeout
        while time.time() < deadline:
            with self._hosts_lock:
                hosts = self.host_manager.current_hosts()
                if sum(h.slots for h in hosts) >= min_np:
                    self._current_hosts = hosts
                    return hosts
            time.sleep(0.5)
        raise TimeoutError(
            f"timed out waiting for {min_np} slots "
            f"(HOROVOD_ELASTIC_TIMEOUT={self.elastic_timeout:.0f}s)")

    # ----------------------------------------------------------- assignment
    def compute_assignments(
            self, hosts: List[hosts_mod.HostInfo]) -> List[hosts_mod.SlotInfo]:
        """Rank-preserving assignment (reference: driver.py:233-276): hosts
        that already held ranks keep their previous *order* so rank 0 (the
        broadcast root) stays on a surviving host when possible."""
        order: Dict[str, int] = {}
        for h, ranks in self._prev_assignment.items():
            if ranks:
                order[h] = min(ranks)
        hosts_sorted = sorted(
            hosts, key=lambda h: (order.get(h.hostname, 1 << 30),
                                  h.hostname))
        np_ = min(self.max_np, sum(h.slots for h in hosts_sorted))
        slots = hosts_mod.get_host_assignments(hosts_sorted, np_)
        self._prev_assignment = {}
        for s in slots:
            self._prev_assignment.setdefault(s.hostname, []).append(s.rank)
        return slots

    def check_card_aliases(self, slots: List[hosts_mod.SlotInfo]) -> None:
        """Raise when a round takes slots from two loopback aliases of a
        machine that shows cards (see the module docstring)."""
        from ..runner.gpu_discovery import visible_gpu_count
        from ..runner.launch import _is_local
        aliases = sorted({s.hostname for s in slots if _is_local(s.hostname)})
        if len(aliases) > 1 and visible_gpu_count() > 0:
            raise ValueError(
                f"elastic round mixes {', '.join(aliases)}: these are one "
                "machine, and each alias's ranks start at local rank 0, so "
                "two ranks would take the same card (cuda:<local rank>), "
                "which NCCL cannot do; list this machine once in the host "
                "discovery output, or hide its cards "
                "(CUDA_VISIBLE_DEVICES=) for a CPU job")

    def check_ports(self) -> None:
        """Fail at once, naming the port, when a port this round reuses is
        still held on this machine after ``PORT_PATIENCE_S``."""
        deadline = time.monotonic() + PORT_PATIENCE_S
        for name, port in (("coordinator", self.coordinator_port),
                           ("controller", self.controller_port)):
            while not port_bindable(port):
                if time.monotonic() > deadline:
                    raise RuntimeError(
                        f"elastic round {self._round}: the {name} port "
                        f"{port} is still held on this machine after "
                        "every worker of the last round was reaped; a "
                        "leftover process or another job holds it "
                        f"(--{name}-port picks another)")
                time.sleep(0.1)

    # -------------------------------------------------------------- workers
    def _spawn_worker(self, slot: hosts_mod.SlotInfo,
                      coord_host: str) -> subprocess.Popen:
        from ..runner.launch import (build_worker_command, spawn_with_output,
                                     stamp_kv_shard_env)
        updates = dict(self.extra_env)
        updates.update(slot.to_env())
        updates["HOROVOD_RENDEZVOUS_ADDR"] = coord_host
        updates["HOROVOD_RENDEZVOUS_PORT"] = str(self.rdv_port)
        updates["HOROVOD_CONTROLLER_PORT"] = str(self.controller_port)
        # the reset-round stamp: the serving plane fences its plan-stream
        # epoch on it, so a restarted fleet never replays stale serve_plan
        # keys (serve/worker.py)
        updates["HOROVOD_ELASTIC_ROUND"] = str(self._round)
        stamp_kv_shard_env(updates, coord_host, self.rendezvous,
                           self.kv_shards)
        if slot.size > 1:
            updates["HOROVOD_COORDINATOR_ADDR"] = \
                f"{coord_host}:{self.coordinator_port}"
        env = dict(os.environ)
        env.update(updates)
        cmd = build_worker_command(slot, self.command, updates,
                                   ssh_port=None, ssh_identity=None)
        # truncate on a rank's FIRST spawn of this driver run (a stale log
        # of an earlier run must not leak in); append on reset rounds, so
        # a restarted rank's log continues
        mode = "ab" if slot.rank in self._spawned_ranks else "wb"
        self._spawned_ranks.add(slot.rank)
        return spawn_with_output(
            cmd, env, self.output_filename, slot.rank, mode=mode,
            prefix_timestamp=self.prefix_output_with_timestamp)

    def _terminate_all(self) -> None:
        """End and reap every process of the round: SIGTERM, SIGKILL after
        10 s, then wait, so none of them holds a port into the next
        round."""
        from ..runner.launch import join_output_pumps
        for p in self._procs.values():
            if p.poll() is None:
                p.terminate()
        deadline = time.time() + 10
        for p in self._procs.values():
            try:
                p.wait(timeout=max(0.1, deadline - time.time()))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
            # survivors of a reset round die at the driver's hand:
            # taxonomy "terminated", never a failure attribution
            _metrics.WORKER_EXITS.inc(cause="terminated")
            join_output_pumps(p, timeout=2.0)
        self._procs.clear()

    # --------------------------------------------------------- supervision
    def _health_monitor(self):
        """Per-round health supervision (a wedged rank gets SIGABRT, then
        an elastic restart instead of job death).  Armed only when the
        heartbeat plane is on (``launch --serve`` implies it); a fresh
        monitor per round, since the scope is cleared at every reset."""
        enabled = (self.extra_env.get("HOROVOD_HEARTBEAT")
                   or os.environ.get("HOROVOD_HEARTBEAT", ""))
        if enabled in ("", "0", "false"):
            return None
        from ..utils.health import HealthMonitor, fleet_health
        timeout = float(self.extra_env.get("HOROVOD_HEARTBEAT_TIMEOUT")
                        or os.environ.get("HOROVOD_HEARTBEAT_TIMEOUT")
                        or 10)
        return HealthMonitor(
            lambda: fleet_health(
                self.rendezvous.scope_items("health"),
                self.rendezvous.scope_receipt_times("health"),
                stale_after=timeout),
            timeout=timeout)

    # ------------------------------------------------------------------ run
    def run(self) -> int:
        """Reset-round loop (reference: driver.py run/reset +
        launch.py:621-670 semantics)."""
        from ..postmortem import classify_exit
        from ..runner.launch import (_is_local, join_output_pumps,
                                     resolve_coord_host)
        self.start_discovery()
        resets = 0
        try:
            while True:
                hosts = self.wait_for_available_slots(self.min_np)
                slots = self.compute_assignments(hosts)
                self._round = resets
                self.check_card_aliases(slots)
                coord_host = resolve_coord_host(
                    slots[0].hostname, self.network_interface,
                    warn=log.warning,
                    has_remote_workers=any(
                        not _is_local(s.hostname) for s in slots))
                if _is_local(slots[0].hostname):
                    self.check_ports()
                if self.kv_shards > 1:
                    # idempotent per round; coord_host is known only once
                    # the round's slots are
                    self.rendezvous.publish_shard_map(coord_host)
                self._hosts_changed.clear()
                self.registry.reset()
                # round-scoped heartbeats: a dead incarnation's stale
                # entries would read as instant heartbeat loss
                self.rendezvous.clear_scope("health")
                health_mon = self._health_monitor()
                print(f"{PROG}: elastic round {resets}: {len(slots)} "
                      f"workers on {','.join(h.hostname for h in hosts)}",
                      file=sys.stderr, flush=True)
                round_start = time.monotonic()
                self._procs = {s.rank: self._spawn_worker(s, coord_host)
                               for s in slots}

                round_failed = False
                while self._procs:
                    if health_mon is not None:
                        # wedged-rank remediation: SIGABRT trips the armed
                        # flight recorder, the nonzero exit classifies as
                        # a failure, and the reset round restarts the fleet
                        for r, cause in health_mon.verdicts(
                                list(self._procs)).items():
                            p = self._procs.get(r)
                            if p is not None and p.poll() is None:
                                log.warning(
                                    "elastic: rank %d %s beyond %.0fs; "
                                    "SIGABRT for forensics, then reset",
                                    r, cause, health_mon.timeout)
                                p.send_signal(signal.SIGABRT)
                    done = [(r, p) for r, p in self._procs.items()
                            if p.poll() is not None]
                    for r, p in done:
                        del self._procs[r]
                        join_output_pumps(p, timeout=5.0)
                        outcome = (WorkerStateRegistry.SUCCESS
                                   if p.returncode == 0
                                   else WorkerStateRegistry.FAILURE)
                        self.registry.record(r, outcome)
                        _metrics.WORKER_EXITS.inc(
                            cause=classify_exit(p.returncode))
                        if outcome == WorkerStateRegistry.FAILURE:
                            _metrics.ELASTIC_FAILURES.inc()
                            host = next((s.hostname for s in slots
                                         if s.rank == r), None)
                            if host:
                                with self._hosts_lock:
                                    self.host_manager.blacklist(host)
                                    self._current_hosts = [
                                        h for h in self._current_hosts
                                        if h.hostname != host]
                                print(f"{PROG}: elastic: rank {r} on {host} "
                                      f"failed (rc={p.returncode}); host "
                                      "blacklisted", file=sys.stderr,
                                      flush=True)
                            round_failed = True
                    if round_failed or self._hosts_changed.is_set():
                        break
                    time.sleep(0.2)

                _metrics.ELASTIC_ROUND_DURATION.observe(
                    time.monotonic() - round_start)
                if not self._procs and not round_failed and \
                        not self._hosts_changed.is_set():
                    return 0  # clean finish
                # reset round: stop everything, re-rendezvous
                self._terminate_all()
                resets += 1
                _metrics.ELASTIC_RESETS.inc()
                if self.reset_limit and resets > self.reset_limit:
                    print(f"{PROG}: elastic: reset limit "
                          f"{self.reset_limit} exceeded", file=sys.stderr,
                          flush=True)
                    return 1
        finally:
            self._stop.set()
            self._terminate_all()
            enabled = (self.extra_env.get("HOROVOD_METRICS")
                       or os.environ.get("HOROVOD_METRICS", ""))
            if enabled not in ("", "0", "false"):
                from ..runner.launch import report_stragglers
                report_stragglers(self.rendezvous)
            self.rendezvous.stop()


def run_elastic(args, command: List[str]) -> int:
    """The launcher's entry for elastic flags (reference: _run_elastic
    launch.py:621-670)."""
    knobs = Knobs()
    if not args.host_discovery_script:
        raise ValueError("elastic mode requires --host-discovery-script "
                         "(reference: launch.py elastic validation)")
    discovery = HostDiscoveryScript(args.host_discovery_script,
                                    default_slots=getattr(args, "slots",
                                                          None) or 1)
    min_np = args.min_np or args.num_proc or 1
    max_np = args.max_np or args.num_proc or (1 << 30)
    from ..runner.launch import (args_to_env, install_alert_rules,
                                 publish_chaos_spec, publish_scenario_spec,
                                 resolve_kv_shards, resolve_serve_port)
    # --serve pins the rendezvous (= router) port as the static path does;
    # the driver's server survives reset rounds, so the journal, the
    # in-flight client streams and /generate ride across fleet restarts
    pinned_port = (getattr(args, "metrics_port", None)
                   or resolve_serve_port(args) or None)
    driver = ElasticDriver(
        discovery, min_np, max_np, command, env=args_to_env(args),
        elastic_timeout=args.elastic_timeout or
        knobs["HOROVOD_ELASTIC_TIMEOUT"],
        reset_limit=args.reset_limit
        if args.reset_limit is not None
        else knobs["HOROVOD_ELASTIC_RESET_LIMIT"],
        coordinator_port=args.coordinator_port,
        controller_port=args.controller_port,
        output_filename=getattr(args, "output_filename", None),
        network_interface=getattr(args, "network_interface", None),
        prefix_output_with_timestamp=getattr(
            args, "prefix_output_with_timestamp", False),
        metrics_port=pinned_port,
        kv_shards=resolve_kv_shards(args))
    if getattr(args, "serve", None):
        print(f"{PROG}: elastic serving {args.serve}: POST http://"
              f"{socket.gethostname()}:{driver.rdv_port}/generate  "
              "(stats: GET /serve/stats, drain: POST /admin/drain, "
              "metrics: GET /metrics)", file=sys.stderr, flush=True)
    # the chaos and scenario specs ride the driver's rendezvous KV, so
    # every incarnation of every worker (reset rounds included) installs
    # the same seeded plan; the alert engine and series store live in the
    # same server, so fleet history and rule state span reset rounds
    publish_chaos_spec(args, driver.rendezvous)
    publish_scenario_spec(args, driver.rendezvous)
    install_alert_rules(args, driver.rendezvous)
    return driver.run()
