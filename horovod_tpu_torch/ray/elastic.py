"""Elastic training on Ray clusters; the port of
``horovod_tpu/ray/elastic.py``.

Reference: horovod/ray/elastic.py — ``RayHostDiscovery`` derives the
available host:slots map from the live Ray cluster (instead of a user
discovery script), and ``ElasticRayExecutor`` runs a training function
under the elastic driver, through node arrivals and departures.

The reset machinery is the port's own ``ElasticDriver``
(``elastic/driver.py``): a membership change restarts every worker
process, since a process group cannot shrink in place.  The function
travels to the workers through the driver's rendezvous KV, which every
worker dials already, and each rank's result comes back the same way, so
remote hosts need no shared filesystem.  The payload's first record is
the caller's ``sys.path``, which the worker adds before it unpickles the
function; the function goes by value through cloudpickle when that
imports, else by reference through pickle, and then a function defined
in ``__main__`` raises (the worker could not find it).  Tensors in a
result come back on the CPU.

Departure: the executor takes the controller port the driver reuses
every round (``controller_port``), beside ``coordinator_port``: the
port's driver checks both before a round spawns.
"""

from __future__ import annotations

import io
import os
import pickle
import sys
from typing import Any, Callable, Dict, List, Optional

from ..elastic.discovery import HostDiscovery
from ..elastic.driver import ElasticDriver
from ..runner import hosts as hosts_mod

PAYLOAD_SCOPE, PAYLOAD_KEY = "rayexec", "payload"
RESULT_SCOPE = "rayresult"


class RayHostDiscovery(HostDiscovery):
    """Hosts and slots from the live Ray cluster (reference:
    ray/elastic.py RayHostDiscovery.find_available_hosts_and_slots): every
    alive node gives ``CPU // cpus_per_slot`` slots, capped by its GPUs
    when ``use_gpu``."""

    def __init__(self, use_gpu: bool = False, cpus_per_slot: int = 1,
                 gpus_per_slot: int = 1):
        try:
            import ray  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "RayHostDiscovery requires ray; pass an explicit "
                "`discovery` (e.g. HostDiscoveryScript / FixedHosts) to "
                "ElasticRayExecutor in ray-less environments") from e
        self._ray = __import__("ray")
        self.use_gpu = use_gpu
        self.cpus_per_slot = max(1, cpus_per_slot)
        self.gpus_per_slot = max(1, gpus_per_slot)

    def find_available_hosts(self) -> List[hosts_mod.HostInfo]:
        out: List[hosts_mod.HostInfo] = []
        for node in self._ray.nodes():
            if not node.get("Alive", False):
                continue
            res = node.get("Resources", {}) or {}
            slots = int(res.get("CPU", 0)) // self.cpus_per_slot
            if self.use_gpu:
                slots = min(slots,
                            int(res.get("GPU", 0)) // self.gpus_per_slot)
            hostname = (node.get("NodeManagerHostname")
                        or node.get("NodeManagerAddress"))
            if slots > 0 and hostname:
                out.append(hosts_mod.HostInfo(hostname, slots))
        return out


def _serialize_closure(fn: Callable, args, kwargs) -> bytes:
    """Two pickle records: the caller's ``sys.path``, then the function
    with its arguments (by value through cloudpickle when it imports)."""
    buf = io.BytesIO()
    pickle.dump(list(sys.path), buf)
    try:
        import cloudpickle
        cloudpickle.dump((fn, tuple(args), dict(kwargs)), buf)
    except ImportError:
        if getattr(fn, "__module__", None) == "__main__":
            raise RuntimeError(
                "shipping a __main__-defined function to elastic workers "
                "requires cloudpickle (plain pickle serializes it by "
                "reference, which dangles in the worker process); install "
                "cloudpickle or move the function into an importable "
                "module")
        pickle.dump((fn, tuple(args), dict(kwargs)), buf)
    return buf.getvalue()


class _ElasticRunDriver(ElasticDriver):
    """An ``ElasticDriver`` that publishes the payload in its KV and
    clears the results at the start of every round, so that only the
    round that finished leaves its results."""

    def __init__(self, payload: bytes, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.rendezvous.put(PAYLOAD_SCOPE, PAYLOAD_KEY, payload)

    def compute_assignments(self, hosts):
        self.rendezvous.clear_scope(RESULT_SCOPE)
        return super().compute_assignments(hosts)

    def collect_results(self) -> List[Any]:
        # server-side reads stay valid after the driver stopped the
        # listener (RendezvousServer keeps its store)
        out: List[Any] = []
        rank = 0
        while True:
            raw = self.rendezvous.get(RESULT_SCOPE, f"rank.{rank}")
            if raw is None:
                break
            out.append(pickle.loads(raw))
            rank += 1
        return out


class ElasticRayExecutor:
    """Run a function elastically on a Ray cluster (reference:
    ray/elastic.py ElasticRayExecutor: settings and discovery, then run).

    With no ``discovery``, hosts come from the live cluster through
    :class:`RayHostDiscovery`, which needs ray; any
    :class:`HostDiscovery` can stand in (``FixedHosts`` on one machine),
    as the reference's own tests swap it."""

    def __init__(self, min_np: int = 1, max_np: Optional[int] = None,
                 use_gpu: bool = False, cpus_per_slot: int = 1,
                 gpus_per_slot: int = 1,
                 env: Optional[Dict[str, str]] = None,
                 elastic_timeout: float = 600.0,
                 reset_limit: int = 0,
                 coordinator_port: int = 29517,
                 discovery: Optional[HostDiscovery] = None,
                 controller_port: int = 29499):
        self.min_np = min_np
        self.max_np = max_np if max_np is not None else (1 << 30)
        self.use_gpu = use_gpu
        self.cpus_per_slot = cpus_per_slot
        self.gpus_per_slot = gpus_per_slot
        self.extra_env = dict(env or {})
        self.elastic_timeout = elastic_timeout
        self.reset_limit = reset_limit
        self.coordinator_port = coordinator_port
        self.controller_port = controller_port
        self._discovery = discovery
        self._started = False

    def start(self) -> None:
        """Resolve the discovery (reference: ElasticRayExecutor.start)."""
        if self._discovery is None:
            self._discovery = RayHostDiscovery(
                use_gpu=self.use_gpu, cpus_per_slot=self.cpus_per_slot,
                gpus_per_slot=self.gpus_per_slot)
        self._started = True

    def run(self, fn: Callable, args=(), kwargs=None) -> List[Any]:
        """Run ``fn(*args, **kwargs)`` on every elastic worker; returns the
        results, in rank order, of the round that finished cleanly."""
        if not self._started:
            raise RuntimeError("call start() first")
        payload = _serialize_closure(fn, args, kwargs or {})
        # the worker's entry module must import wherever the workers start
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env = dict(self.extra_env)
        env["PYTHONPATH"] = os.pathsep.join(
            [root] + [p for p in env.get(
                "PYTHONPATH", os.environ.get("PYTHONPATH", "")).split(
                    os.pathsep) if p])
        command = [sys.executable, "-m", "horovod_tpu_torch.ray.elastic_run"]
        driver = _ElasticRunDriver(
            payload, self._discovery, self.min_np, self.max_np,
            command, env=env,
            elastic_timeout=self.elastic_timeout,
            reset_limit=self.reset_limit,
            coordinator_port=self.coordinator_port,
            controller_port=self.controller_port)
        try:
            rc = driver.run()
        except TimeoutError as e:
            # every host blacklisted, or fewer slots than min_np: the run
            # is over, not the cluster's bring-up
            raise RuntimeError(f"elastic run failed: {e}") from e
        if rc != 0:
            raise RuntimeError(
                f"elastic run failed (rc={rc}); see driver log")
        return driver.collect_results()

    def shutdown(self) -> None:
        self._started = False


__all__ = ["RayHostDiscovery", "ElasticRayExecutor"]
