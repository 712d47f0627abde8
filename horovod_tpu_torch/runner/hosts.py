"""Host specs and slot assignment: the port's copy of
``horovod_tpu/runner/hosts.py``, with the same names, signatures and env
keys.

Parse "h1:4,h2:4" into host infos and produce per-slot rank assignments
with LOCAL/CROSS coordinates (reference: horovod/runner/common/util/
hosts.py:34-155).  The port runs one process per GPU, so a host's slots are
its cards (``--gpu`` counts them, ``runner/gpu_discovery.py``); a host spec
without ``:slots`` has one.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List


@dataclasses.dataclass
class HostInfo:
    hostname: str
    slots: int

    @classmethod
    def from_string(cls, s: str) -> "HostInfo":
        host, _, slots = s.strip().partition(":")
        if not host:
            raise ValueError(f"empty hostname in host spec {s!r}")
        return cls(host, int(slots) if slots else 1)


@dataclasses.dataclass
class SlotInfo:
    hostname: str
    rank: int
    size: int
    local_rank: int
    local_size: int
    cross_rank: int
    cross_size: int

    def to_env(self) -> Dict[str, str]:
        """Env block the launcher exports per worker (reference:
        gloo_run.py:65-77 HOROVOD_RANK/SIZE/LOCAL_RANK/...)."""
        return {
            "HOROVOD_HOSTNAME": self.hostname,
            "HOROVOD_RANK": str(self.rank),
            "HOROVOD_SIZE": str(self.size),
            "HOROVOD_LOCAL_RANK": str(self.local_rank),
            "HOROVOD_LOCAL_SIZE": str(self.local_size),
            "HOROVOD_CROSS_RANK": str(self.cross_rank),
            "HOROVOD_CROSS_SIZE": str(self.cross_size),
        }


def parse_hosts(hosts_string: str) -> List[HostInfo]:
    """'h1:4,h2:4' -> [HostInfo(h1,4), HostInfo(h2,4)] (reference:
    hosts.py:34-52)."""
    infos = [HostInfo.from_string(part)
             for part in hosts_string.split(",") if part.strip()]
    if not infos:
        raise ValueError(f"no hosts in spec {hosts_string!r}")
    seen = set()
    for h in infos:
        if h.hostname in seen:
            raise ValueError(f"duplicate host {h.hostname!r} in spec")
        seen.add(h.hostname)
    return infos


def get_host_assignments(hosts: List[HostInfo], np_: int,
                         min_np: int = 0) -> List[SlotInfo]:
    """Assign np_ ranks over hosts in order (reference: hosts.py:100-155):
    rank-major over hosts, LOCAL coordinates within host, CROSS = host
    index."""
    total = sum(h.slots for h in hosts)
    if np_ > total:
        raise ValueError(
            f"requested -np {np_} exceeds available slots {total} "
            f"({','.join(f'{h.hostname}:{h.slots}' for h in hosts)})")
    if min_np and total < min_np:
        raise ValueError(f"available slots {total} below --min-np {min_np}")
    slots: List[SlotInfo] = []
    rank = 0
    used_hosts: List[HostInfo] = []
    for h in hosts:
        if rank >= np_:
            break
        used_hosts.append(h)
        rank += min(h.slots, np_ - rank)
    rank = 0
    for cross_rank, h in enumerate(used_hosts):
        local_size = min(h.slots, np_ - rank)
        for local_rank in range(local_size):
            slots.append(SlotInfo(
                hostname=h.hostname, rank=rank, size=np_,
                local_rank=local_rank, local_size=local_size,
                cross_rank=cross_rank, cross_size=len(used_hosts)))
            rank += 1
    return slots


def env_for_tasks(hostnames: List[str],
                  coordinator_port: int = 29500) -> List[Dict[str, str]]:
    """Per-task HOROVOD_* env blocks for schedulers that report one
    hostname per task (Spark barrier stages, Ray actors): tasks on the
    same host get consecutive LOCAL ranks, hosts get CROSS ranks in
    first-seen order, and the returned list aligns with the INPUT order.

    The ``torch.distributed`` store must live where PROCESS 0 runs (it
    binds the address) — so the coordinator host is rank 0's host, never
    the launcher's (launch.py uses slots[0].hostname).

    One assignment implementation serves the launcher, Spark and Ray — the
    reference's Coordinator re-derives this per integration
    (ray/runner.py:41-127, Spark's rank-by-partition)."""
    order: List[str] = []
    members: Dict[str, List[int]] = {}
    for i, h in enumerate(hostnames):
        if h not in members:
            members[h] = []
            order.append(h)
        members[h].append(i)
    hosts = [HostInfo(hostname=h, slots=len(members[h])) for h in order]
    slots = get_host_assignments(hosts, len(hostnames))
    coordinator_addr = f"{slots[0].hostname}:{coordinator_port}"
    envs: List[Dict[str, str]] = [dict() for _ in hostnames]
    by_host: Dict[str, List[SlotInfo]] = {}
    for s in slots:
        by_host.setdefault(s.hostname, []).append(s)
    for h in order:
        for idx, slot in zip(members[h], by_host[h]):
            env = slot.to_env()
            env["HOROVOD_COORDINATOR_ADDR"] = (
                coordinator_addr if len(hostnames) > 1 else "")
            envs[idx] = env
    return envs
