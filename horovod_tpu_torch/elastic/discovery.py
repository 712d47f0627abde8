"""Host discovery for elastic training: the port of
``horovod_tpu/elastic/discovery.py``, over the port's ``runner/hosts.py``.

Reference: horovod/runner/elastic/discovery.py: a user-provided discovery
script prints the current 'host:slots' list (discovery.py:146+); the
driver polls it and diffs against the active set; failing hosts are
blacklisted (discovery.py:80-134).
"""

from __future__ import annotations

import subprocess
import threading
from typing import List, Set, Tuple

from ..runner import hosts as hosts_mod


class HostDiscovery:
    def find_available_hosts(self) -> List[hosts_mod.HostInfo]:
        raise NotImplementedError


class HostDiscoveryScript(HostDiscovery):
    """Runs the user script; one 'host[:slots]' per line (reference:
    discovery.py:146-186)."""

    def __init__(self, script_path: str, default_slots: int = 1):
        self.script_path = script_path
        self.default_slots = default_slots

    def find_available_hosts(self) -> List[hosts_mod.HostInfo]:
        out = subprocess.run([self.script_path], capture_output=True,
                             text=True, timeout=30)
        if out.returncode != 0:
            raise RuntimeError(
                f"host discovery script failed rc={out.returncode}: "
                f"{out.stderr[:200]}")
        hosts: List[hosts_mod.HostInfo] = []
        for line in out.stdout.splitlines():
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            if ":" not in line:
                line = f"{line}:{self.default_slots}"
            hosts.append(hosts_mod.HostInfo.from_string(line))
        return hosts


class FixedHosts(HostDiscovery):
    """A static host set behind the discovery interface (tests, and the
    static fallback)."""

    def __init__(self, hosts: List[hosts_mod.HostInfo]):
        self._hosts = hosts

    def set(self, hosts: List[hosts_mod.HostInfo]) -> None:
        self._hosts = hosts

    def find_available_hosts(self) -> List[hosts_mod.HostInfo]:
        return list(self._hosts)


class HostManager:
    """Tracks available vs blacklisted hosts (reference:
    discovery.py:80-134 HostManager + blacklist)."""

    def __init__(self, discovery: HostDiscovery):
        self._discovery = discovery
        self._blacklist: Set[str] = set()
        self._lock = threading.Lock()

    def blacklist(self, hostname: str) -> None:
        with self._lock:
            self._blacklist.add(hostname)

    def is_blacklisted(self, hostname: str) -> bool:
        with self._lock:
            return hostname in self._blacklist

    def current_hosts(self) -> List[hosts_mod.HostInfo]:
        hosts = self._discovery.find_available_hosts()
        with self._lock:
            return [h for h in hosts if h.hostname not in self._blacklist]

    def update_available_hosts(
            self, prev: List[hosts_mod.HostInfo]
    ) -> Tuple[List[hosts_mod.HostInfo], bool]:
        """Returns (hosts, changed)."""
        cur = self.current_hosts()
        changed = ({h.hostname: h.slots for h in cur} !=
                   {h.hostname: h.slots for h in prev})
        return cur, changed
