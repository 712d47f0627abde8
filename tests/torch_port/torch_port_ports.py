"""Loopback ports for the port's tests that start listeners of their own
(a launcher's coordinator and controller, a native core): each port is
taken from below the kernel's ephemeral range and held bound until the
caller releases it right before the listener starts.

A port probed by binding port 0 lies in the ephemeral range, which the
kernel hands to every outgoing connection; released early, another
process's connection took it before the rank bound it (EADDRINUSE under
the six-worker test run).  No connection is ever given a port below the
range, and a held port is bound, so no other prober gets it either."""

from __future__ import annotations

import errno
import random
import socket
from typing import List

_LOW = 20000


def _ephemeral_start() -> int:
    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            return int(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return 32768


class HeldPorts:
    """``n`` free ports, each held by a bound socket until
    :meth:`release`; use as a context manager, or release by hand right
    before the spawn that binds them."""

    def __init__(self, n: int = 1):
        high = max(_ephemeral_start(), _LOW + 1000)
        rng = random.SystemRandom()
        self._socks: List[socket.socket] = []
        self.ports: List[int] = []
        while len(self.ports) < n:
            port = rng.randrange(_LOW, high)
            s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            try:
                s.bind(("", port))
            except OSError as e:
                s.close()
                if e.errno in (errno.EADDRINUSE, errno.EACCES):
                    continue
                raise
            self._socks.append(s)
            self.ports.append(port)

    def release(self) -> List[int]:
        for s in self._socks:
            s.close()
        self._socks = []
        return self.ports

    def __enter__(self) -> "HeldPorts":
        return self

    def __exit__(self, *exc) -> None:
        self.release()


def hold_ports(n: int = 1) -> HeldPorts:
    return HeldPorts(n)
