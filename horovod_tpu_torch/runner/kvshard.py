"""Deterministic scope→shard map for the sharded rendezvous KV: the
port's copy of ``horovod_tpu/runner/kvshard.py`` (docs/control-plane.md),
the same map bit for bit, so a port worker and a JAX one agree on every
scope's owner.

The rendezvous KV is partitioned across N shard servers (the launcher's
``--kv-shards N`` / ``HOROVOD_KV_SHARDS``) so serve traffic, telemetry
and coordination stop contending on one accept loop.  Every party —
the launcher's shard servers, every worker's KV client, the router's
in-process store reads — derives a scope's owner from the SAME pure
function of ``(scope name, shard count)``, so the fleet agrees on the
partition by construction, with no map exchange on the data path (the
launcher still publishes the address list: scope ``kvshard`` key ``map``
plus the ``HOROVOD_KV_SHARD_ADDRS`` worker env).

Determinism contract: nothing in this module may consult RNG, wall
clocks, unordered-set iteration or the builtin ``hash()``
(PYTHONHASHSEED-dependent).  ``shard_for_scope`` is
FNV-1a over the scope's UTF-8 bytes — stable across processes, hosts
and Python versions.  Changing the shard COUNT remaps scopes (it is a
modulus, not a consistent-hash ring); that is fine because the count
is fixed per launch and the KV is launch-scoped state.
"""

from __future__ import annotations

from typing import List, Tuple

_FNV_OFFSET = 2166136261
_FNV_PRIME = 16777619

# The bootstrap scope holding the published shard map itself: pinned to
# the primary (still a pure function of the inputs) because a client
# that doesn't know the map yet can only ask the door it was given.
MAP_SCOPE = "kvshard"
MAP_KEY = "map"


def shard_for_scope(scope: str, nshards: int) -> int:
    """Owning shard index of a KV scope: FNV-1a(scope) mod nshards.
    Pure and total — identical on every rank for every input; shard 0
    (the primary, which also hosts the HTTP routes) is an ordinary
    member of the modulus."""
    n = int(nshards)
    if n <= 1 or scope == MAP_SCOPE:
        return 0
    h = _FNV_OFFSET
    for b in scope.encode("utf-8"):
        h = ((h ^ b) * _FNV_PRIME) & 0xFFFFFFFF
    return h % n


def scope_table(scopes: List[str], nshards: int) -> List[Tuple[str, int]]:
    """(scope, shard) rows for a scope list — the docs/doctor rendering
    helper; sorted by scope name so the table is stable."""
    return [(s, shard_for_scope(s, nshards)) for s in sorted(scopes)]


def parse_shard_addrs(spec: str) -> List[Tuple[str, int]]:
    """Parse ``HOROVOD_KV_SHARD_ADDRS``: comma-separated ``host:port``
    entries, primary (shard 0) first.  Raises ValueError on a malformed
    entry so a typo fails bring-up, not a KV op hours later."""
    out: List[Tuple[str, int]] = []
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        host, sep, port = part.rpartition(":")
        if not sep or not host:
            raise ValueError(
                f"HOROVOD_KV_SHARD_ADDRS entry {part!r} is not host:port")
        out.append((host, int(port)))
    return out


def format_shard_addrs(addrs: List[Tuple[str, int]]) -> str:
    return ",".join(f"{host}:{int(port)}" for host, port in addrs)
