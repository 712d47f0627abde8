"""Tiny HTTP KV client for the rendezvous server: the port of
``horovod_tpu/runner/http_client.py`` (reference:
horovod/runner/http/http_client.py:1-45, read_data_from_kvstore /
put_data_into_kvstore).

Writers retry on transient failures with bounded exponential backoff and
jitter (knobs ``HOROVOD_KV_RETRIES`` / ``HOROVOD_KV_RETRY_BACKOFF_MS``), and
the blocking reader rides outages out until its deadline
(``HOROVOD_GLOO_TIMEOUT_SECONDS`` by default).

Sharding (docs/control-plane.md): when the launcher started shard servers
(``--kv-shards N``) it stamps the address list into
``HOROVOD_KV_SHARD_ADDRS`` (primary first).  Every call here routes a
request whose target is the PRIMARY to the scope's owning shard via the
deterministic ``runner/kvshard.shard_for_scope`` map; requests aimed at any
other server pass through untouched.

Each transient failure against a shard of a sharded KV counts into
``hvd_kv_shard_unavailable_total{shard=...}``, per attempt, as in the JAX
client.  The JAX client also lets the chaos plane black the KV out
(ROADMAP queue 1 item 4.5); the port has no chaos plane yet.
"""

from __future__ import annotations

import os
import time
import urllib.error
import urllib.request
from typing import List, Optional, Tuple

from ..common.util import backoff_delays
from .kvshard import parse_shard_addrs, shard_for_scope

# Explicit override (tests, ShardedKVClient): wins over the env map.
_installed_map: Optional[List[Tuple[str, int]]] = None
# Env-map cache keyed on the raw env string (cheap per-op resolve).
_env_map_raw: Optional[str] = None
_env_map: Optional[List[Tuple[str, int]]] = None


def install_shard_map(addrs: Optional[List[Tuple[str, int]]]) -> None:
    """Install (or with None, clear) the process-global shard map,
    overriding HOROVOD_KV_SHARD_ADDRS."""
    global _installed_map
    _installed_map = list(addrs) if addrs else None


def _shard_map() -> Optional[List[Tuple[str, int]]]:
    global _env_map_raw, _env_map
    if _installed_map is not None:
        return _installed_map
    raw = os.environ.get("HOROVOD_KV_SHARD_ADDRS", "")
    if not raw:
        return None
    if raw != _env_map_raw:
        _env_map_raw = raw
        try:
            _env_map = parse_shard_addrs(raw)
        except ValueError:
            _env_map = None
    return _env_map


def resolve_kv_addr(addr: str, port: int,
                    scope: str) -> Tuple[str, int, int]:
    """(addr, port, shard index) a KV op for ``scope`` should target.
    Reroutes only when the caller aimed at the fleet primary — any other
    (addr, port) is an ad-hoc server outside the sharded KV."""
    shards = _shard_map()
    if not shards or len(shards) < 2:
        return addr, int(port), 0
    if (addr, int(port)) != (shards[0][0], shards[0][1]):
        return addr, int(port), 0
    idx = shard_for_scope(scope, len(shards))
    a, p = shards[idx]
    return a, p, idx


def _retry_delays(retries: Optional[int]):
    from ..common.knobs import current
    if retries is None:
        retries = int(current("HOROVOD_KV_RETRIES"))
    return backoff_delays(retries, float(current(
        "HOROVOD_KV_RETRY_BACKOFF_MS")))


def _transient(e: Exception) -> bool:
    """Retryable: connection-level failures and 5xx; a 4xx is a caller bug
    and must surface immediately."""
    if isinstance(e, urllib.error.HTTPError):
        return e.code >= 500
    return isinstance(e, (urllib.error.URLError, ConnectionError,
                          TimeoutError))


def _count_shard_unavailable(shard: int) -> None:
    if _shard_map() is None:
        return
    try:  # telemetry must never take the KV op (or its retry) down
        from ..utils import metrics as M
        M.KV_SHARD_UNAVAILABLE.inc(shard=str(shard))
    except Exception:
        pass


def put_kv(addr: str, port: int, scope: str, key: str,
           value: bytes, retries: Optional[int] = None) -> None:
    addr, port, shard = resolve_kv_addr(addr, port, scope)
    url = f"http://{addr}:{port}/{scope}/{key}"
    delays = _retry_delays(retries)
    for attempt in range(len(delays) + 1):
        try:
            req = urllib.request.Request(url, data=value, method="PUT")
            with urllib.request.urlopen(req, timeout=10):
                return
        except Exception as e:
            if _transient(e):
                _count_shard_unavailable(shard)
            if attempt >= len(delays) or not _transient(e):
                raise
            time.sleep(delays[attempt])


def get_kv(addr: str, port: int, scope: str, key: str,
           timeout: Optional[float] = None,
           poll_interval: float = 0.2) -> Optional[bytes]:
    """GET with blocking-until-present semantics (workers wait for the
    launcher to publish).  ``timeout=None`` reads
    HOROVOD_GLOO_TIMEOUT_SECONDS (reference: --gloo-timeout-seconds); pass
    0 for a non-blocking probe.  Transient connection errors are retried
    until the deadline like a 404; at the deadline they RAISE — an
    unreachable server is not an absent key."""
    if timeout is None:
        from ..common.knobs import current
        timeout = float(current("HOROVOD_GLOO_TIMEOUT_SECONDS"))
    addr, port, shard = resolve_kv_addr(addr, port, scope)
    url = f"http://{addr}:{port}/{scope}/{key}"
    deadline = time.time() + timeout
    while True:
        try:
            with urllib.request.urlopen(url, timeout=10) as resp:
                return resp.read()
        except urllib.error.HTTPError as e:
            if e.code != 404:
                raise
            if time.time() >= deadline:
                return None
            time.sleep(poll_interval)
        except Exception as e:
            if _transient(e):
                _count_shard_unavailable(shard)
            if not _transient(e) or time.time() >= deadline:
                raise
            time.sleep(poll_interval)


def delete_kv(addr: str, port: int, scope: str, key: str,
              retries: Optional[int] = None) -> bool:
    addr, port, shard = resolve_kv_addr(addr, port, scope)
    url = f"http://{addr}:{port}/{scope}/{key}"
    delays = _retry_delays(retries)
    for attempt in range(len(delays) + 1):
        try:
            req = urllib.request.Request(url, method="DELETE")
            with urllib.request.urlopen(req, timeout=10):
                return True
        except urllib.error.HTTPError:
            return False
        except Exception as e:
            if _transient(e):
                _count_shard_unavailable(shard)
            if attempt >= len(delays) or not _transient(e):
                raise
            time.sleep(delays[attempt])
    return False


class ShardedKVClient:
    """Scope-routing client bound to one fleet KV: ``(primary addr,
    primary port, shard address list)`` resolved once, then every op
    targets the owning shard directly."""

    def __init__(self, addrs: List[Tuple[str, int]]):
        if not addrs:
            raise ValueError("ShardedKVClient needs at least one shard")
        self.addrs = [(a, int(p)) for a, p in addrs]

    @classmethod
    def from_env(cls, knobs=None) -> Optional["ShardedKVClient"]:
        """Build from HOROVOD_KV_SHARD_ADDRS (or, unsharded, from the
        rendezvous addr/port knobs); None when no rendezvous is known."""
        shards = _shard_map()
        if shards:
            return cls(shards)
        if knobs is None:
            from ..common.knobs import current
            addr = current("HOROVOD_RENDEZVOUS_ADDR")
            port = current("HOROVOD_RENDEZVOUS_PORT")
        else:
            addr = knobs["HOROVOD_RENDEZVOUS_ADDR"]
            port = knobs["HOROVOD_RENDEZVOUS_PORT"]
        if not addr or not port:
            return None
        return cls([(addr, int(port))])

    def _target(self, scope: str) -> Tuple[str, int]:
        return self.addrs[shard_for_scope(scope, len(self.addrs))]

    def put(self, scope: str, key: str, value: bytes,
            retries: Optional[int] = None) -> None:
        a, p = self._target(scope)
        put_kv(a, p, scope, key, value, retries=retries)

    def get(self, scope: str, key: str,
            timeout: Optional[float] = None,
            poll_interval: float = 0.2) -> Optional[bytes]:
        a, p = self._target(scope)
        return get_kv(a, p, scope, key, timeout=timeout,
                      poll_interval=poll_interval)

    def delete(self, scope: str, key: str,
               retries: Optional[int] = None) -> bool:
        a, p = self._target(scope)
        return delete_kv(a, p, scope, key, retries=retries)
