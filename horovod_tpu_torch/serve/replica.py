"""Replicated serving tier: the port's copy of ``horovod_tpu/serve/replica.py``
(docs/serving.md#replicated-tier), with the same scopes, keys, fingerprints
and placement.

One lockstep fleet is a serving ceiling: rank 0 plans every tick and
all ranks run one engine.  This module scales the front door OUT the
way Horovod scaled training out (data-parallel replication, arxiv
1802.05799): N independent serving replica fleets register behind one
router/rendezvous process under the ``replicas`` KV scope, and the
router places each ``POST /generate`` with **prefix affinity** — the
replica whose radix prefix cache (serve/engine.py PrefixCache) already
holds the longest prefix of the prompt wins, so replication multiplies
the cache instead of fragmenting it.

The affinity protocol is fingerprint-based and deliberately compact:

  * each replica's rank 0 piggybacks ``prefix_fingerprints`` — rolling
    sha1 fingerprints of the top of its radix tree, one per full token
    block along each cached path — on the stats publish it already
    makes every second (serve/worker.py ``_publish_stats``);
  * the router computes the SAME rolling fingerprints over the
    prompt's full blocks (``prompt_fingerprints``) and routes to the
    replica matching the deepest one, falling back to least-loaded
    (queue-depth from the same stats stream, then lowest replica id);
  * a replica whose stats heartbeat goes stale is DARK: it receives no
    traffic, and streams it was serving are re-dispatched to a
    surviving replica with their already-streamed prefix suppressed —
    the per-replica journal redrive semantics (serve/journal.py),
    driven router-side.

Everything here is lockstep-grade deterministic (the hvdlint
``serve-determinism`` rule covers this module): no RNG, no clock reads
— callers pass ``now`` explicitly — and no unordered-set iteration, so
the affinity map and the replica digest fold replay identically.
"""

from __future__ import annotations

import hashlib
from typing import Any, Dict, List, Optional, Tuple

# KV scope the replica registry lives under on the shared rendezvous
# server: one ``replica.KK`` key per fleet, written by each replica's
# rank 0 at startup (docs/serving.md#replicated-tier).
REPLICA_SCOPE = "replicas"


def replica_key(replica_id: int) -> str:
    return f"replica.{replica_id:02d}"


def scoped(base: str, replica_id: int) -> str:
    """Per-replica KV scope name: replica 0 keeps the unscoped names
    (a single fleet is byte-for-byte the pre-replica deployment, and
    every existing test/tool keeps working); replica K > 0 suffixes
    ``.rKK`` so N fleets share one rendezvous KV without collisions.
    The suffix rides into kvshard.shard_for_scope unchanged, so each
    replica's scopes spread over the shards like any other scope."""
    if replica_id == 0:
        return base
    return f"{base}.r{replica_id:02d}"


# ------------------------------------------------------- fingerprints
def _fold_block(h, tokens) -> None:
    h.update((",".join(str(int(t)) for t in tokens) + ";").encode())


def prompt_fingerprints(tokens: List[int], block_size: int,
                        max_blocks: int = 32) -> List[str]:
    """Rolling fingerprints of a prompt's full token blocks:
    ``fps[i]`` identifies the prompt's first ``i + 1`` blocks as a
    unit, so matching a replica's advertisement at depth i means that
    replica's radix tree holds that exact (i + 1)-block prefix.  Pure
    function of (tokens, block_size) — identical on router and every
    replica."""
    fps: List[str] = []
    h = hashlib.sha1()
    n_full = min(len(tokens) // block_size, max_blocks)
    for i in range(n_full):
        _fold_block(h, tokens[i * block_size:(i + 1) * block_size])
        fps.append(h.copy().hexdigest()[:12])
    return fps


def prefix_fingerprints(cache: Any, max_nodes: int = 64) -> List[str]:
    """Compact top-of-tree advertisement of a PrefixCache: breadth-
    first over the radix tree (sorted child keys — deterministic),
    full-block nodes only, each node contributing the rolling sha1 of
    its token path.  Spilled nodes (block migrated to host RAM) still
    advertise — their KV reloads on hit, which is the point of the
    spill tier.  Bounded at ``max_nodes`` entries so the stats publish
    stays small no matter how big the tree grows; the top of the tree
    is exactly where shared system prompts / few-shot templates live,
    so truncation costs the least-shared tails first."""
    out: List[str] = []
    queue: List[Tuple[Any, Any]] = [(cache.root, hashlib.sha1())]
    bs = cache.block_size
    while queue and len(out) < max_nodes:
        node, h = queue.pop(0)
        for key in sorted(node.children):
            child = node.children[key]
            if len(child.tokens) != bs:
                continue  # partial tails are CoW territory, not affinity
            h2 = h.copy()
            _fold_block(h2, child.tokens)
            out.append(h2.hexdigest()[:12])
            if len(out) >= max_nodes:
                break
            queue.append((child, h2))
    return out


def fold_digest(fps: List[str]) -> str:
    """One replica's prefix-tree digest: the rolling sha1 fold of its
    advertised fingerprints in publish order.  Rides the stats payload
    and ``doctor --serve`` so 'do these replicas hold different trees'
    is a two-string comparison."""
    h = hashlib.sha1()
    for fp in fps:
        h.update((fp + "|").encode())
    return h.hexdigest()[:16]


# ------------------------------------------------------------ registry
class ReplicaRouter:
    """Router-side replica registry + prefix-affinity placement.

    Lives on the rendezvous/router process (one instance per server,
    attached by serve/router.py).  State per replica: the registration
    record, the latest advertised fingerprint list (kept as a sorted
    list — membership probes bisect it, iteration stays ordered), the
    queue-depth/shed load signals from the same stats publish, and the
    heartbeat stamp that decides dark.  All methods take ``now``
    explicitly — this class never reads a clock (hvdlint
    serve-determinism)."""

    def __init__(self, block_size: int = 16, affinity: bool = True,
                 dead_after_s: float = 3.0):
        self.block_size = int(block_size)
        self.affinity = bool(affinity)
        self.dead_after_s = float(dead_after_s)
        self.replicas: Dict[int, Dict[str, Any]] = {}
        self.affinity_hits = 0
        self.affinity_misses = 0
        self.redispatches = 0
        # The last route() call's full placement verdict — candidate
        # scores plus the affinity-vs-least-loaded decision — for the
        # request-trace record (docs/serving.md#request-lifecycle).
        # Pure derived state: replaying the same calls rebuilds it.
        self.last_verdict: Optional[Dict[str, Any]] = None

    # ---------------------------------------------------------- intake
    def register(self, replica_id: int,
                 info: Optional[Dict[str, Any]] = None,
                 now: float = 0.0) -> None:
        rid = int(replica_id)
        rec = self.replicas.setdefault(rid, {
            "info": {}, "fps": [], "digest": fold_digest([]),
            "queue_depth": 0, "shed": False, "last_seen": now,
            "routed": 0, "hits": 0, "stats": {},
        })
        if info:
            rec["info"] = dict(info)
            if info.get("block_size"):
                # Fingerprint with the fleet's real block size — the
                # router's default only holds until a replica registers.
                self.block_size = int(info["block_size"])
        rec["last_seen"] = max(rec["last_seen"], now)

    def update(self, replica_id: int, stats: Dict[str, Any],
               now: float = 0.0) -> None:
        """Fold one stats publish into the registry: fingerprints,
        digest, and load signals.  Called by the router when it reads a
        replica's stats key (in-process, no extra transport)."""
        rid = int(replica_id)
        if rid not in self.replicas:
            self.register(rid, now=now)
        rec = self.replicas[rid]
        fps = stats.get("prefix_fps")
        if fps is not None:
            rec["fps"] = sorted(str(f) for f in fps)
            rec["digest"] = stats.get("replica_digest") or \
                fold_digest(list(fps))
        rec["queue_depth"] = int(stats.get("queue_depth",
                                           stats.get("waiting", 0)) or 0)
        rec["shed"] = bool(stats.get("shed", False))
        rec["stats"] = stats
        rec["last_seen"] = max(rec["last_seen"], now)

    # ----------------------------------------------------------- state
    def is_dark(self, replica_id: int, now: float) -> bool:
        rec = self.replicas.get(int(replica_id))
        if rec is None:
            return True
        return (now - rec["last_seen"]) > self.dead_after_s

    def live(self, now: float) -> List[int]:
        return [rid for rid in sorted(self.replicas)
                if not self.is_dark(rid, now)]

    # ----------------------------------------------------------- route
    def _least_loaded(self, rids: List[int]) -> int:
        """Deterministic fallback: lowest (shedding, queue_depth, rid)
        — a shedding replica loses to any accepting one."""
        best = rids[0]
        brec = self.replicas[best]
        for rid in rids[1:]:
            rec = self.replicas[rid]
            if (rec["shed"], rec["queue_depth"], rid) < \
                    (brec["shed"], brec["queue_depth"], best):
                best, brec = rid, rec
        return best

    def route(self, tokens: List[int], now: float,
              exclude: Optional[List[int]] = None
              ) -> Optional[Tuple[int, int]]:
        """Place one request: ``(replica_id, hit_blocks)`` —
        ``hit_blocks`` is the affinity depth in full blocks (0 = pure
        least-loaded placement).  ``exclude`` removes replicas (the
        dead fleet a re-dispatch is fleeing).  None when no live
        replica exists."""
        dropped = sorted(set(int(r) for r in (exclude or [])))
        rids = [r for r in self.live(now) if r not in dropped]
        if not rids:
            self.last_verdict = {"kind": "no_live_replica",
                                 "winner": None, "hit_blocks": 0,
                                 "excluded": dropped, "candidates": []}
            return None
        best_rid, best_depth = None, 0
        depths = {rid: 0 for rid in rids}
        fps: List[str] = []
        if self.affinity:
            fps = prompt_fingerprints(tokens, self.block_size)
            for rid in rids:
                adv = self.replicas[rid]["fps"]
                if not adv:
                    continue
                depth = 0
                for i, fp in enumerate(fps):
                    if _bisect_contains(adv, fp):
                        depth = i + 1
                    else:
                        break
                depths[rid] = depth
                if depth > best_depth:
                    best_rid, best_depth = rid, depth
                elif depth == best_depth and best_rid is not None \
                        and depth > 0:
                    # tie: lighter queue wins, then lower id
                    cand, cur = self.replicas[rid], self.replicas[best_rid]
                    if (cand["queue_depth"], rid) < \
                            (cur["queue_depth"], best_rid):
                        best_rid = rid
        if best_rid is None or best_depth == 0:
            best_rid = self._least_loaded(rids)
            best_depth = 0
            self.affinity_misses += 1
            kind = "least_loaded"
        else:
            self.affinity_hits += 1
            self.replicas[best_rid]["hits"] += 1
            kind = "affinity"
        self.replicas[best_rid]["routed"] += 1
        self.last_verdict = {
            "kind": kind, "winner": best_rid, "hit_blocks": best_depth,
            "prompt_blocks": len(fps), "excluded": dropped,
            "candidates": [
                {"replica": rid, "depth": depths[rid],
                 "queue_depth": self.replicas[rid]["queue_depth"],
                 "shed": self.replicas[rid]["shed"]}
                for rid in rids],
        }
        return best_rid, best_depth

    def note_redispatch(self) -> None:
        self.redispatches += 1

    def note_load(self, replica_id: int, pending: int) -> None:
        """Overlay a FRESHER load signal over the advertised queue
        depth: the stats heartbeat is <= 1 Hz, but the router knows
        exactly how many requests it has placed on a replica that are
        still in flight (RouterState ``next_seq - completed``).  Taking
        the max keeps the least-loaded fallback honest in the window
        between two heartbeats — without it, a burst lands entirely on
        the lowest replica id before any depth is re-advertised.  The
        next ``update`` resets the depth to the replica's own view."""
        rec = self.replicas.get(int(replica_id))
        if rec is not None:
            rec["queue_depth"] = max(rec["queue_depth"], int(pending))

    # ------------------------------------------------------------ view
    def counters(self, now: Optional[float] = None) -> Dict[str, Any]:
        routed = self.affinity_hits + self.affinity_misses
        out: Dict[str, Any] = {
            "replicas": len(self.replicas),
            "affinity": self.affinity,
            "affinity_hits": self.affinity_hits,
            "affinity_misses": self.affinity_misses,
            "affinity_hit_rate": (round(self.affinity_hits / routed, 4)
                                  if routed else None),
            "redispatches": self.redispatches,
        }
        if now is not None:
            out["live"] = self.live(now)
        per = {}
        for rid in sorted(self.replicas):
            rec = self.replicas[rid]
            per[str(rid)] = {
                "routed": rec["routed"],
                "affinity_hits": rec["hits"],
                "queue_depth": rec["queue_depth"],
                "shed": rec["shed"],
                "digest": rec["digest"],
                "fps": len(rec["fps"]),
                "dark": (self.is_dark(rid, now)
                         if now is not None else None),
            }
        out["per_replica"] = per
        return out


def _bisect_contains(sorted_list: List[str], item: str) -> bool:
    import bisect
    i = bisect.bisect_left(sorted_list, item)
    return i < len(sorted_list) and sorted_list[i] == item
