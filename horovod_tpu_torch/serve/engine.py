"""Continuous-batching inference engine: the port of
``horovod_tpu/serve/engine.py`` (one device).

One preallocated paged KV pool (``init_cache`` of the model's module), a
static-shape slot table ``[max_slots, prefill_chunk]``, and one mixed
prefill/decode step per tick.  Hand the engine the model (``Llama`` or
``MoeLlama``, whose step routes through ``dropfree_moe_fn``), it serves:

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import serve
    hvd.init()
    engine = serve.ServeEngine(model, serve.ServeConfig())
    req = engine.submit(prompt_ids, max_new_tokens=64)
    engine.flush()                       # req.out_tokens

Scheduling is the reference's, copied whole (host-pure, no device):
FCFS admit-on-slot-free with all-or-nothing block reservation, a
``max_batch_tokens`` budget with decode slots first, chunked prefill, a
refcounted radix prefix cache with copy-on-write and LRU eviction, an
optional host-RAM spill tier, and prompt-lookup drafts verified greedily.
Given the same requests, the port plans the same ticks, emits the same
tokens and folds the same ``sched_digest`` as the JAX engine.

The tick is pipelined one deep: ``step()`` first harvests the previous
tick (it waits on that tick's CUDA event, recorded after the copy of its
tokens into pinned host memory), then plans and enqueues the next, so the
host schedules while the card computes.  Nothing between plan and launch
reads a device tensor.

Prefill/decode disaggregation (``role="prefill"``/``"decode"``): a
prefill engine hands each finished prefill off as a JSON-safe record
(:meth:`ServeEngine.export_handoff`: the prompt blocks' KV through
:func:`encode_block_payload`, and the first sampled token), a decode engine
imports it straight into decode state (:meth:`ServeEngine.import_prefill`).
:func:`save_servable`/:func:`load_servable` write and read the directory
``python -m horovod_tpu_torch.runner.launch --serve DIR`` serves
(``serve/worker.py``).

SLO telemetry as in the JAX engine: the ``hvd_serve_*`` metrics (TTFT,
TPOT, tokens by phase, prefill chunks, drafts, prefix hits, spills,
imports, handoffs, requests by outcome, queue depth and batch fill), and
per-request NEGOTIATE (queue wait), PREFILL, DECODE, HANDOFF and
SPILL_RELOAD spans on the timeline's ``serve`` lane when one is active.

The engine registers its ``kv_pool`` as the memory plane's KV-pool
provider (``perf/memstats.py``) and ``close`` unregisters it.

A fleet's engines share one pool sharded over their ranks when the
caller hands the engine a plan (``pool=``, :func:`serve.pool.fleet_pool_plan`
for the fleet; ``launch --serve`` does it): ``cache_shardings``' rule puts
kv heads over a ``tp`` axis and blocks over the fleet's ranks, each rank
allocates its shard, and the step, copy-on-write, spill and handoff run
over the pool's own process groups (``serve/pool.py``).  ``kv_pool()``
then reports this rank's bytes beside the plan.

Departure: with no plan an engine holds the whole pool, where the JAX
engine always shards over the mesh it is given.  A port rank's engine may
run collectives only where its ranks are in lockstep, as a fleet's are
over the plan stream; the scenario harness (``scenario/harness.py``) and
an engine built in process are not, so they keep the whole pool.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import json
import os
import sys
import time
import weakref
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from .. import runtime as _rt
from ..models import llama as _llama
from ..utils import metrics as M
from ..models import moe_llama as _moe
from .config import ServeConfig
from .pool import PoolPlan


# ------------------------------------------------------------ block pool
class BlockAllocator:
    """Refcounted free-list over the paged cache pool.  LIFO reuse: the
    blocks a finished request frees are the first ones the next request
    gets — deterministic across ranks and trivially observable in tests
    (paged-cache block reuse).

    With prefix sharing (PrefixCache) one block can back several
    sequences plus the cache itself: ``alloc`` hands blocks out at
    refcount 1, ``incref`` adds an owner, ``free`` releases one owner —
    a block returns to the free list only when its LAST owner lets go."""

    def __init__(self, num_blocks: int):
        self.num_blocks = int(num_blocks)
        self._free: List[int] = list(range(self.num_blocks - 1, -1, -1))
        self._refs: Dict[int, int] = {}

    @property
    def free_count(self) -> int:
        return len(self._free)

    def ref(self, block: int) -> int:
        return self._refs.get(block, 0)

    def alloc(self, n: int) -> Optional[List[int]]:
        """All-or-nothing: a request that cannot get its worst-case
        block count is not admitted (no mid-flight OOM-evict)."""
        if n > len(self._free):
            return None
        blocks = [self._free.pop() for _ in range(n)]
        for b in blocks:
            self._refs[b] = 1
        return blocks

    def incref(self, blocks: List[int]) -> None:
        for b in blocks:
            self._refs[b] += 1

    def free(self, blocks: List[int]) -> None:
        for b in reversed(blocks):
            left = self._refs[b] = self._refs[b] - 1
            if left == 0:
                del self._refs[b]
                self._free.append(b)

    def used_in(self, b0: int, b1: int) -> int:
        """Live blocks with ids in ``[b0, b1)``: a pool shard's."""
        return sum(1 for b in self._refs if b0 <= b < b1)

    def occupancy(self) -> Dict[str, int]:
        """Pool occupancy for the memory plane (perf/memstats.py;
        docs/memory.md#kv-pool): used/free split plus the blocks more
        than one owner maps (prefix-cache / CoW sharing) — the bytes the
        used count would double-book if summed per sequence."""
        return {
            "num_blocks": self.num_blocks,
            "used_blocks": self.num_blocks - len(self._free),
            "free_blocks": len(self._free),
            "shared_blocks": sum(1 for c in self._refs.values() if c > 1),
        }


# ----------------------------------------------------- radix prefix cache
class _PrefixNode:
    """One radix-tree node = one pool block's worth of cached prompt KV:
    ``tokens`` are the token ids whose KV the block holds (a full block,
    or a partial tail shorter than block_size), children keyed by the
    NEXT block's token tuple.  ``block`` is None while the node's KV
    lives in the host spill tier (HostSpillPool) — the node stays in
    the tree so the prefix stays matchable and reloads on hit."""

    __slots__ = ("tokens", "block", "children", "parent", "stamp")

    def __init__(self, tokens: Tuple[int, ...], block: Optional[int],
                 parent):
        self.tokens = tokens
        self.block = block
        self.children: Dict[Tuple[int, ...], "_PrefixNode"] = {}
        self.parent = parent
        self.stamp = 0


# ------------------------------------------------------- host spill tier
class HostSpillPool:
    """Host-RAM tier behind the device paged pool
    (docs/serving.md#replicated-tier): cold radix-tree blocks —
    allocator refcount exactly 1, i.e. held by nobody but the tree —
    migrate here instead of being dropped at eviction, and reload into
    a fresh device block on the next prefix hit.  Capacity-bounded in
    blocks; when full, the least-recently-touched held block (the
    prefix cache's own deterministic ``stamp`` clock) is dropped for
    good.  Pure host state driven by the request stream (no clock, no
    RNG), so a lockstep fleet spills and reloads identically on every
    rank.

    ``read_block(block) -> payload`` and ``write_block(block, payload)``
    are engine-provided device accessors (host copies of one pool block
    across layers, ``{"k", "v"}`` CPU tensors); the pool itself never
    touches the device."""

    def __init__(self, capacity_blocks: int, read_block, write_block):
        self.capacity = int(capacity_blocks)
        self._read = read_block
        self._write = write_block
        self._held: Dict[int, Any] = {}     # id(node) -> payload
        self._nodes: Dict[int, Any] = {}    # id(node) -> node (for LRU)
        self.spilled_total = 0
        self.reloaded_total = 0
        self.dropped_total = 0
        self.bytes_held = 0

    @property
    def blocks_held(self) -> int:
        return len(self._held)

    def _payload_bytes(self, payload) -> int:
        return sum(int(a.nbytes) for a in payload.values())

    def _drop_coldest(self) -> None:
        victim_key, victim = None, None
        for key in sorted(self._nodes):
            node = self._nodes[key]
            if victim is None or node.stamp < victim.stamp:
                victim_key, victim = key, node
        if victim_key is None:
            return
        payload = self._held.pop(victim_key)
        del self._nodes[victim_key]
        self.bytes_held -= self._payload_bytes(payload)
        self.dropped_total += 1
        # the node's KV is gone for good: unlink it from the tree so
        # match() never offers a prefix nobody can reload
        if victim.parent is not None and not victim.children:
            victim.parent.children.pop(victim.tokens, None)

    def spill(self, node: _PrefixNode) -> bool:
        """Migrate one tree-held block to host RAM.  Returns False when
        capacity is 0 (spill off) — the caller evicts normally."""
        if self.capacity <= 0:
            return False
        while len(self._held) >= self.capacity:
            self._drop_coldest()
        payload = self._read(node.block)
        self._held[id(node)] = payload
        self._nodes[id(node)] = node
        self.bytes_held += self._payload_bytes(payload)
        self.spilled_total += 1
        return True

    def reload(self, node: _PrefixNode, block: int) -> None:
        """Write a held node's KV back into device ``block`` (the
        caller allocated it; the tree takes the ref)."""
        payload = self._held.pop(id(node))
        del self._nodes[id(node)]
        self.bytes_held -= self._payload_bytes(payload)
        self._write(block, payload)
        self.reloaded_total += 1

    def holds(self, node: _PrefixNode) -> bool:
        return id(node) in self._held

    def counters(self) -> Dict[str, Any]:
        return {
            "capacity_blocks": self.capacity,
            "held_blocks": len(self._held),
            "held_bytes": self.bytes_held,
            "spilled_total": self.spilled_total,
            "reloaded_total": self.reloaded_total,
            "dropped_total": self.dropped_total,
        }


class PrefixCache:
    """Radix tree over token-block keys (the automatic-prefix-caching
    discipline on this repo's paged pool): sequences with a common
    prefix map the SAME KV blocks, so repeated prefills of shared system
    prompts / few-shot templates become cache hits.

      * full blocks are shared in place (allocator refcount, zero copy);
      * divergence INSIDE a cached block — including a partial tail —
        is shared copy-on-write: the matcher gets a device-side clone of
        the block (models/llama.py ``copy_blocks``) holding the common
        positions and overwrites its own suffix;
      * when the pool runs dry, admission evicts LRU leaves nobody
        references but the cache (refcount exactly 1).

    Pure host state driven only by the request stream, never by timing —
    every rank replaying the same plan stream computes the identical
    tree, which is what keeps the fleet lockstep (docs/serving.md)."""

    def __init__(self, block_size: int, allocator: BlockAllocator,
                 spill: Optional[HostSpillPool] = None):
        self.block_size = int(block_size)
        self.allocator = allocator
        self.spill = spill
        self.root = _PrefixNode((), -1, None)
        self._clock = 0          # deterministic LRU clock (touch order)
        self.hits = 0            # admissions with a nonzero prefix hit
        self.hit_tokens = 0      # prompt tokens served from cache
        self.blocks_shared = 0   # full blocks mapped instead of computed
        self.cow_copies = 0
        self.evictions = 0

    def _touch(self, node: _PrefixNode) -> None:
        self._clock += 1
        node.stamp = self._clock

    def _reload(self, node: _PrefixNode) -> bool:
        """Bring a spilled node's KV back into a fresh device block (the
        tree takes the ref, exactly like insert()).  The alloc may
        itself evict — eviction never selects spilled nodes, so this
        cannot recurse into the node being reloaded.  But the victim's
        spill can push the node being reloaded out of a full spill
        tier for good; the reload then fails like a miss (the JAX
        engine raises a ``KeyError`` there)."""
        if self.spill is None or not self.spill.holds(node):
            return False
        blocks = self.allocator.alloc(1)
        if blocks is None:
            if self.evict(1) < 1 or not self.spill.holds(node):
                return False
            blocks = self.allocator.alloc(1)
            if blocks is None:
                return False
        self.spill.reload(node, blocks[0])
        node.block = blocks[0]
        M.SERVE_SPILL_RELOADS.inc()
        return True

    def match(self, prompt: List[int]
              ) -> Tuple[List[int], Optional[Tuple[int, int]], int]:
        """Longest cached prefix of ``prompt``, capped at
        ``len(prompt) - 1``: at least one prompt token is always
        recomputed so the admitting tick has logits to sample the first
        output from (a zero-token prefill chunk would wedge).  Returns
        ``(full_blocks, cow, hit_tokens)`` — ``full_blocks`` are shared
        as-is (caller increfs); ``cow`` is ``(src_block, n_valid)`` when
        the tail diverges inside a cached block, and the caller owns a
        device-side copy."""
        bs = self.block_size
        limit = len(prompt) - 1
        node, full, pos = self.root, [], 0
        while limit - pos >= bs:
            child = node.children.get(tuple(prompt[pos:pos + bs]))
            if child is None:
                break
            if child.block is None and not self._reload(child):
                break  # spilled and unreloadable: the match ends here
            self._touch(child)
            full.append(child.block)
            node, pos = child, pos + bs
        # Divergence within a block: best partial overlap among this
        # node's children (sorted scan = deterministic tie-break),
        # shared by copy-on-write.
        want = tuple(prompt[pos:limit])
        best, best_n = None, 0
        for key in sorted(node.children):
            child = node.children[key]
            n = 0
            for a, b in zip(want, child.tokens):
                if a != b:
                    break
                n += 1
            if n > best_n:
                best, best_n = child, n
        cow = None
        if best is not None and best_n >= 1:
            if best.block is None and not self._reload(best):
                return full, None, pos
            self._touch(best)
            cow = (best.block, best_n)
        return full, cow, pos + best_n

    def insert(self, prompt: List[int], blocks: List[int]) -> None:
        """Register a finished prefill: ``blocks`` is the slot's table
        row, whose i-th entry holds the prompt's i-th block of KV.
        Existing nodes win (dedup: a prefix computed twice concurrently
        stays owned by its second request and is freed normally); new
        nodes take one cache ref on their block so eviction — not a
        request finishing — decides their lifetime."""
        bs = self.block_size
        node, pos = self.root, 0
        for i in range(len(prompt) // bs):
            key = tuple(prompt[pos:pos + bs])
            child = node.children.get(key)
            if child is None:
                child = _PrefixNode(key, blocks[i], node)
                node.children[key] = child
                self.allocator.incref([child.block])
                self._touch(child)
            node, pos = child, pos + bs
        tail = tuple(prompt[pos:])
        if tail and tail not in node.children:
            child = _PrefixNode(tail, blocks[len(prompt) // bs], node)
            node.children[tail] = child
            self.allocator.incref([child.block])
            self._touch(child)

    def evict(self, n_blocks: int) -> int:
        """Free up to ``n_blocks`` by dropping least-recently-touched
        leaves only the cache references (allocator refcount exactly 1);
        returns how many were freed.  Interior nodes are never dropped —
        that would orphan reachable children.  With a spill tier
        attached, a victim's KV migrates to host RAM first (the node
        stays in the tree, block None, reloadable on the next hit);
        spilled nodes themselves are never victims — they hold no
        device block."""
        freed = 0
        while freed < n_blocks:
            victim = None
            for node in self._walk(self.root):
                if node is self.root or node.children:
                    continue
                if node.block is None:
                    continue  # already spilled: nothing on device
                if self.allocator.ref(node.block) != 1:
                    continue
                if victim is None or node.stamp < victim.stamp:
                    victim = node
            if victim is None:
                break
            if self.spill is not None and self.spill.spill(victim):
                self.allocator.free([victim.block])
                victim.block = None
                M.SERVE_SPILLS.inc()
            else:
                del victim.parent.children[victim.tokens]
                self.allocator.free([victim.block])
            self.evictions += 1
            freed += 1
        return freed

    def _walk(self, node: _PrefixNode):
        yield node
        for key in sorted(node.children):
            yield from self._walk(node.children[key])

    @property
    def size(self) -> int:
        """Cached blocks currently held by the tree."""
        return sum(1 for _ in self._walk(self.root)) - 1


# --------------------------------------------------------------- request
class Request:
    """One generation request moving waiting -> prefill -> decode ->
    done.  ``ctx_len`` counts tokens written into the cache; ``pos``
    counts prompt tokens consumed."""

    def __init__(self, tokens, max_new_tokens: int,
                 req_id: Optional[str] = None,
                 eos_id: Optional[int] = None):
        self.tokens = [int(t) for t in tokens]
        if not self.tokens:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens={max_new_tokens} invalid")
        self.max_new_tokens = int(max_new_tokens)
        self.req_id = req_id or f"req-{id(self):x}"
        self.eos_id = eos_id
        self.state = "waiting"
        self.out_tokens: List[int] = []
        self.pos = 0        # prompt tokens consumed
        self.ctx_len = 0    # tokens written into the cache
        self.slot: Optional[int] = None
        self.blocks: List[int] = []
        self.draft: List[int] = []      # this tick's speculative tokens
        self._bigram: Dict[Tuple[int, int], int] = {}
        self._indexed = 0   # context positions already in the index
        self.submitted_t = time.perf_counter()
        self.admitted_t: Optional[float] = None
        self.first_token_t: Optional[float] = None
        self.done_t: Optional[float] = None
        self.finish_reason: Optional[str] = None
        # Causal trace context (serve/trace.py): minted by the router at
        # admission, attached at submit, rides the handoff record to the
        # decode side so both fleets' records link on the same rid.
        self.trace: Optional[Dict[str, Any]] = None
        self.handoff_s: float = 0.0  # decode-side measured export->import
        # Prefill-side durations that rode the handoff record (queue_s,
        # prefill_s): perf_counter stamps are process-local.
        self.upstream: Optional[Dict[str, float]] = None

    @property
    def prompt_len(self) -> int:
        return len(self.tokens)

    def ttft(self) -> Optional[float]:
        if self.first_token_t is None:
            return None
        return self.first_token_t - self.submitted_t

    def tpot(self) -> Optional[float]:
        if self.done_t is None or self.first_token_t is None or \
                len(self.out_tokens) < 2:
            return None
        return (self.done_t - self.first_token_t) / \
            (len(self.out_tokens) - 1)

    # ----------------------------------------------------- spec drafting
    def _ctx_tok(self, i: int) -> int:
        n = len(self.tokens)
        return self.tokens[i] if i < n else self.out_tokens[i - n]

    def draft_lookup(self, k: int) -> List[int]:
        """N-gram / prompt-lookup drafting (the draft-model-free leg of
        speculative decoding): find the most recent PRIOR occurrence of
        the context's final bigram and propose up to ``k`` tokens that
        followed it.  The bigram index grows incrementally (O(1) per
        generated token) and deliberately excludes the final bigram
        itself, so a repeating tail still finds its earlier occurrence.
        A pure function of prompt + emitted tokens — deterministic on
        every rank (the lockstep contract)."""
        L = len(self.tokens) + len(self.out_tokens)
        if k < 1 or L < 3:
            return []
        for i in range(max(self._indexed, 1), L - 1):
            self._bigram[(self._ctx_tok(i - 1), self._ctx_tok(i))] = i + 1
        self._indexed = max(self._indexed, L - 1)
        p = self._bigram.get((self._ctx_tok(L - 2), self._ctx_tok(L - 1)))
        if p is None:
            return []
        return [self._ctx_tok(p + j) for j in range(min(k, L - p))]


# ------------------------------------------------------------- scheduler
class Scheduler:
    """Deterministic slot-table scheduler (pure host state, no device) —
    unit-testable without a model.  ``plan()`` returns this tick's
    (slot, request, n_tokens) work list and performs admissions;
    ``finish()`` evicts.

    ``role`` is the prefill/decode disaggregation split
    (docs/serving.md#replicated-tier): a ``mixed`` scheduler (the
    default, byte-for-byte the pre-split engine) runs both phases; a
    ``prefill`` scheduler admits from the waiting queue but its engine
    hands finished prefills off instead of decoding them; a ``decode``
    scheduler admits ONLY imported handoffs (``queue_import``) — its
    waiting queue is never drained, so a stray submit cannot double-run
    a prompt both sides of the split."""

    ROLES = ("mixed", "prefill", "decode")

    def __init__(self, cfg: ServeConfig, role: str = "mixed"):
        if role not in self.ROLES:
            raise ValueError(f"scheduler role {role!r} invalid; expected "
                             f"one of {self.ROLES}")
        self.cfg = cfg
        self.role = role
        self.slots: List[Optional[Request]] = [None] * cfg.max_slots
        self.waiting: "collections.deque[Request]" = collections.deque()
        self.allocator = BlockAllocator(cfg.cache_blocks)
        self.prefix = (PrefixCache(cfg.block_size, self.allocator)
                       if cfg.prefix_cache else None)
        self.block_tables = -np.ones(
            (cfg.max_slots, cfg.max_blocks_per_seq), np.int32)
        self.completed = 0
        self.admissions = 0
        self.imports = 0
        # CoW copies the NEXT dispatch must run before its writes:
        # (src_block, dst_block) pairs, at most one per admission.
        self.pending_copies: List[Tuple[int, int]] = []
        # Disaggregation intake: handoffs waiting for a slot, the
        # device-block writes the next dispatch must apply before its
        # step reads the cache, and the emissions (the prefill rank's
        # first token) the next report must carry.
        self.import_queue: "collections.deque" = collections.deque()
        self.pending_writes: List[Tuple[int, Any]] = []
        self.import_emits: List[Tuple[Request, List[int]]] = []

    # ------------------------------------------------------------ intake
    def submit(self, req: Request) -> Request:
        if req.prompt_len + req.max_new_tokens > self.cfg.max_seq_len:
            raise ValueError(
                f"request {req.req_id}: prompt {req.prompt_len} + "
                f"max_new {req.max_new_tokens} exceeds "
                f"HOROVOD_SERVE_MAX_SEQ_LEN={self.cfg.max_seq_len}")
        self.waiting.append(req)
        return req

    @property
    def queue_depth(self) -> int:
        return len(self.waiting)

    @property
    def active(self) -> int:
        return sum(1 for s in self.slots if s is not None)

    def has_work(self) -> bool:
        return self.active > 0 or bool(self.waiting) or \
            bool(self.import_queue)

    # -------------------------------------------------------------- plan
    def plan(self) -> List[Tuple[int, Request, int]]:
        """One tick's work under the token budget: decode slots first
        (1 token + up to spec_k verified drafts each, latency-critical),
        prefill continuations next, FCFS admissions into the remainder.
        Deterministic given state."""
        budget = self.cfg.max_batch_tokens
        chunk = self.cfg.prefill_chunk
        work: List[Tuple[int, Request, int]] = []
        self._drain_imports()
        for i, req in enumerate(self.slots):
            if req is not None and req.state == "decode" and budget >= 1:
                req.draft = []
                if self.cfg.spec_decode:
                    # Draft length caps: the tick budget (each draft
                    # token costs 1), the verify row width (bonus token
                    # + K drafts per row), and the remaining generation
                    # budget (a draft past max_new could be verified at
                    # RoPE positions the reservation never covered).
                    cap = min(self.cfg.spec_k, budget - 1,
                              self.cfg.prefill_chunk - 1,
                              req.max_new_tokens - len(req.out_tokens) - 1)
                    if cap >= 1:
                        req.draft = req.draft_lookup(cap)
                n = 1 + len(req.draft)
                work.append((i, req, n))
                budget -= n
        for i, req in enumerate(self.slots):
            if req is not None and req.state == "prefill" and budget >= 1:
                n = min(chunk, req.prompt_len - req.pos, budget)
                if n >= 1:
                    work.append((i, req, n))
                    budget -= n
        while self.waiting and budget >= 1 and self.role != "decode":
            free_slots = [i for i, s in enumerate(self.slots) if s is None]
            if not free_slots:
                break
            req = self.waiting[0]
            row = self._admit_blocks(req)
            if row is None:
                break  # FCFS head-of-line: no skip-ahead, deterministic
            self.waiting.popleft()
            self.admissions += 1
            slot = free_slots[0]
            req.slot, req.blocks = slot, row
            req.state = "prefill"
            req.admitted_t = time.perf_counter()
            self.slots[slot] = req
            self.block_tables[slot, :] = -1
            self.block_tables[slot, :len(row)] = row
            # prefix-hit tokens are already resident: prefill resumes at
            # req.pos (match() keeps >= 1 token to compute, so n >= 1)
            n = min(chunk, req.prompt_len - req.pos, budget)
            work.append((slot, req, n))
            budget -= n
        return work

    def _admit_blocks(self, req: Request) -> Optional[List[int]]:
        """One admission's block-table row.  With the prefix cache on,
        the worst-case reservation counts only NEW blocks — prefix-hit
        blocks are already resident (the sharing dividend: without this
        the conservative math would refuse admissible requests).  Shared
        blocks are increfed BEFORE the alloc/evict so eviction can never
        recycle what this admission just matched; a failed alloc undoes
        the increfs and leaves the request queued (all-or-nothing)."""
        need = -(-(req.prompt_len + req.max_new_tokens)
                 // self.cfg.block_size)
        if self.prefix is None:
            return self.allocator.alloc(need)
        shared, cow, hit = self.prefix.match(req.tokens)
        self.allocator.incref(shared)
        need_new = need - len(shared)
        blocks = self.allocator.alloc(need_new)
        if blocks is None:
            short = need_new - self.allocator.free_count
            if self.prefix.evict(short) >= short:
                blocks = self.allocator.alloc(need_new)
        if blocks is None:
            self.allocator.free(shared)  # undo: tree refs keep them alive
            return None
        if cow is not None:
            # Divergence inside a cached block: clone it on device into
            # this request's first new block, then overwrite the suffix.
            # The source needs no extra ref: the copy runs at the START
            # of the next dispatch, and any later reuse of the source
            # block writes in the SAME step after the copy's gather
            # (functional semantics) or in a later, device-ordered one.
            src, cow_tokens = cow
            self.pending_copies.append((src, blocks[0]))
            hit = len(shared) * self.cfg.block_size + cow_tokens
            self.prefix.cow_copies += 1
        if hit:
            self.prefix.hits += 1
            self.prefix.hit_tokens += hit
            self.prefix.blocks_shared += len(shared)
            M.SERVE_PREFIX_HITS.inc()
            if shared:
                M.SERVE_PREFIX_BLOCKS_SHARED.inc(len(shared))
        req.pos = req.ctx_len = hit
        return shared + blocks

    def take_copies(self) -> List[Tuple[int, int]]:
        copies, self.pending_copies = self.pending_copies, []
        return copies

    # ----------------------------------------------- disaggregated intake
    def queue_import(self, req: Request, payloads: List[Any],
                     first_token: int) -> None:
        """Decode-side intake of one prefill-rank handoff: the request,
        its prompt blocks' KV payloads (host ``{"k", "v"}`` dicts, one
        per full-or-partial prompt block), and the first output token
        the prefill rank already sampled.  Queued FCFS; ``plan()``
        installs it the tick a slot and blocks free up."""
        self.import_queue.append((req, payloads, int(first_token)))

    def _drain_imports(self) -> None:
        """Install queued handoffs straight into decode state: allocate
        the full worst-case row (prompt + max_new blocks), stage the KV
        payload writes for the next dispatch, emit the prefill rank's
        first token.  FCFS head-of-line like admission — an uninstallable
        handoff blocks the ones behind it (deterministic)."""
        while self.import_queue:
            free_slots = [i for i, s in enumerate(self.slots) if s is None]
            if not free_slots:
                break
            req, payloads, first = self.import_queue[0]
            need = -(-(req.prompt_len + req.max_new_tokens)
                     // self.cfg.block_size)
            blocks = self.allocator.alloc(need)
            if blocks is None and self.prefix is not None:
                short = need - self.allocator.free_count
                if self.prefix.evict(short) >= short:
                    blocks = self.allocator.alloc(need)
            if blocks is None:
                break
            self.import_queue.popleft()
            slot = free_slots[0]
            req.slot, req.blocks = slot, blocks
            req.state = "decode"
            req.pos = req.prompt_len
            req.ctx_len = req.prompt_len
            req.out_tokens = [first]
            req.admitted_t = time.perf_counter()
            req.first_token_t = req.admitted_t
            self.slots[slot] = req
            self.block_tables[slot, :] = -1
            self.block_tables[slot, :need] = blocks
            self.admissions += 1
            self.imports += 1
            self.import_emits.append((req, [first]))
            if (req.eos_id is not None and first == req.eos_id) or \
                    req.max_new_tokens <= 1:
                reason = ("eos" if req.eos_id is not None
                          and first == req.eos_id else "completed")
                self.finish(req, reason)
                continue  # done on arrival: no KV writes needed
            for b, payload in zip(blocks, payloads):
                self.pending_writes.append((b, payload))
            if self.prefix is not None:
                self.prefix.insert(req.tokens, blocks)

    def take_pending_writes(self) -> List[Tuple[int, Any]]:
        writes, self.pending_writes = self.pending_writes, []
        return writes

    def take_import_emits(self) -> List[Tuple[Request, List[int]]]:
        emits, self.import_emits = self.import_emits, []
        return emits

    def register_prefix(self, req: Request) -> None:
        """Engine callback at prefill completion: the slot's prompt
        blocks now hold fully-computed KV and become shareable."""
        if self.prefix is not None and req.slot is not None:
            self.prefix.insert(req.tokens, req.blocks)

    # ------------------------------------------------------------- evict
    def finish(self, req: Request, reason: str) -> None:
        req.state = "done"
        req.finish_reason = reason
        req.done_t = time.perf_counter()
        if req.slot is not None:
            self.block_tables[req.slot, :] = -1
            self.slots[req.slot] = None
        self.allocator.free(req.blocks)
        req.blocks = []
        req.slot = None
        self.completed += 1


# --------------------------------------------------- block payload codec
_DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
                torch.float16: "float16"}
_NAME_DTYPES = {v: k for k, v in _DTYPE_NAMES.items()}


def encode_block_payload(payload: Dict[str, torch.Tensor]
                         ) -> Dict[str, Any]:
    """One pool block's KV (``_read_block``'s ``{"k", "v"}`` of ``[L, bs,
    kv_heads, hd]``) as the JAX codec's JSON-safe record: dtype name,
    shape and the raw bytes as hex.  bf16 is named ``"bfloat16"`` (the
    JAX record's ml_dtypes name) over its raw 2-byte words, so a JAX
    handoff and a port handoff of the same KV are equal as JSON."""
    out: Dict[str, Any] = {}
    for k, t in payload.items():
        t = t.detach().to("cpu").contiguous()
        out[k] = {"dtype": _DTYPE_NAMES[t.dtype], "shape": list(t.shape),
                  "hex": t.view(torch.uint8).numpy().tobytes().hex()}
    return out


def decode_block_payload(enc: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`encode_block_payload`, for the JAX codec's
    records too: CPU tensors of the named dtype."""
    out = {}
    for k, v in enc.items():
        raw = bytearray(bytes.fromhex(v["hex"]))
        t = torch.frombuffer(raw, dtype=torch.uint8) if raw else \
            torch.empty(0, dtype=torch.uint8)
        out[k] = t.view(_NAME_DTYPES[v["dtype"]]).reshape(v["shape"])
    return out


# ---------------------------------------------------------------- engine
def _normalize(device: torch.device) -> torch.device:
    """``cuda`` -> ``cuda:<current>``: the device a tensor made there has."""
    return torch.empty(0, device=device).device


def _model_module(model):
    """The module whose ``init_cache``/``copy_blocks`` serve ``model``: the
    port's counterpart of the JAX engine's model-module argument."""
    if isinstance(model, _moe.MoeLlama):
        model.require_all_experts()
        return _moe
    if isinstance(model, _llama.Llama):
        return _llama
    raise TypeError(f"ServeEngine serves Llama or MoeLlama, not "
                    f"{type(model).__name__}")


class ServeEngine:
    """The continuous-batching engine: the host scheduler and one mixed
    prefill/decode step over the paged pool.

    ``model`` is the port's ``Llama`` or ``MoeLlama`` holding every
    expert (its weights already on the device).  ``role`` is the
    disaggregation split (:class:`Scheduler`).  The pool and the step live
    on ``device``: the one given, else the runtime's (``hvd.init()``),
    else the current CUDA device.  With no CUDA device and no
    ``device="cpu"`` construction raises.  ``pool`` is this rank's
    :class:`serve.pool.PoolPlan` (the port's counterpart of the JAX
    ``mesh=``): the engine holds its shard of the pool and every rank of
    the plan's groups must step in lockstep; with none, or a plan that
    does not shard, it holds the whole pool.
    """

    def __init__(self, model, cfg: ServeConfig, role: str = "mixed",
                 device: Union[str, torch.device, None] = None,
                 pool: Optional[PoolPlan] = None):
        self._mod = _model_module(model)
        cfg.validate(model_max_seq=model.cfg.max_seq)
        if pool is not None:
            if (pool.num_blocks, pool.n_kv_heads) != (
                    cfg.cache_blocks, model.cfg.n_kv_heads):
                raise ValueError(
                    f"the pool plan is for {pool.num_blocks} blocks and "
                    f"{pool.n_kv_heads} kv heads; the engine has "
                    f"{cfg.cache_blocks} blocks and {model.cfg.n_kv_heads}")
            pool.check_groups()
        self.pool = pool if pool is not None and pool.sharded else None
        self.device = _normalize(_rt.resolve_device(device))
        weights = model.embed.table.device
        if _normalize(weights) != self.device:
            raise ValueError(f"the model's weights are on {weights}, the "
                             f"engine serves on {self.device}")
        self.model = model
        self.cfg = cfg
        self.scheduler = Scheduler(cfg, role=role)
        self.cache = self._mod.init_cache(model.cfg, cfg.cache_blocks,
                                          cfg.block_size, device=self.device,
                                          plan=self.pool)
        self._moe_fn = (_moe.dropfree_moe_fn(model.cfg)
                        if self._mod is _moe else None)
        self._handoffs = 0
        self._spill: Optional[HostSpillPool] = None
        if cfg.spill_blocks > 0 and self.scheduler.prefix is not None:
            self._spill = HostSpillPool(cfg.spill_blocks, self._read_block,
                                        self._write_block)
            self.scheduler.prefix.spill = self._spill
        # Host staging of one tick, pinned on a CUDA device so both copies
        # are asynchronous: the plan (block tables, lengths, n_new,
        # tokens, CoW pairs) in one int32 buffer, and the sampled tokens.
        # At most one tick is in flight, and step() harvests it before it
        # plans the next, so one buffer of each is enough.
        S, C = cfg.max_slots, cfg.prefill_chunk
        pin = self.device.type == "cuda"
        mb = cfg.max_blocks_per_seq
        self._sizes = (S * mb, S, S, S * C, S, S)
        self._plan_host = torch.zeros(sum(self._sizes), dtype=torch.int32,
                                      pin_memory=pin)
        self._tokens_host = torch.zeros((S, C), dtype=torch.int32,
                                        pin_memory=pin)
        self._inflight: "collections.deque" = collections.deque()
        self.tick = 0
        self._tokens_prefill = 0
        self._tokens_decode = 0
        self._last_fill = 0.0
        self._prefill_chunks = 0
        self._spec_drafted = 0
        self._spec_accepted = 0
        # Rolling digest of every dispatch's scheduling decisions: equal
        # to the JAX engine's for the same request stream.
        self.sched_digest = ""
        # this rank's blocks users can hold; the trash block is not counted
        self._pool_bytes = sum(t[:, :-1].numel() * t.element_size()
                               for t in self.cache.values())
        self._peak_live = 0  # this rank's most live blocks at a dispatch
        self._cross_copies = 0  # CoW pairs whose blocks have two owners
        # the memory plane's kv_pool and kv_spill planes read kv_pool(),
        # through a weak reference: the provider must not keep a dropped
        # engine's pool on the card
        from ..perf.memstats import set_kv_pool_provider
        ref = weakref.WeakMethod(self.kv_pool)

        def provider():
            kv_pool = ref()
            return None if kv_pool is None else kv_pool()
        self._kv_provider = provider
        set_kv_pool_provider(provider)

    # ------------------------------------------------------------ intake
    def submit(self, tokens, max_new_tokens: int,
               req_id: Optional[str] = None,
               eos_id: Optional[int] = None,
               trace: Optional[Dict[str, Any]] = None) -> Request:
        req = Request(tokens, max_new_tokens, req_id=req_id,
                      eos_id=eos_id if eos_id is not None
                      else self.cfg.eos_id)
        req.trace = trace
        return self.scheduler.submit(req)

    def has_work(self) -> bool:
        return self.scheduler.has_work() or bool(self._inflight)

    # ---------------------------------------------------- block transfer
    def _read_block(self, block: int) -> Dict[str, torch.Tensor]:
        """One pool block across all layers as host tensors ``{"k", "v"}``
        of ``[L, bs, kv_heads, hd]`` (the spill tier's read side, the
        handoff's export).  On a sharded pool a group operation: the
        spill tier evicts while planning and the handoff exports while
        harvesting, both on every rank of the fleet at the same tick."""
        if self.pool is not None:
            return self.pool.read_block(self.cache, block)
        return {name: pool[:, block].to("cpu", copy=True)
                for name, pool in self.cache.items()}

    def _write_block(self, block: int,
                     payload: Dict[str, torch.Tensor]) -> None:
        """Write one block's host payload into the pool (spill reload,
        handoff import; on a sharded pool the owner writes its heads);
        stream-ordered before the next step reads it."""
        if self.pool is not None:
            self.pool.write_block(self.cache, block, payload)
            return
        for name, pool in self.cache.items():
            pool[:, block].copy_(payload[name])

    # ------------------------------------------------------ disaggregation
    def export_handoff(self, req: Request, first_token: int
                       ) -> Dict[str, Any]:
        """Serialize one finished prefill for a decode engine: the
        request's identity and budget, the first sampled token, and the
        prompt blocks' KV as encoded payloads (the JAX record).  A pure
        read: the caller decides when to finish the request."""
        n_blocks = -(-req.prompt_len // self.cfg.block_size)
        return {
            "req_id": req.req_id,
            "tokens": list(req.tokens),
            "max_new_tokens": req.max_new_tokens,
            "eos_id": req.eos_id,
            "first_token": int(first_token),
            "trace": req.trace,
            "queue_s": (req.admitted_t - req.submitted_t
                        if req.admitted_t is not None else None),
            "prefill_s": (time.perf_counter() - req.admitted_t
                          if req.admitted_t is not None else None),
            # wall clock, not perf_counter: the stamps cross processes
            "exported_t": time.time(),
            "blocks": [encode_block_payload(self._read_block(b))
                       for b in req.blocks[:n_blocks]],
        }

    def import_prefill(self, handoff: Dict[str, Any]) -> Request:
        """Decode-side intake of a prefill engine's handoff record: queue
        it for installation (``Scheduler._drain_imports``); the request
        enters the slot table in decode state with its prompt KV written
        from the payload, skipping prefill; counted, with a HANDOFF span
        of the record's transit."""
        req = Request(handoff["tokens"], int(handoff["max_new_tokens"]),
                      req_id=handoff.get("req_id"),
                      eos_id=(handoff.get("eos_id")
                              if handoff.get("eos_id") is not None
                              else self.cfg.eos_id))
        req.trace = handoff.get("trace")
        req.upstream = {k: float(handoff[k])
                        for k in ("queue_s", "prefill_s")
                        if handoff.get(k) is not None} or None
        exported_t = handoff.get("exported_t")
        if exported_t is not None:
            req.handoff_s = max(0.0, time.time() - float(exported_t))
        payloads = [decode_block_payload(p) for p in handoff["blocks"]]
        self.scheduler.queue_import(req, payloads,
                                    int(handoff["first_token"]))
        M.SERVE_IMPORTS.inc()
        self._span("HANDOFF", req, req.handoff_s,
                   end_t=time.perf_counter(),
                   extra={"blocks": len(handoff["blocks"])})
        return req

    def prefix_fps(self) -> Tuple[List[str], str]:
        """This engine's radix-tree advertisement for the replica router:
        (fingerprints, digest), which rank 0 piggybacks on the stats
        publish (serve/replica.py)."""
        from .replica import fold_digest, prefix_fingerprints
        if self.scheduler.prefix is None:
            return [], fold_digest([])
        fps = prefix_fingerprints(self.scheduler.prefix)
        return fps, fold_digest(fps)

    # -------------------------------------------------------------- tick
    def step(self) -> Dict[str, Any]:
        """Run one engine tick.  Returns the COMPLETED tick's report (one
        tick of pipeline lag): {"tick", "processed", "emitted": {req_id:
        [new tokens]}, "finished": [Request], "handoff": [records]}, an
        idle report when nothing completed."""
        report = self._harvest()
        self._dispatch()
        # Handoff installs surface their first token (sampled by the
        # prefill engine) in this report: the emission order a mixed
        # engine would have produced at prefill completion.
        for req, toks in self.scheduler.take_import_emits():
            report["emitted"].setdefault(req.req_id, []).extend(toks)
            if req.state == "done":
                report["finished"].append(req)
        M.SERVE_QUEUE_DEPTH.set(self.scheduler.queue_depth)
        M.SERVE_BATCH_FILL.set(self._last_fill)
        return report

    def flush(self) -> List[Dict[str, Any]]:
        """Drain until idle (no planned work, nothing in flight)."""
        out = []
        while self.has_work():
            out.append(self.step())
        return out

    def _dispatch(self) -> None:
        spill = self._spill
        reloads0 = spill.reloaded_total if spill is not None else 0
        work = self.scheduler.plan()
        # handoff imports staged by the plan land in the pool before this
        # tick's step reads it (stream-ordered copies)
        for b, payload in self.scheduler.take_pending_writes():
            self._write_block(b, payload)
        for slot, req, n in work:
            if req.admitted_t is not None and not req.pos and \
                    req.state == "prefill" and req.ctx_len == 0:
                # queue-wait span, emitted once at admission
                self._span("NEGOTIATE", req,
                           req.admitted_t - req.submitted_t,
                           end_t=req.admitted_t)
        if spill is not None and spill.reloaded_total > reloads0:
            for slot, req, n in work:
                if req.state == "prefill":
                    self._span("SPILL_RELOAD", req, 0.0,
                               end_t=time.perf_counter(),
                               extra={"reloads": spill.reloaded_total
                                      - reloads0})
                    break
        if not work:
            return
        cfg = self.cfg
        S, C = cfg.max_slots, cfg.prefill_chunk
        bt, lengths, n_new, tokens, copy_src, copy_dst = np.split(
            self._plan_host.numpy(), np.cumsum(self._sizes)[:-1])
        tokens = tokens.reshape(S, C)
        bt[:] = self.scheduler.block_tables.reshape(-1)
        tokens[:] = 0
        lengths[:] = 0
        n_new[:] = 0
        for slot, req, n in work:
            if req.state == "prefill":
                tokens[slot, :n] = req.tokens[req.pos:req.pos + n]
            else:
                # speculative verify row: the last emitted token plus the
                # drafts (n == 1 + len(draft))
                tokens[slot, :n] = [req.out_tokens[-1]] + req.draft
            lengths[slot] = req.ctx_len
            n_new[slot] = n
        copies = self.scheduler.take_copies()
        cross = False
        if self.pool is not None:
            plan = self.pool
            n_cross = sum(plan.owner(a) != plan.owner(b) for a, b in copies)
            self._cross_copies += n_cross
            cross = n_cross > 0
            self._peak_live = max(self._peak_live,
                                  self.scheduler.allocator.used_in(
                                      *plan.blocks))
        copy_src[:] = 0
        copy_dst[:] = cfg.cache_blocks  # padding: the trash block
        for j, (src, dst) in enumerate(copies):
            copy_src[j], copy_dst[j] = src, dst
        self._fold_sched(work, copies)
        used = int(n_new.sum())
        dev = self._plan_host.to(self.device, non_blocking=True)
        d_bt, d_len, d_new, d_tok, d_src, d_dst = dev.split(self._sizes)
        self._tokens_host.copy_(
            self._step(d_bt.view(S, -1), d_len, d_new, d_tok.view(S, C),
                       d_src, d_dst, cross), non_blocking=True)
        done = None
        if self.device.type == "cuda":
            done = torch.cuda.Event()
            done.record()
        self._last_fill = used / cfg.max_batch_tokens
        self._inflight.append((self.tick, work, done, used))
        self.tick += 1

    def _step(self, block_tables, lengths, n_new, tokens, copy_src,
              copy_dst, cross: bool = False) -> torch.Tensor:
        """The device step: CoW clones before this tick's writes (the
        gather reads the pool as it was, so a source block recycled in
        this tick still copies its old content; ``cross``: a pair's
        source and destination have different owners), the forward over
        the pool, and greedy sampling in fp32 at every chunk position: row
        ``[s, j]`` is the greedy continuation after tokens ``[s, :j+1]``,
        which prefill reads at its last valid position and speculative
        decode verifies its drafts against.  argmax takes the first
        maximum, as the JAX engine's does."""
        if self.pool is not None:
            self.pool.copy_blocks(self.cache, copy_src, copy_dst, cross)
        else:
            self._mod.copy_blocks(self.cache, copy_src, copy_dst)
        if self._moe_fn is not None:
            logits = self.model.apply_cached(tokens, self.cache, block_tables,
                                             lengths, n_new,
                                             moe_fn=self._moe_fn,
                                             pool=self.pool)[0]
        else:
            logits = self.model.apply_cached(tokens, self.cache,
                                             block_tables, lengths, n_new,
                                             pool=self.pool)
        return logits.float().argmax(-1).to(torch.int32)

    def _fold_sched(self, work, copies) -> None:
        """Fold one dispatch's scheduling decisions into the rolling
        digest: slot/request/phase/width, the admission-resume positions
        (prefix hits), the draft tokens and the CoW copy pairs."""
        summary = [(slot, req.req_id, req.state, n,
                    req.pos if req.state == "prefill" else req.ctx_len,
                    [] if req.state == "prefill" else list(req.draft))
                   for slot, req, n in work]
        rec = json.dumps([summary, copies], separators=(",", ":"))
        self.sched_digest = hashlib.sha1(
            (self.sched_digest + rec).encode()).hexdigest()[:16]

    def _harvest(self) -> Dict[str, Any]:
        if not self._inflight:
            return {"tick": None, "processed": 0, "emitted": {},
                    "finished": [], "handoff": []}
        tick, work, done, used = self._inflight.popleft()
        if done is not None:
            done.synchronize()  # the tick's tokens are in host memory
        tokens_host = self._tokens_host.numpy()
        now = time.perf_counter()
        emitted: Dict[str, List[int]] = {}
        finished: List[Request] = []
        handoffs: List[Dict[str, Any]] = []
        for slot, req, n in work:
            decode_row = req.state != "prefill"
            if not decode_row:
                req.pos += n
                req.ctx_len += n
                self._tokens_prefill += n
                self._prefill_chunks += 1
                M.SERVE_TOKENS.inc(n, phase="prefill")
                M.SERVE_PREFILL_CHUNKS.inc()
                if req.pos < req.prompt_len:
                    continue  # still prefilling next tick
                if self.scheduler.role == "prefill":
                    # Disaggregation: this engine's job ends at prefill
                    # completion.  Export the prompt KV and the first
                    # token, keep the prefix warm in this tree, free the
                    # slot; the decode side emits the first token.
                    first = int(tokens_host[slot, n - 1])
                    self.scheduler.register_prefix(req)
                    handoffs.append(self.export_handoff(req, first))
                    self.scheduler.finish(req, "prefill_done")
                    finished.append(req)
                    self._handoffs += 1
                    M.SERVE_HANDOFFS.inc()
                    continue
                req.state = "decode"
                self.scheduler.register_prefix(req)
                new_toks = [int(tokens_host[slot, n - 1])]
            else:
                # Greedy verification: row[j] is the greedy continuation
                # after input positions <= j, so draft[j] is accepted iff
                # it equals the previous greedy token: the output is plain
                # greedy's, only the tokens per tick change.
                row = tokens_host[slot]
                new_toks = [int(row[0])]
                for j, d in enumerate(req.draft):
                    if int(d) != new_toks[-1]:
                        break
                    new_toks.append(int(row[j + 1]))
                accepted = len(new_toks) - 1
                req.ctx_len += 1 + accepted
                if req.draft:
                    self._spec_drafted += len(req.draft)
                    self._spec_accepted += accepted
                    M.SERVE_SPEC_DRAFTED.inc(len(req.draft))
                    if accepted:
                        M.SERVE_SPEC_ACCEPTED.inc(accepted)
            emitted_n = 0
            for tok in new_toks:
                req.out_tokens.append(tok)
                emitted.setdefault(req.req_id, []).append(tok)
                emitted_n += 1
                if req.first_token_t is None:
                    req.first_token_t = now
                    M.SERVE_TTFT.observe(req.ttft())
                    self._span("PREFILL", req, now - req.admitted_t,
                               end_t=now, extra={"prompt": req.prompt_len})
                if (req.eos_id is not None and tok == req.eos_id) or \
                        len(req.out_tokens) >= req.max_new_tokens:
                    reason = ("eos" if req.eos_id is not None
                              and tok == req.eos_id else "completed")
                    self.scheduler.finish(req, reason)
                    finished.append(req)
                    tpot = req.tpot()
                    if tpot is not None:
                        M.SERVE_TPOT.observe(tpot)
                    M.SERVE_REQUESTS.inc(outcome=reason)
                    self._span("DECODE", req,
                               req.done_t - req.first_token_t,
                               end_t=req.done_t,
                               extra={"generated": len(req.out_tokens)})
                    break  # verified-but-post-EOS drafts are discarded
            if decode_row:
                self._tokens_decode += emitted_n
                M.SERVE_TOKENS.inc(emitted_n, phase="decode")
        from .. import postmortem as PM
        PM.record_step(tick)  # engine liveness on the /health plane
        return {"tick": tick, "processed": used, "emitted": emitted,
                "finished": finished, "handoff": handoffs}

    # ------------------------------------------------------------- spans
    def _span(self, phase: str, req: Request, duration_s: float,
              end_t: float, extra: Optional[dict] = None) -> None:
        """Per-request phase span on the timeline's 'serve' lane
        (``utils/timeline.record_span``), ending at ``end_t``
        (``time.perf_counter``); no-op without an active timeline."""
        if not _rt.is_initialized():
            return
        tl = _rt.get().timeline
        if tl is None:
            return
        from . import trace as _trace
        args = _trace.span_args(getattr(req, "trace", None), phase,
                                rid=req.req_id, req=req.req_id)
        if extra:
            args.update(extra)
        dur_us = max(duration_s, 0.0) * 1e6
        lag_us = (time.perf_counter() - end_t) * 1e6
        tl.record_span("serve", phase, dur_us, args=args,
                       ts_us=tl.now_us() - lag_us - dur_us)

    # -------------------------------------------------------------- view
    def kv_pool(self) -> Dict[str, Any]:
        """KV-pool occupancy: the allocator's used/free/shared split (over
        every block id of the fleet's pool), ``pool_bytes`` (this rank's
        blocks users can hold, resident whether used or not),
        ``block_bytes`` and ``used_bytes`` (this rank's), ``fragmentation``
        (1 - tokens written / tokens reserved over active requests) and
        ``eviction_pressure`` (prefix-cache evictions per admission).  On
        a sharded pool, ``shard`` is the plan with this rank's live blocks
        now and at their peak over the dispatches, and the copy-on-write
        pairs that crossed owners."""
        s = self.scheduler
        occ = s.allocator.occupancy()
        plan = self.pool
        local = plan.blocks[1] - plan.blocks[0] if plan is not None \
            else occ["num_blocks"]
        block_bytes = self._pool_bytes // max(local, 1)
        used = (s.allocator.used_in(*plan.blocks) if plan is not None
                else occ["used_blocks"])
        reserved_tokens = written_tokens = 0
        for req in s.slots:
            if req is not None:
                reserved_tokens += len(req.blocks) * self.cfg.block_size
                written_tokens += req.ctx_len
        frag = (1.0 - written_tokens / reserved_tokens
                if reserved_tokens else 0.0)
        evictions = s.prefix.evictions if s.prefix is not None else 0
        occ.update({
            "block_size": self.cfg.block_size,
            "block_bytes": block_bytes,
            "pool_bytes": self._pool_bytes,
            "used_bytes": used * block_bytes,
            "fragmentation": round(frag, 4),
            "evictions": evictions,
            "eviction_pressure": (round(evictions / s.admissions, 4)
                                  if s.admissions else 0.0),
        })
        if plan is not None:
            occ["shard"] = dict(plan.describe(), used_blocks=used,
                                peak_used_blocks=max(self._peak_live, used),
                                cross_copies=self._cross_copies)
        if self._spill is not None:
            spill = self._spill.counters()
            # the host holds whole blocks, every kv head
            spill["held_bytes_est"] = (self._spill.blocks_held * block_bytes
                                       * (plan.head_shards if plan else 1))
            occ["spill"] = spill
        return occ

    def close(self) -> None:
        """Release the device pool and the staging buffers, and unregister
        the memory plane's KV-pool provider (a closed engine must not keep
        reporting its pool); the engine cannot step after this."""
        from ..perf import memstats
        if memstats._kv_pool_fn is self._kv_provider:
            memstats.set_kv_pool_provider(None)
        self.cache = {}
        self._inflight.clear()
        self._plan_host = self._tokens_host = None

    def stats(self) -> Dict[str, Any]:
        s = self.scheduler
        prefix = s.prefix
        out = {
            "tick": self.tick,
            "role": s.role,
            "active": s.active,
            "waiting": s.queue_depth,
            "completed": s.completed,
            "imports": s.imports,
            "handoffs": self._handoffs,
            "free_blocks": s.allocator.free_count,
            "kv_pool": self.kv_pool(),
            "batch_fill": round(self._last_fill, 4),
            "tokens_prefill": self._tokens_prefill,
            "tokens_decode": self._tokens_decode,
            "prefill_chunks": self._prefill_chunks,
            "prefix_cache": {"enabled": prefix is not None},
            "spec": {
                "enabled": bool(self.cfg.spec_decode),
                "drafted_tokens": self._spec_drafted,
                "accepted_tokens": self._spec_accepted,
                "accept_rate": (
                    round(self._spec_accepted / self._spec_drafted, 4)
                    if self._spec_drafted else None),
            },
        }
        if prefix is not None:
            out["prefix_cache"].update({
                "hits": prefix.hits,
                "hit_tokens": prefix.hit_tokens,
                "blocks_shared": prefix.blocks_shared,
                "cached_blocks": prefix.size,
                "cow_copies": prefix.cow_copies,
                "evictions": prefix.evictions,
                "hit_rate": (round(prefix.hits / s.admissions, 4)
                             if s.admissions else None),
            })
        if self._spill is not None:
            out["spill"] = self._spill.counters()
        return out


# ----------------------------------------------------- servable loading
SERVE_MANIFEST = "serve.json"

_MODEL_MODULES = {"llama": _llama, "moe_llama": _moe}


def save_servable(directory: str, model_name: str, config, model,
                  step: int = 0) -> None:
    """Write a servable directory: ``serve.json`` (the model family and
    its config, with the JAX manifest's keys) beside a checkpoint of the
    model's state dict (``checkpoint.py``): what ``launch --serve DIR``
    serves.  As in the JAX function the config's ``dtype`` is not written;
    the checkpoint keeps the tensors' own dtype."""
    from .. import checkpoint as ckpt
    if model_name not in _MODEL_MODULES:
        raise ValueError(f"model {model_name!r} unknown; expected one of "
                         f"{sorted(_MODEL_MODULES)}")
    cfg_dict = {f.name: getattr(config, f.name)
                for f in dataclasses.fields(config) if f.name != "dtype"}
    if ckpt._is_writer():
        os.makedirs(directory, exist_ok=True)
        with open(os.path.join(directory, SERVE_MANIFEST), "w") as f:
            json.dump({"model": model_name, "config": cfg_dict}, f)
    state = model.state_dict() if isinstance(model, torch.nn.Module) \
        else model
    ckpt.save_checkpoint(directory, step, params=state)


def load_servable(directory: str,
                  device: Union[str, torch.device, None] = None):
    """Read a servable directory -> (model module, model config, model on
    ``device``).  ``serve.json``: {"model": "llama"|"moe_llama",
    "config": <name in CONFIGS or kwarg dict>, "seed": int?}.  The
    weights come from the latest checkpoint under the directory; with no
    checkpoint, a seeded random init serves (smoke mode, labelled on
    stderr as the JAX function labels it).  The model's dtype is a
    ``dtype`` name in the manifest's config dict, else the checkpoint's
    tensors', else the config's own."""
    from .. import checkpoint as ckpt
    with open(os.path.join(directory, SERVE_MANIFEST)) as f:
        manifest = json.load(f)
    name = manifest.get("model", "llama")
    if name not in _MODEL_MODULES:
        raise ValueError(f"serve.json model {name!r} unknown; expected "
                         f"one of {sorted(_MODEL_MODULES)}")
    module = _MODEL_MODULES[name]
    spec = manifest.get("config", "tiny")
    dtype = None
    if isinstance(spec, str):
        model_cfg = module.CONFIGS[spec]
    else:
        spec = dict(spec)
        named = spec.pop("dtype", None)
        model_cfg = type(module.CONFIGS["tiny"])(**spec)
        if named is not None:
            dtype = _NAME_DTYPES[str(named)]
    dev = _rt.resolve_device(device)
    mgr = ckpt.CheckpointManager(directory, max_to_keep=10_000)
    latest = mgr.latest_step()
    state = mgr.load_item(latest) if latest is not None else None
    if dtype is None and state:
        dtype = next(t.dtype for t in state.values()
                     if t.is_floating_point())
    if dtype is not None:
        model_cfg = dataclasses.replace(model_cfg, dtype=dtype)
    if state is not None:
        model = (module.MoeLlama if module is _moe else module.Llama)(
            model_cfg, dev)
        model.load_state_dict(state)
        return module, model_cfg, model
    seed = int(manifest.get("seed", 0))
    print(f"[hvd.serve] no checkpoint under {directory}; serving "
          f"seed={seed} random-init params (smoke mode)",
          file=sys.stderr, flush=True)
    model = module.init(model_cfg,
                        torch.Generator(device=dev).manual_seed(seed),
                        device=dev)
    return module, model_cfg, model
