"""Continuous-batching inference engine: the port of
``horovod_tpu/serve/engine.py`` (mixed role, one device).

One preallocated paged KV pool (``models/llama.py`` ``init_cache``), a
static-shape slot table ``[max_slots, prefill_chunk]``, and one mixed
prefill/decode step per tick.  Hand the engine the model, it serves:

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

Not here yet: the prefill/decode roles (disaggregation), the fleet
(worker, router, streams, journal, replicas), servable loading, and the
serve metrics and spans.
"""

from __future__ import annotations

import collections
import hashlib
import json
import time
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from .. import runtime as _rt
from ..models import llama as _llama
from .config import ServeConfig


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


# ---------------------------------------------------------------- engine
def _normalize(device: torch.device) -> torch.device:
    """``cuda`` -> ``cuda:<current>``: the device a tensor made there has."""
    return torch.empty(0, device=device).device


class ServeEngine:
    """The continuous-batching engine: the host scheduler and one mixed
    prefill/decode step over the paged pool.

    ``model`` is the port's ``Llama`` (its weights already on the
    device).  The pool and the step live on ``device``: the one given,
    else the runtime's (``hvd.init()``), else the current CUDA device.
    With no CUDA device and no ``device="cpu"`` construction raises.
    """

    def __init__(self, model: "_llama.Llama", cfg: ServeConfig,
                 role: str = "mixed",
                 device: Union[str, torch.device, None] = None):
        if role != "mixed":
            raise NotImplementedError(
                f"serve role {role!r}: prefill/decode disaggregation comes "
                "with the serving-fleet slice; the port serves the mixed "
                "role only")
        cfg.validate(model_max_seq=model.cfg.max_seq)
        self.device = _normalize(_rt.resolve_device(device))
        weights = model.embed.table.device
        if _normalize(weights) != self.device:
            raise ValueError(f"the model's weights are on {weights}, the "
                             f"engine serves on {self.device}")
        self.model = model
        self.cfg = cfg
        self.scheduler = Scheduler(cfg, role=role)
        self.cache = _llama.init_cache(model.cfg, cfg.cache_blocks,
                                       cfg.block_size, device=self.device)
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
        # the blocks users can hold; the trash block is not counted
        self._pool_bytes = sum(
            t[:, :cfg.cache_blocks].numel() * t.element_size()
            for t in self.cache.values())

    # ------------------------------------------------------------ intake
    def submit(self, tokens, max_new_tokens: int,
               req_id: Optional[str] = None,
               eos_id: Optional[int] = None) -> Request:
        req = Request(tokens, max_new_tokens, req_id=req_id,
                      eos_id=eos_id if eos_id is not None
                      else self.cfg.eos_id)
        return self.scheduler.submit(req)

    def has_work(self) -> bool:
        return self.scheduler.has_work() or bool(self._inflight)

    # ---------------------------------------------------- block transfer
    def _read_block(self, block: int) -> Dict[str, torch.Tensor]:
        """One pool block across all layers as host tensors ``{"k", "v"}``
        of ``[L, bs, kv_heads, hd]`` (the spill tier's read side)."""
        return {name: pool[:, block].to("cpu", copy=True)
                for name, pool in self.cache.items()}

    def _write_block(self, block: int,
                     payload: Dict[str, torch.Tensor]) -> None:
        """Write one block's host payload back into the pool (spill
        reload); stream-ordered before the next step reads it."""
        for name, pool in self.cache.items():
            pool[:, block].copy_(payload[name])

    # -------------------------------------------------------------- tick
    def step(self) -> Dict[str, Any]:
        """Run one engine tick.  Returns the COMPLETED tick's report (one
        tick of pipeline lag): {"tick", "processed", "emitted": {req_id:
        [new tokens]}, "finished": [Request]}, an idle report when nothing
        completed."""
        report = self._harvest()
        self._dispatch()
        return report

    def flush(self) -> List[Dict[str, Any]]:
        """Drain until idle (no planned work, nothing in flight)."""
        out = []
        while self.has_work():
            out.append(self.step())
        return out

    def _dispatch(self) -> None:
        work = self.scheduler.plan()
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
                       d_src, d_dst), non_blocking=True)
        done = None
        if self.device.type == "cuda":
            done = torch.cuda.Event()
            done.record()
        self._last_fill = used / cfg.max_batch_tokens
        self._inflight.append((self.tick, work, done, used))
        self.tick += 1

    def _step(self, block_tables, lengths, n_new, tokens, copy_src,
              copy_dst) -> torch.Tensor:
        """The device step: CoW clones before this tick's writes (the
        gather reads the pool as it was, so a source block recycled in
        this tick still copies its old content), the forward over the
        pool, and greedy sampling in fp32 at every chunk position: row
        ``[s, j]`` is the greedy continuation after tokens ``[s, :j+1]``,
        which prefill reads at its last valid position and speculative
        decode verifies its drafts against.  argmax takes the first
        maximum, as the JAX engine's does."""
        _llama.copy_blocks(self.cache, copy_src, copy_dst)
        logits = self.model.apply_cached(tokens, self.cache, block_tables,
                                         lengths, n_new)
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
                    "finished": []}
        tick, work, done, used = self._inflight.popleft()
        if done is not None:
            done.synchronize()  # the tick's tokens are in host memory
        tokens_host = self._tokens_host.numpy()
        now = time.perf_counter()
        emitted: Dict[str, List[int]] = {}
        finished: List[Request] = []
        for slot, req, n in work:
            decode_row = req.state != "prefill"
            if not decode_row:
                req.pos += n
                req.ctx_len += n
                self._tokens_prefill += n
                self._prefill_chunks += 1
                if req.pos < req.prompt_len:
                    continue  # still prefilling next tick
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
            emitted_n = 0
            for tok in new_toks:
                req.out_tokens.append(tok)
                emitted.setdefault(req.req_id, []).append(tok)
                emitted_n += 1
                if req.first_token_t is None:
                    req.first_token_t = now
                if (req.eos_id is not None and tok == req.eos_id) or \
                        len(req.out_tokens) >= req.max_new_tokens:
                    reason = ("eos" if req.eos_id is not None
                              and tok == req.eos_id else "completed")
                    self.scheduler.finish(req, reason)
                    finished.append(req)
                    break  # verified-but-post-EOS drafts are discarded
            if decode_row:
                self._tokens_decode += emitted_n
        return {"tick": tick, "processed": used, "emitted": emitted,
                "finished": finished}

    # -------------------------------------------------------------- view
    def kv_pool(self) -> Dict[str, Any]:
        """KV-pool occupancy: the allocator's used/free/shared split,
        ``pool_bytes`` (the blocks users can hold, resident whether used
        or not), ``fragmentation`` (1 - tokens written / tokens reserved
        over active requests) and ``eviction_pressure`` (prefix-cache
        evictions per admission)."""
        s = self.scheduler
        occ = s.allocator.occupancy()
        nb = max(occ["num_blocks"], 1)
        block_bytes = self._pool_bytes // nb
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
            "used_bytes": occ["used_blocks"] * block_bytes,
            "fragmentation": round(frag, 4),
            "evictions": evictions,
            "eviction_pressure": (round(evictions / s.admissions, 4)
                                  if s.admissions else 0.0),
        })
        if self._spill is not None:
            spill = self._spill.counters()
            spill["held_bytes_est"] = self._spill.blocks_held * block_bytes
            occ["spill"] = spill
        return occ

    def close(self) -> None:
        """Release the device pool and the staging buffers; the engine
        cannot step after this."""
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
            "handoffs": 0,
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
