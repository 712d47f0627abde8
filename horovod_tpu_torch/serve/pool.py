"""The paged KV pool sharded over the serving fleet's ranks: the port of
the JAX engine's ``cache_shardings`` (``horovod_tpu/serve/engine.py``) and
of what GSPMD does with the pool it places.

The pool ``[L, blocks, bs, kv_heads, hd]`` shards as the JAX rule says:
kv heads over a ``model``/``tp`` axis when one divides ``n_kv_heads``,
blocks over the first other axis that divides ``cache_blocks``.  A fleet
with no layout has one axis, ``hvd``, of its ranks; under
``HOROVOD_LAYOUT`` the axes are ``dp``, ``tp`` and ``pp``
(``parallel/layout.py`` order).  :func:`cache_shardings` is the rule over a
:class:`PoolMesh` and returns this rank's :class:`PoolPlan`;
:func:`fleet_pool_plan` builds the mesh of a fleet (or of each
disaggregated sub-fleet) with the pool's own process groups.

A rank holds ``[L, b1 - b0 + 1, bs, h1 - h0, hd]``: its blocks ``[b0,
b1)``, its kv heads ``[h0, h1)``, and a trash block of its own.  The
engine's scheduler still plans over every block id; each tick, in every
layer:

  * a rank writes only the k/v whose block it owns (every other position
    goes to its trash block);
  * over the block axis, each rank attends over the keys of its own
    blocks and keeps fp32 partials (the row maximum, the sum of
    exponentials, the unnormalised output, :func:`attn_partials`); one
    all-gather over the block group and :func:`merge_partials` give every
    rank the same output;
  * over the head axis, a rank attends with its q heads over its kv
    heads, and the head group all-gathers the outputs before ``wo``.

The weights stay whole on every rank, as ``replicate_global`` keeps them
in the JAX engine, so each rank runs the projections and the attention's
static context in full: sharding shrinks the pool's bytes a card, not the
step's FLOPs.  A rank's pool shard is read and written only through the
plan: copy-on-write clones across owners (:meth:`PoolPlan.copy_blocks`),
block reads for the spill tier and the prefill handoff
(:meth:`PoolPlan.read_block`, a group operation) and block writes
(:meth:`PoolPlan.write_block`, on the owner only).  Every collective runs
on the pool's own groups, in lockstep: the fleet's ranks apply one plan
stream (``serve/worker.py``), so they reach each collective together.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..models.llama import paged_attention, write_paged_kv

Tensor = torch.Tensor

LAYOUT_AXES = ("dp", "tp", "pp")
FLEET_AXIS = "hvd"


@dataclasses.dataclass(frozen=True)
class PoolMesh:
    """The axes a pool may shard over: their names and sizes in mesh
    order, this rank's coordinate (default: the origin), and this rank's
    process group along each axis and the group's global ranks in axis
    order (absent where no group was made)."""
    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]
    coord: Optional[Tuple[int, ...]] = None
    groups: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    members: Mapping[str, Tuple[int, ...]] = dataclasses.field(
        default_factory=dict)


@dataclasses.dataclass(frozen=True)
class PoolPlan:
    """This rank's share of the pool.  ``spec`` is the JAX
    ``PartitionSpec`` of ``[L, blocks, bs, kv_heads, hd]``; ``blocks`` and
    ``heads`` are this rank's half-open ranges of block ids and kv heads;
    ``*_shards`` the size of each axis; ``*_group`` this rank's process
    group along the axis (None where the axis does not shard), and
    ``block_members`` the block group's global ranks in axis order."""
    spec: Tuple[Optional[str], ...]
    num_blocks: int
    n_kv_heads: int
    blocks: Tuple[int, int]
    heads: Tuple[int, int]
    block_shards: int = 1
    head_shards: int = 1
    block_group: Any = None
    head_group: Any = None
    block_members: Tuple[int, ...] = ()

    @property
    def block_axis(self) -> Optional[str]:
        return self.spec[1]

    @property
    def head_axis(self) -> Optional[str]:
        return self.spec[3]

    @property
    def sharded(self) -> bool:
        return self.block_shards > 1 or self.head_shards > 1

    def owner(self, block: int) -> int:
        """The block axis index that holds global block ``block``."""
        return int(block) // (self.num_blocks // self.block_shards)

    def owns(self, block: int) -> bool:
        return self.blocks[0] <= int(block) < self.blocks[1]

    def describe(self) -> Dict[str, Any]:
        """The plan as JSON: what ``kv_pool()`` reports beside the bytes."""
        return {"spec": list(self.spec), "block_axis": self.block_axis,
                "head_axis": self.head_axis, "blocks": list(self.blocks),
                "heads": list(self.heads),
                "block_shards": self.block_shards,
                "head_shards": self.head_shards}

    def check_groups(self) -> None:
        """Raise unless every axis that shards has its process group."""
        for axis, n, group in ((self.block_axis, self.block_shards,
                                self.block_group),
                               (self.head_axis, self.head_shards,
                                self.head_group)):
            if n > 1 and group is None:
                raise ValueError(
                    f"the pool shards over {axis!r} ({n} ranks) but the plan "
                    "has no process group for it (fleet_pool_plan builds "
                    "one)")

    # ------------------------------------------------------------- step
    def attend(self, q: Tensor, k: Tensor, v: Tensor, k_pool: Tensor,
               v_pool: Tensor, block_tables: Tensor, positions: Tensor,
               valid: Tensor) -> Tensor:
        """One layer's decode attention ``[S, C, n_heads, hd]`` over the
        sharded pool (``LlamaLayer._attn_cached``'s ``pool``): q ``[S, C,
        n_heads, hd]`` and the chunk's k/v ``[S, C, n_kv_heads, hd]`` in
        full; ``k_pool``/``v_pool`` this rank's layer of the pool."""
        h0, h1 = self.heads
        if self.head_shards > 1:
            rep = q.shape[2] // k.shape[2]
            q = q[:, :, h0 * rep:h1 * rep]
            k, v = k[:, :, h0:h1], v[:, :, h0:h1]
        if self.block_shards > 1:
            write_paged_kv(k_pool, v_pool, k, v, block_tables, positions,
                           valid, self.blocks)
            m, l, o = attn_partials(q, k_pool, v_pool, block_tables,
                                    positions, self.blocks)
            o = merge_partials(*self._gather_partials(m, l, o)).to(q.dtype)
        else:
            o = paged_attention(q, k, v, k_pool, v_pool, block_tables,
                                positions, valid)
        if self.head_shards > 1:
            parts = _all_gather(o.contiguous(), self.head_shards,
                                self.head_group)
            S, C, H, D = o.shape
            o = parts.permute(1, 2, 0, 3, 4).reshape(S, C, -1, D)
        return o

    def _gather_partials(self, m: Tensor, l: Tensor, o: Tensor):
        """Every block shard's partials, stacked in axis order: one
        all-gather of ``[S, C, H, hd + 2]`` fp32 a rank."""
        packed = torch.cat([o, m[..., None], l[..., None]], -1)
        got = _all_gather(packed.contiguous(), self.block_shards,
                          self.block_group)
        return got[..., -2], got[..., -1], got[..., :-2]

    # ------------------------------------------------------- block moves
    def copy_blocks(self, cache: Dict[str, Tensor], src: Tensor,
                    dst: Tensor, cross: bool) -> None:
        """Copy-on-write clones ``src[i] -> dst[i]`` (global ids; a
        ``dst`` outside ``[0, num_blocks)`` is padding), before the tick's
        writes: every source is read as the pool was.  ``cross`` says
        whether any pair's source and destination have different owners
        (the host knows from the plan, so every rank agrees): then the
        sources' owners supply them to the block group in one all-gather;
        otherwise each rank clones its own blocks."""
        b0, b1 = self.blocks
        trash = cache["k"].shape[1] - 1
        src, dst = src.long(), dst.long()
        ldst = torch.where((dst >= b0) & (dst < b1), dst - b0, trash)
        lsrc = torch.where((src >= b0) & (src < b1), src - b0, 0)
        if not cross:
            for pool in cache.values():
                pool[:, ldst] = pool[:, lsrc]
            return
        names = list(cache)
        mine = torch.stack([cache[n][:, lsrc] for n in names])
        got = _all_gather(mine.contiguous(), self.block_shards,
                          self.block_group)  # [n, 2, L, P, bs, h, hd]
        owner = (src.clamp(0, self.num_blocks - 1)
                 // (self.num_blocks // self.block_shards))
        pairs = torch.arange(src.shape[0], device=src.device)
        sel = got[owner, :, :, pairs]  # [P, 2, L, bs, h, hd]
        for j, n in enumerate(names):
            cache[n][:, ldst] = sel[:, j].transpose(0, 1)

    def read_block(self, cache: Dict[str, Tensor],
                   block: int) -> Dict[str, Tensor]:
        """One block across all layers and kv heads, ``{"k", "v"}`` of
        ``[L, bs, n_kv_heads, hd]`` on the host, on every rank of the
        plan's groups: a group operation (its owner broadcasts over the
        block group, the head group all-gathers its heads), so every rank
        calls it for the same block at the same point."""
        names = list(cache)
        local = int(block) - self.blocks[0] if self.owns(block) else 0
        buf = torch.stack([cache[n][:, local] for n in names]).contiguous()
        if self.block_shards > 1:
            dist.broadcast(buf, src=self.block_members[self.owner(block)],
                           group=self.block_group)
        if self.head_shards > 1:
            parts = _all_gather(buf, self.head_shards, self.head_group)
            buf = torch.cat(list(parts.unbind(0)), dim=3)
        return {n: buf[j].to("cpu", copy=True) for j, n in enumerate(names)}

    def write_block(self, cache: Dict[str, Tensor], block: int,
                    payload: Dict[str, Tensor]) -> None:
        """Write one block's host payload (all kv heads) into the pool, on
        the block's owner only, this rank's heads."""
        if not self.owns(block):
            return
        local = int(block) - self.blocks[0]
        h0, h1 = self.heads
        for n, pool in cache.items():
            pool[:, local].copy_(payload[n][:, :, h0:h1])


def _all_gather(t: Tensor, n: int, group) -> Tensor:
    """``[n, *t.shape]``: every member's ``t`` in the group's rank order."""
    out = torch.empty((n,) + tuple(t.shape), dtype=t.dtype, device=t.device)
    dist.all_gather(list(out.unbind(0)), t, group=group)
    return out


# ------------------------------------------------------------ the rule
def cache_shardings(mesh: PoolMesh, num_blocks: int,
                    n_kv_heads: int) -> PoolPlan:
    """The JAX rule over ``mesh``'s axes: kv heads over a ``model``/``tp``
    axis when one exists and divides ``n_kv_heads``, blocks over the
    first remaining axis that divides ``num_blocks``.  Returns this rank's
    plan: the ``PartitionSpec`` of ``[L, blocks, bs, kv_heads, hd]`` as a
    tuple, and the block and head ranges at ``mesh.coord`` with the
    groups ``mesh`` holds for the two axes."""
    names, shape = tuple(mesh.axis_names), tuple(int(s) for s in mesh.shape)
    size = dict(zip(names, shape))
    head_axis = None
    for a in names:
        if str(a).split(".")[-1] in ("model", "tp") and \
                n_kv_heads % size[a] == 0:
            head_axis = a
            break
    block_axis = None
    for a in names:
        if a != head_axis and num_blocks % size[a] == 0:
            block_axis = a
            break
    coord = dict(zip(names, mesh.coord or (0,) * len(names)))

    def place(axis, total):
        if axis is None:
            return 1, (0, total)
        n, i = size[axis], coord[axis]
        per = total // n
        return n, (i * per, (i + 1) * per)

    nb, blocks = place(block_axis, num_blocks)
    nh, heads = place(head_axis, n_kv_heads)
    groups = mesh.groups
    return PoolPlan(
        spec=(None, block_axis, None, head_axis, None),
        num_blocks=int(num_blocks), n_kv_heads=int(n_kv_heads),
        blocks=blocks, heads=heads, block_shards=nb, head_shards=nh,
        block_group=groups.get(block_axis) if nb > 1 else None,
        head_group=groups.get(head_axis) if nh > 1 else None,
        block_members=(tuple(mesh.members.get(block_axis, ())) if nb > 1
                       else ()))


def fleet_pool_plan(num_blocks: int, n_kv_heads: int,
                    fleets: Optional[Sequence[Sequence[int]]] = None,
                    dims: Optional[Sequence[int]] = None
                    ) -> Optional[PoolPlan]:
    """This rank's plan in its fleet, the pool's process groups made.
    ``fleets`` are the fleets' global ranks (default: one fleet of the
    world; two for disaggregated prefill and decode, each sharding over
    its own ranks); ``dims`` is the (dp, tp, pp) layout, whose axes then
    replace ``hvd``.  Collective over the world: every rank calls it with
    the same arguments, and it makes, fleet by fleet, one group for each
    line of each axis that shards, as ``dist.new_group`` requires.
    Returns None on a rank in no fleet."""
    world, rank = dist.get_world_size(), dist.get_rank()
    fleets = [list(f) for f in (fleets or [range(world)])]
    mine = None
    for members in fleets:
        if dims is not None:
            names, shape = LAYOUT_AXES, tuple(int(d) for d in dims)
        else:
            names, shape = (FLEET_AXIS,), (len(members),)
        if int(np.prod(shape)) != len(members):
            raise ValueError(f"a pool mesh of {dict(zip(names, shape))} does "
                             f"not hold the fleet of ranks {members}")
        rule = cache_shardings(PoolMesh(names, shape), num_blocks,
                               n_kv_heads)
        grid = np.array(members).reshape(shape)
        groups: Dict[str, Any] = {}
        lines: Dict[str, Tuple[int, ...]] = {}
        for axis in (rule.block_axis, rule.head_axis):
            if axis is None:
                continue
            i = names.index(axis)
            if shape[i] == 1:
                continue
            for line in np.moveaxis(grid, i, -1).reshape(
                    -1, shape[i]).tolist():
                group = dist.new_group(line)
                if rank in line:
                    groups[axis], lines[axis] = group, tuple(line)
        if rank in members:
            coord = tuple(int(c) for c in np.unravel_index(
                members.index(rank), shape))
            mine = cache_shardings(PoolMesh(names, shape, coord, groups,
                                            lines), num_blocks, n_kv_heads)
    return mine


# --------------------------------------------------- partials and merge
def attn_partials(q: Tensor, k_pool: Tensor, v_pool: Tensor,
                  block_tables: Tensor, positions: Tensor,
                  blocks: Tuple[int, int]):
    """One shard's attention partials in fp32: q ``[S, C, H, hd]`` over the
    keys of the blocks ``[b0, b1)`` that ``k_pool``/``v_pool`` ``[b1 - b0
    + 1, bs, Hkv, hd]`` hold, each slot's whole static context gathered
    (``block_tables [S, max_blocks]``, global ids; -1 and every block of
    another shard are masked, as is every key past the query's
    position).  Returns ``(m, l, o)``: the row maximum ``[S, C, H]``
    (-inf where the row has no key here), the sum of ``exp(logit - m)``
    and the unnormalised output ``[S, C, H, hd]``; a row with no key has
    ``l = 0`` and ``o = 0``."""
    S, C, H, D = q.shape
    trash, bs, hk = k_pool.shape[0] - 1, k_pool.shape[1], k_pool.shape[2]
    b0, b1 = blocks
    owned = (block_tables >= b0) & (block_tables < b1)
    local = torch.where(owned, block_tables - b0, trash)
    T = block_tables.shape[1] * bs
    k_ctx = k_pool[local].reshape(S, T, hk, D).float()
    v_ctx = v_pool[local].reshape(S, T, hk, D).float()
    key_pos = torch.arange(T, device=q.device)
    keep = (key_pos[None, None, :] <= positions[:, :, None]) \
        & owned.repeat_interleave(bs, dim=1)[:, None, :]  # [S, C, T]
    qg = q.float().reshape(S, C, hk, H // hk, D)
    logits = torch.einsum("sqhrd,skhd->shrqk", qg, k_ctx) / math.sqrt(D)
    logits = logits.masked_fill(~keep[:, None, None], float("-inf"))
    m = logits.amax(-1)
    p = torch.exp(logits - torch.where(torch.isfinite(m), m, 0.0)[..., None])
    l = p.sum(-1)
    o = torch.einsum("shrqk,skhd->sqhrd", p, v_ctx).reshape(S, C, H, D)
    return (m.permute(0, 3, 1, 2).reshape(S, C, H),
            l.permute(0, 3, 1, 2).reshape(S, C, H), o)


def merge_partials(m: Tensor, l: Tensor, o: Tensor) -> Tensor:
    """The attention output ``[S, C, H, hd]`` in fp32 from the shards'
    partials stacked on a leading axis (``m``, ``l`` ``[n, S, C, H]``,
    ``o`` ``[n, S, C, H, hd]``): each shard's sums rescaled to the global
    maximum, summed in shard order, and normalised.  A row with no key in
    any shard is 0, not NaN."""
    top = m.amax(0)
    w = torch.exp(m - torch.where(torch.isfinite(top), top, 0.0)[None])
    denom = (w * l).sum(0)
    out = (w[..., None] * o).sum(0)
    return out / torch.where(denom > 0, denom, 1.0)[..., None]
