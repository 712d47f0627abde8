"""The port's serving plane (``horovod_tpu_torch.serve``) against the JAX
package's (``horovod_tpu.serve``): the host scheduler plans the same ticks
on the same request streams, the engine emits the same tokens and folds the
same ``sched_digest`` as the JAX engine on the same weights, and its output
is the port's full-forward greedy in every leg combination."""

import copy
import dataclasses

import numpy as np
import pytest
import torch

import jax

from horovod_tpu.models import llama as JL
from horovod_tpu.serve import engine as JE
from horovod_tpu.serve.config import ServeConfig as JServeConfig
from horovod_tpu_torch.common.knobs import Knobs
from horovod_tpu_torch.models import llama as TL
from horovod_tpu_torch.serve import engine as TE
from horovod_tpu_torch.serve.config import ServeConfig, from_knobs
from horovod_tpu_torch.serve.engine import (BlockAllocator, HostSpillPool,
                                            PrefixCache, Request, Scheduler,
                                            ServeEngine)


def _cfg(**kw):
    base = dict(max_slots=2, block_size=4, cache_blocks=16, max_seq_len=32,
                max_batch_tokens=16, prefill_chunk=8)
    base.update(kw)
    return ServeConfig(**base)


@pytest.fixture(scope="module")
def tiny():
    """The JAX tiny checkpoint (PRNGKey(0)) and the port's model holding
    the same weights."""
    cfg = JL.CONFIGS["tiny"]
    params = JL.init(jax.random.PRNGKey(0), cfg)
    tree = jax.tree_util.tree_map(np.asarray, params)
    return cfg, params, TL.params_from_jax(tree, TL.CONFIGS["tiny"],
                                           device="cpu")


def _greedy(model, prompt, n_new):
    """Greedy continuation through the port's full forward, one token at a
    time: the oracle the engine must match exactly."""
    ids = list(prompt)
    with torch.no_grad():
        for _ in range(n_new):
            logits = model(torch.tensor([ids]))
            ids.append(int(logits[0, -1].float().argmax()))
    return ids[len(prompt):]


def _engine(model, scfg):
    return ServeEngine(model, scfg, device="cpu")


def _serve(engine, prompts, n_new, prefix="r"):
    reqs = [engine.submit(p, n_new, req_id=f"{prefix}{i}")
            for i, p in enumerate(prompts)]
    engine.flush()
    assert all(r.state == "done" for r in reqs)
    return [r.out_tokens for r in reqs]


def _jax_engine(tiny, scfg):
    cfg, params, _ = tiny
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("hvd",))
    jcfg = JServeConfig(**dataclasses.asdict(scfg))
    return JE.ServeEngine(JL, cfg, params, jcfg, mesh=mesh)


def _speed_prompts(vocab):
    """The reference's shared-prefix traffic (tests/test_serve_speed.py):
    a common 9-token prefix, repetitive tails, one pair that diverges
    inside the tail block."""
    rng = np.random.RandomState(5)
    system = rng.randint(0, vocab, 9).tolist()
    return [system + [11, 12, 11, 12], system + [11, 12, 11, 99],
            system + rng.randint(0, vocab, 3).tolist()]


# ------------------------------------------- scheduler against the JAX one
def _fake_next(ctx):
    """A deterministic stand-in for the model's greedy token: repeats often
    enough that prompt-lookup drafts are made and some are accepted."""
    return ctx[-2] if len(ctx) % 4 else (ctx[-1] * 7 + 3) % 50


def _simulate(E, cfg, stream, ticks=80):
    """Drive ``E.Scheduler`` with the engine's harvest rules and a fake
    sampler; returns every tick's plan, CoW copies and pool state.  A spill
    tier gets host stand-ins for the engine's device accessors."""
    s = E.Scheduler(cfg)
    if cfg.spill_blocks:
        s.prefix.spill = E.HostSpillPool(
            cfg.spill_blocks, lambda b: {"k": np.full(2, b)},
            lambda b, payload: None)
    log = []
    for t in range(ticks):
        for at, tokens, n_new, rid, eos in stream:
            if at == t:
                s.submit(E.Request(tokens, n_new, req_id=rid, eos_id=eos))
        work = s.plan()
        log.append(([(slot, r.req_id, r.state, n, r.pos, r.ctx_len,
                      list(r.draft), list(r.blocks)) for slot, r, n in work],
                    s.take_copies(), s.allocator.free_count,
                    s.prefix.size if s.prefix is not None else None,
                    s.block_tables.tolist()))
        for slot, r, n in work:
            if r.state == "prefill":
                r.pos += n
                r.ctx_len += n
                if r.pos < r.prompt_len:
                    continue
                r.state = "decode"
                s.register_prefix(r)
                new = [_fake_next(r.tokens)]
            else:
                ctx = r.tokens + r.out_tokens
                new = [_fake_next(ctx)]
                for d in r.draft:
                    if d != new[-1]:
                        break
                    ctx = ctx + [d]
                    new.append(_fake_next(ctx))
                r.ctx_len += len(new)
            for tok in new:
                r.out_tokens.append(tok)
                if tok == r.eos_id or len(r.out_tokens) >= r.max_new_tokens:
                    s.finish(r, "eos" if tok == r.eos_id else "completed")
                    break
        if not s.has_work() and t > max(a for a, *_ in stream):
            break
    return log


def _stream(seed, n=12, vocab=50):
    rng = np.random.RandomState(seed)
    system = rng.randint(0, vocab, 10).tolist()
    out = []
    for i in range(n):
        tail = rng.randint(0, vocab, rng.randint(1, 14)).tolist()
        tokens = (system + tail) if rng.rand() < 0.6 else tail + tail
        eos = int(rng.randint(0, vocab)) if rng.rand() < 0.3 else None
        out.append((int(rng.randint(0, 10)), tokens,
                    int(rng.randint(1, 9)), f"q{i}", eos))
    return out


@pytest.mark.parametrize("seed,kw", [
    (0, dict()),
    (1, dict(cache_blocks=12, prefill_chunk=5, max_batch_tokens=9)),
    (2, dict(prefix_cache=False, spec_decode=False)),
    (3, dict(max_slots=3, cache_blocks=14, spill_blocks=2, spec_k=2)),
])
def test_scheduler_plans_match_jax(seed, kw):
    """Same request stream, same plans tick by tick: admissions, chunk
    widths, drafts, CoW copies, block tables, free blocks and cached
    blocks (spill runs with host stand-ins for the device accessors)."""
    cfg = _cfg(**kw)
    logs = [_simulate(JE, JServeConfig(**dataclasses.asdict(cfg)),
                      _stream(seed)),
            _simulate(TE, cfg, _stream(seed))]
    assert logs[0] == logs[1]
    flat = [w for tick in logs[1] for w in tick[0]]
    assert any(w[2] == "decode" and w[6] for w in flat) or \
        not cfg.spec_decode


# ---------------------------------- the reference's scheduler unit cases
def test_scheduler_admits_fcfs_within_token_budget():
    s = Scheduler(_cfg(max_slots=3, max_batch_tokens=10, prefill_chunk=8))
    a = s.submit(Request([1] * 12, 4, req_id="a"))
    b = s.submit(Request([2] * 6, 4, req_id="b"))
    assert [(r.req_id, n) for _, r, n in s.plan()] == [("a", 8), ("b", 2)]
    assert a.state == "prefill" and b.state == "prefill"
    assert s.queue_depth == 0 and s.active == 2


def test_scheduler_decode_preempts_prefill_budget():
    s = Scheduler(_cfg(max_slots=2, max_batch_tokens=5, prefill_chunk=4))
    p = s.submit(Request([1] * 12, 4, req_id="p"))
    s.plan()
    p.pos = p.ctx_len = 4
    d = s.submit(Request([2, 3], 4, req_id="d"))
    assert [(r.req_id, n) for _, r, n in s.plan()] == [("p", 4), ("d", 1)]
    p.pos = p.ctx_len = 8
    d.pos = d.ctx_len = 2
    d.state = "decode"
    d.out_tokens = [7]
    plan = s.plan()
    assert (plan[0][1].req_id, plan[0][2]) == ("d", 1)
    assert (plan[1][1].req_id, plan[1][2]) == ("p", 4)


def test_scheduler_admit_on_slot_free_and_evict():
    s = Scheduler(_cfg(max_slots=1, cache_blocks=4, max_seq_len=16))
    a = s.submit(Request([1] * 4, 4, req_id="a"))
    b = s.submit(Request([2] * 4, 4, req_id="b"))
    s.plan()
    assert a.slot == 0 and b.state == "waiting"
    assert s.plan() and b.state == "waiting"
    s.finish(a, "completed")
    assert a.finish_reason == "completed" and a.slot is None
    plan = s.plan()
    assert plan[0][1] is b and b.slot == 0 and s.completed == 1


def test_scheduler_fcfs_head_of_line_blocks():
    s = Scheduler(_cfg(max_slots=2, cache_blocks=4, block_size=4))
    big = s.submit(Request([1] * 20, 12, req_id="big"))
    small = s.submit(Request([2] * 4, 4, req_id="small"))
    assert s.plan() == []
    assert big.state == "waiting" and small.state == "waiting"


def test_scheduler_and_request_validation():
    with pytest.raises(ValueError, match="HOROVOD_SERVE_MAX_SEQ_LEN"):
        Scheduler(_cfg(max_seq_len=16)).submit(Request([1] * 10, 8))
    with pytest.raises(ValueError, match="empty prompt"):
        Request([], 4)
    with pytest.raises(ValueError, match="max_new_tokens"):
        Request([1], 0)
    with pytest.raises(ValueError, match="role"):
        Scheduler(_cfg(), role="both")


def test_block_allocator_lifo_refcounts_all_or_nothing():
    a = BlockAllocator(4)
    first = a.alloc(2)
    assert first == [0, 1] and a.free_count == 2
    assert a.alloc(3) is None and a.free_count == 2
    a.incref(first)
    a.free(first)
    assert a.free_count == 2 and a.ref(0) == 1 and a.ref(1) == 1
    assert a.occupancy()["shared_blocks"] == 0
    a.free(first)
    assert a.free_count == 4 and a.ref(0) == 0
    assert a.alloc(2) == [0, 1]


def test_prefix_cache_full_block_match_and_dedup():
    a = BlockAllocator(8)
    pc = PrefixCache(4, a)
    prompt = list(range(10))
    row = a.alloc(3)
    pc.insert(prompt, row)
    assert pc.size == 3 and all(a.ref(b) == 2 for b in row)
    full, cow, hit = pc.match(prompt)
    assert full == row[:2] and cow == (row[2], 1) and hit == 9
    row2 = a.alloc(3)
    pc.insert(prompt, row2)
    assert pc.size == 3 and all(a.ref(b) == 1 for b in row2)


def test_prefix_cache_cow_on_divergence_within_block():
    a = BlockAllocator(8)
    pc = PrefixCache(4, a)
    row = a.alloc(2)
    pc.insert([1, 2, 3, 4, 5, 6, 7], row)
    full, cow, hit = pc.match([1, 2, 3, 4, 5, 6, 99, 100, 101])
    assert full == [row[0]] and cow == (row[1], 2) and hit == 6
    assert pc.match([9, 9, 9, 9, 9]) == ([], None, 0)


def test_prefix_cache_lru_eviction_skips_referenced_leaves():
    a = BlockAllocator(4)
    pc = PrefixCache(4, a)
    r1, r2 = a.alloc(1), a.alloc(1)
    pc.insert([1, 2, 3, 4], r1)
    pc.insert([5, 6, 7, 8], r2)
    a.free(r1)
    a.free(r2)
    a.incref(r2)
    assert pc.evict(2) == 1
    assert pc.size == 1 and a.ref(r1[0]) == 0 and a.ref(r2[0]) == 2


def test_admission_counts_only_new_blocks():
    s = Scheduler(_cfg(max_slots=2, cache_blocks=4, block_size=4,
                       max_seq_len=16))
    first = s.submit(Request([1] * 8, 4, req_id="first"))
    s.plan()
    first.pos = first.ctx_len = 8
    s.register_prefix(first)
    s.finish(first, "completed")
    assert s.allocator.free_count == 2
    second = s.submit(Request([1] * 8, 4, req_id="second"))
    plan = s.plan()
    assert plan and plan[0][1] is second
    assert second.pos == 7 and len(second.blocks) == 3
    (root_child,) = s.prefix.root.children.values()
    assert second.blocks[0] == root_child.block
    copies = s.take_copies()
    assert len(copies) == 1 and copies[0][1] == second.blocks[1]


def test_admission_evicts_lru_cache_blocks_when_pool_dry():
    s = Scheduler(_cfg(max_slots=2, cache_blocks=4, block_size=4,
                       max_seq_len=16))
    a = s.submit(Request([1] * 8, 4, req_id="a"))
    s.plan()
    a.pos = a.ctx_len = 8
    s.register_prefix(a)
    s.finish(a, "completed")
    b = s.submit(Request([9] * 8, 4, req_id="b"))
    plan = s.plan()
    assert plan and plan[0][1] is b and len(b.blocks) == 3
    assert s.prefix.evictions >= 1


def test_ngram_draft_lookup_and_plan_budget():
    r = Request([5, 1, 2, 9, 7, 1, 2], 8)
    assert r.draft_lookup(3) == [9, 7, 1]
    r.out_tokens = [9]
    assert r.draft_lookup(2) == [7, 1]
    assert Request([4, 4, 4], 8).draft_lookup(2) == [4]
    assert Request([1, 2, 3], 8).draft_lookup(2) == []
    assert Request([1, 2], 8).draft_lookup(2) == []
    s = Scheduler(_cfg(max_slots=2, max_batch_tokens=6, prefill_chunk=5,
                       spec_k=4))
    d = s.submit(Request([7, 8, 7, 8, 7], 8, req_id="d"))
    s.plan()
    d.pos = d.ctx_len = 5
    d.state = "decode"
    d.out_tokens = [8]
    plan = s.plan()
    assert plan[0][:2] == (0, d) and plan[0][2] == 1 + len(d.draft)
    assert len(d.draft) >= 1
    d.out_tokens = [0] * 7
    plan = s.plan()
    assert plan[0][2] == 1 and d.draft == []


def test_spill_pool_migrates_evicts_and_reloads():
    writes = []
    alloc = BlockAllocator(4)
    pool = HostSpillPool(
        1, lambda b: {"k": torch.full((2, 2), float(b))},
        lambda b, payload: writes.append(b))
    cache = PrefixCache(4, alloc, spill=pool)
    pa, pb = [1, 2, 3, 4], [5, 6, 7, 8]
    for p in (pa, pb):
        blocks = alloc.alloc(1)
        cache.insert(p, blocks)
        alloc.free(blocks)
    assert cache.evict(4) >= 2
    assert pool.spilled_total == 2 and pool.dropped_total == 1
    assert pool.blocks_held == 1 and pool.bytes_held == 16
    full, _, hit = cache.match(pa + [0])
    assert full == [] and hit <= len(pa) - 4
    full, _, _ = cache.match(pb + [0])
    assert len(full) == 1 and pool.reloaded_total == 1
    assert writes and pool.blocks_held == 0


def test_reload_whose_victim_spill_drops_the_node_is_a_miss():
    """A spilled prefix is matched while the pool is dry: reloading it
    evicts another cached leaf, whose spill into the full (capacity 1)
    tier drops the node being reloaded.  The match ends there, a miss,
    and nothing is lost: the victim is held, its block is free."""
    alloc = BlockAllocator(2)
    pool = HostSpillPool(1, lambda b: {"k": torch.zeros(2)},
                         lambda b, payload: None)
    cache = PrefixCache(4, alloc, spill=pool)
    pa, pb = [1, 2, 3, 4], [5, 6, 7, 8]
    blocks = alloc.alloc(1)
    cache.insert(pa, blocks)
    alloc.free(blocks)
    assert cache.evict(1) == 1            # pa spills
    blocks = alloc.alloc(1)
    cache.insert(pb, blocks)
    alloc.free(blocks)
    alloc.alloc(1)                        # a request holds the other block
    assert cache.match(pa + [0]) == ([], None, 0)
    assert pool.dropped_total == 1 and pool.spilled_total == 2
    assert pool.reloaded_total == 0 and alloc.free_count == 1
    full, _, hit = cache.match(pb + [0])  # pb reloads into the free block
    assert len(full) == 1 and hit == 4 and pool.reloaded_total == 1


# ---------------------------------------------- the engine on tiny (fp32)
@pytest.mark.parametrize("case", ["reference", "speed"])
def test_engine_matches_jax_engine(tiny, case):
    """The reference's prompts (tests/test_serve.py:261, RandomState(11),
    lengths 9/4/6/11) and its shared-prefix traffic with every leg on:
    the same tokens and the same sched_digest as the JAX engine, and the
    port's full-forward greedy."""
    cfg, _, model = tiny
    if case == "reference":
        rng = np.random.RandomState(11)
        prompts = [rng.randint(0, cfg.vocab, n).tolist()
                   for n in (9, 4, 6, 11)]
        scfg, n_new = _cfg(cache_blocks=32, max_batch_tokens=12), 5
    else:
        prompts = _speed_prompts(cfg.vocab)
        scfg, n_new = _cfg(cache_blocks=32, max_batch_tokens=12,
                           prefill_chunk=6, spec_k=4), 10
    engine = _engine(model, scfg)
    outs = _serve(engine, prompts, n_new)
    ref = _jax_engine(tiny, scfg)
    assert outs == _serve(ref, prompts, n_new)
    assert engine.sched_digest == ref.sched_digest
    assert engine.tick == ref.tick
    for p, out in zip(prompts, outs):
        assert out == _greedy(model, p, n_new)
    got, want = engine.stats(), ref.stats()
    assert set(got) == set(want)
    for key in ("prefix_cache", "spec", "kv_pool"):
        assert set(got[key]) == set(want[key]), key
        assert got[key] == want[key], key
    if case == "speed":
        assert got["prefix_cache"]["hits"] >= 1
        assert got["prefix_cache"]["cow_copies"] >= 1
        assert got["prefill_chunks"] >= len(prompts) + 1


@pytest.mark.parametrize("prefix", [False, True])
@pytest.mark.parametrize("chunked", [False, True])
@pytest.mark.parametrize("spec", [False, True])
def test_engine_matches_greedy_all_leg_combinations(tiny, prefix, chunked,
                                                    spec):
    """Prefix cache x chunked prefill x spec decode, cold and warm waves
    (the warm wave meets a populated prefix cache): the port's full-forward
    greedy in every cell (tests/test_serve_speed.py:239)."""
    _, _, model = tiny
    prompts = _speed_prompts(256)[:2]
    engine = _engine(model, _cfg(cache_blocks=32, max_batch_tokens=16,
                                 prefill_chunk=5 if chunked else 16,
                                 prefix_cache=prefix, spec_decode=spec,
                                 spec_k=4))
    waves = [_serve(engine, prompts, 5, prefix=w) for w in ("cold", "warm")]
    if prefix:
        assert engine.stats()["prefix_cache"]["hits"] >= 1
    if chunked:
        assert engine.stats()["prefill_chunks"] > 2 * len(prompts)
    for i, p in enumerate(prompts):
        ref = _greedy(model, p, 5)
        assert waves[0][i] == ref and waves[1][i] == ref, i


def test_engine_block_reuse_and_eos_eviction(tiny):
    """A full drain restores the free count, an EOS hit finishes early with
    finish_reason 'eos', and the next admission reuses the freed blocks
    (LIFO) (tests/test_serve.py:283)."""
    _, _, model = tiny
    scfg = _cfg(max_slots=1, cache_blocks=8, max_batch_tokens=8,
                prefix_cache=False)
    prompt = np.random.RandomState(2).randint(0, 256, 6).tolist()
    engine = _engine(model, scfg)
    free0 = engine.scheduler.allocator.free_count
    (first,) = _serve(engine, [prompt], 4)
    engine2 = _engine(model, scfg)
    r = engine2.submit(prompt, 4, req_id="eos-req", eos_id=first[0])
    engine2.step()
    blocks_first = list(engine2.scheduler.slots[0].blocks)
    engine2.flush()
    assert r.finish_reason == "eos" and r.out_tokens == [first[0]]
    assert engine2.scheduler.allocator.free_count == free0
    r2 = engine2.submit(prompt, 1, req_id="next")
    engine2.step()
    assert r2.blocks == blocks_first[:len(r2.blocks)]
    engine2.flush()


def test_prefix_hits_shrink_prefill_work(tiny):
    """A repeated 20-token prompt prefills in 5 chunks of 4 cold and in 1
    warm (tests/test_serve_speed.py:270), with identical output."""
    _, _, model = tiny
    prompt = np.random.RandomState(8).randint(0, 256, 20).tolist()
    engine = _engine(model, _cfg(max_slots=1, max_batch_tokens=8,
                                 prefill_chunk=4, spec_k=3))
    (cold,) = _serve(engine, [prompt], 2, prefix="cold")
    assert engine.stats()["prefill_chunks"] == 5
    (warm,) = _serve(engine, [prompt], 2, prefix="warm")
    assert engine.stats()["prefill_chunks"] == 6 and warm == cold
    st = engine.stats()["prefix_cache"]
    assert st["hit_tokens"] == 19 and st["blocks_shared"] == 4


def test_spec_drafts_are_made_and_accepted(tiny):
    """Weights built so that greedy repeats its last token: the token
    embeddings are scaled up until they dominate the residual stream and
    the lm_head is tied to them.  Prompt-lookup then drafts the run and
    the drafts are accepted.  The last prompt holds the bigram (7, 7)
    followed by other tokens and ends in 7, so once greedy emits 7 the
    first drafts are those other tokens, and they are rejected.  The
    output is plain greedy throughout."""
    model = copy.deepcopy(tiny[2])
    with torch.no_grad():
        model.embed.table.mul_(100.0)
        model.lm_head.weight.copy_(model.embed.table)
    prompts = [np.random.RandomState(9).randint(0, 256, n).tolist()
               for n in (7, 10)] + [[5, 7, 7, 50, 51, 52, 53, 7]]
    engine = _engine(model, _cfg(max_slots=3, cache_blocks=32, spec_k=4))
    outs = _serve(engine, prompts, 12)
    spec = engine.stats()["spec"]
    assert spec["drafted_tokens"] > spec["accepted_tokens"] >= 1
    for p, out in zip(prompts, outs):
        assert out == _greedy(model, p, 12)
    assert any(len(set(out[-4:])) == 1 for out in outs)


def test_engine_spill_reload_matches_jax_engine(tiny):
    """Under pool pressure a shared prefix spills to host memory and
    reloads on the next hit (tests/test_serve_replica.py:201): the same
    tokens, digest and spill counters as the JAX engine, and greedy."""
    _, _, model = tiny
    rng = np.random.RandomState(7)
    pa, pb = rng.randint(0, 256, 12).tolist(), rng.randint(0, 256, 12).tolist()
    scfg = _cfg(max_slots=1, cache_blocks=6, spill_blocks=8,
                spec_decode=False)
    engine, ref = _engine(model, scfg), _jax_engine(tiny, scfg)
    for i, p in enumerate((pa, pb, pa)):
        assert _serve(engine, [p], 4, prefix=f"s{i}") == \
            _serve(ref, [p], 4, prefix=f"s{i}")
    assert engine.sched_digest == ref.sched_digest
    spill = engine.kv_pool()["spill"]
    assert spill["spilled_total"] >= 1 and spill["reloaded_total"] >= 1
    assert spill == ref.kv_pool()["spill"]
    (again,) = _serve(engine, [pa], 4, prefix="again")
    assert again == _greedy(model, pa, 4)


def test_kv_pool_counts_the_blocks_users_hold(tiny):
    """The pool carries one trash block; kv_pool() reports the blocks a
    block table may name, and close() releases the pool."""
    _, _, model = tiny
    scfg = _cfg(cache_blocks=10)
    engine = _engine(model, scfg)
    assert engine.cache["k"].shape[1] == 11
    cfg = model.cfg
    block_bytes = 2 * cfg.n_layers * 4 * cfg.n_kv_heads * cfg.head_dim * 4
    pool = engine.kv_pool()
    assert pool["num_blocks"] == 10 and pool["block_bytes"] == block_bytes
    assert pool["pool_bytes"] == 10 * block_bytes
    engine.close()
    assert engine.cache == {}


def test_engine_device_and_role(tiny):
    """No fallback: without a CUDA device and without device='cpu' the
    engine raises.  An unknown role raises; the two disaggregated roles
    construct."""
    _, _, model = tiny
    with pytest.raises(ValueError, match="role"):
        ServeEngine(model, _cfg(), role="both", device="cpu")
    for role in ("prefill", "decode"):
        engine = ServeEngine(model, _cfg(), role=role, device="cpu")
        assert engine.stats()["role"] == role
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(model, _cfg())


# ------------------------------------------------------------------ knobs
def test_serve_config_validation_matrix():
    with pytest.raises(ValueError, match="HOROVOD_SERVE_PORT"):
        _cfg(port=70000).validate()
    with pytest.raises(ValueError, match="HOROVOD_SERVE_MAX_BATCH_TOKENS"):
        _cfg(max_batch_tokens=0).validate()
    with pytest.raises(ValueError, match="HOROVOD_SERVE_MAX_SEQ_LEN"):
        _cfg(max_seq_len=-1).validate()
    with pytest.raises(ValueError, match="HOROVOD_SERVE_CACHE_BLOCKS"):
        _cfg(cache_blocks=0).validate()
    with pytest.raises(ValueError, match="PREFILL_CHUNK"):
        _cfg(prefill_chunk=32, max_batch_tokens=16).validate()
    with pytest.raises(ValueError, match="SPEC_K"):
        _cfg(spec_k=0).validate()
    with pytest.raises(ValueError, match="SPEC_K"):
        _cfg(spec_k=8, prefill_chunk=8).validate()
    _cfg(spec_k=8, prefill_chunk=8, spec_decode=False).validate()
    with pytest.raises(ValueError, match="REPLICA_ID"):
        _cfg(replica_id=1).validate()
    with pytest.raises(ValueError, match="SPILL_BLOCKS"):
        _cfg(spill_blocks=4, prefix_cache=False).validate()
    with pytest.raises(ValueError, match="max_seq"):
        _cfg(max_seq_len=64).validate(model_max_seq=32)
    _cfg().validate(model_max_seq=32)
    assert dataclasses.asdict(ServeConfig()) == \
        dataclasses.asdict(JServeConfig())


def test_from_knobs_reads_the_ports_knobs(monkeypatch):
    good = {"HOROVOD_SERVE_PORT": 0, "HOROVOD_SERVE_MAX_BATCH_TOKENS": 2048,
            "HOROVOD_SERVE_MAX_SEQ_LEN": 2048,
            "HOROVOD_SERVE_CACHE_BLOCKS": 4096}
    cfg = from_knobs(dict(good, HOROVOD_SERVE_MAX_SEQ_LEN=128), max_slots=4)
    assert cfg.max_seq_len == 128 and cfg.max_slots == 4
    with pytest.raises(ValueError, match="HOROVOD_SERVE_CACHE_BLOCKS"):
        from_knobs(dict(good, HOROVOD_SERVE_CACHE_BLOCKS=-1))
    assert from_knobs(Knobs()) == ServeConfig()
    monkeypatch.setenv("HOROVOD_SERVE_SPEC", "0")
    monkeypatch.setenv("HOROVOD_SERVE_PREFILL_CHUNK", "32")
    cfg = from_knobs(Knobs())
    assert not cfg.spec_decode and cfg.prefill_chunk == 32
    monkeypatch.setenv("HOROVOD_SERVE_SPEC_K", "0")
    with pytest.raises(ValueError, match="SPEC_K"):
        from_knobs(Knobs())
