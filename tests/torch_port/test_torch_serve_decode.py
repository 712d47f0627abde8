"""The port's decode path (``horovod_tpu_torch.models.llama`` ``init_cache``,
``copy_blocks``, ``apply_cached``) against ``horovod_tpu.models.llama`` on
the same ``params_from_jax`` weights and numpy-seeded inputs, and against
the port's own full forward.  The port's pool carries one trash block after
the JAX pool's blocks; comparisons read the blocks both pools have."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from horovod_tpu.models import llama as JL
from horovod_tpu_torch.models import layers as TLayers
from horovod_tpu_torch.models import llama as TL


def _models(name="tiny", seed=0):
    jcfg, tcfg = JL.CONFIGS[name], TL.CONFIGS[name]
    params = JL.init(jax.random.PRNGKey(seed), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, params)
    return jcfg, params, TL.params_from_jax(tree, tcfg, device="cpu")


@pytest.fixture(scope="module")
def tiny():
    return _models("tiny")


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _ticks():
    """Two ticks over three slots, chunk 6, block size 4, 12 blocks.
    Tick 1: slot 0 prefills 6 tokens, slot 1 prefills 3 (3 padding
    positions), slot 2 is inactive.  Tick 2: slot 0 decodes 1 token, slot 1
    prefills 4 more, slot 2 is inactive with a stale table row."""
    rng = np.random.RandomState(0)
    bt1 = np.array([[2, 0, 5], [7, 3, -1], [-1, -1, -1]], np.int32)
    bt2 = np.array([[2, 0, 5], [7, 3, -1], [1, 4, -1]], np.int32)
    toks1 = rng.randint(0, 256, (3, 6)).astype(np.int32)
    toks2 = rng.randint(0, 256, (3, 6)).astype(np.int32)
    return [(toks1, bt1, np.array([0, 0, 0], np.int32),
             np.array([6, 3, 0], np.int32)),
            (toks2, bt2, np.array([6, 3, 0], np.int32),
             np.array([1, 4, 0], np.int32))]


def _run_both(jcfg, params, model, ticks, num_blocks=12, block_size=4):
    """Drive the JAX and the port's apply_cached through the same ticks;
    returns the per-tick logits and the final pools of both."""
    jcache = JL.init_cache(jcfg, num_blocks, block_size)
    tcache = TL.init_cache(model.cfg, num_blocks, block_size, device="cpu")
    assert tcache["k"].shape[1] == num_blocks + 1
    out = []
    for toks, bt, lengths, n_new in ticks:
        jl, jcache = JL.apply_cached(params, jnp.asarray(toks), jcfg, jcache,
                                     jnp.asarray(bt), jnp.asarray(lengths),
                                     jnp.asarray(n_new))
        tl = model.apply_cached(torch.from_numpy(toks), tcache,
                                torch.from_numpy(bt),
                                torch.from_numpy(lengths),
                                torch.from_numpy(n_new))
        out.append((np.asarray(jl, np.float32), _np(tl)))
    return out, jcache, tcache


def test_apply_cached_matches_jax_tiny(tiny):
    """Prefill chunk, decode step, a mixed tick with an inactive slot and
    padding positions: logits at every position and the pool (blocks
    0..num_blocks-1) within 1e-5."""
    jcfg, params, model = tiny
    out, jcache, tcache = _run_both(jcfg, params, model, _ticks())
    for jl, tl in out:
        np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-5)
    for name in ("k", "v"):
        np.testing.assert_allclose(tcache[name][:, :12].numpy(),
                                   np.asarray(jcache[name]), rtol=1e-5,
                                   atol=1e-5)


def test_apply_cached_matches_jax_mini_bf16():
    """bf16 end to end: logits within 0.1, the port's bf16 logit
    tolerance (test_torch_llama.py::test_mini_bf16_logits_match)."""
    jcfg, params, model = _models("mini")
    ticks = [(t % 4096, bt, ln, nn) for t, bt, ln, nn in _ticks()]
    out, _, tcache = _run_both(jcfg, params, model, ticks)
    assert tcache["k"].dtype == torch.bfloat16
    for jl, tl in out:
        diff = np.abs(tl - jl)
        assert diff.max() <= 0.1, diff.max()


def _cached_logits(model, ids, prefill, block_size=4):
    """Prefill ``prefill`` tokens in one chunk, then decode the rest one
    token per call, as tests/test_serve.py drives the JAX model."""
    T = len(ids)
    nb = -(-T // block_size) + 1
    cache = TL.init_cache(model.cfg, nb, block_size, device="cpu")
    bt = -torch.ones((1, nb), dtype=torch.int32)
    bt[0, :nb - 1] = torch.arange(nb - 1)
    toks = torch.zeros((1, prefill), dtype=torch.int32)
    toks[0, :] = torch.from_numpy(ids[:prefill])
    rows = [model.apply_cached(toks, cache, bt, torch.tensor([0]),
                               torch.tensor([prefill]))[0, :prefill]]
    for t in range(prefill, T):
        toks = torch.zeros((1, prefill), dtype=torch.int32)
        toks[0, 0] = int(ids[t])
        rows.append(model.apply_cached(toks, cache, bt, torch.tensor([t]),
                                       torch.tensor([1]))[0, :1])
    return torch.cat(rows).numpy()


def test_prefill_decode_matches_full_forward(tiny):
    """Prefill + N decode steps reproduce the port's full forward within
    1e-5 (the reference's contract, tests/test_serve.py:206)."""
    _, _, model = tiny
    ids = np.random.RandomState(7).randint(0, 256, 12)
    with torch.no_grad():
        full = model(torch.from_numpy(ids[None]))[0].numpy()
    cached = _cached_logits(model, ids, prefill=8)
    np.testing.assert_allclose(cached, full, rtol=1e-5, atol=1e-5)


def test_paged_layout_is_length_invariant(tiny):
    """Two sequences of different lengths share one pool with disjoint,
    out-of-order block tables; each reproduces its own full forward."""
    _, _, model = tiny
    rng = np.random.RandomState(3)
    ids_a, ids_b = rng.randint(0, 256, 11), rng.randint(0, 256, 5)
    cache = TL.init_cache(model.cfg, 8, 4, device="cpu")
    bt = -np.ones((2, 4), np.int32)
    bt[0, :3] = [0, 1, 2]
    bt[1, :2] = [5, 6]
    toks = np.zeros((2, 11), np.int32)
    toks[0], toks[1, :5] = ids_a, ids_b
    logits = model.apply_cached(torch.from_numpy(toks), cache,
                                torch.from_numpy(bt), torch.tensor([0, 0]),
                                torch.tensor([11, 5]))
    with torch.no_grad():
        full_a = model(torch.from_numpy(ids_a[None]))[0]
        full_b = model(torch.from_numpy(ids_b[None]))[0]
    torch.testing.assert_close(logits[0, :11], full_a, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(logits[1, :5], full_b, rtol=1e-5, atol=1e-5)


def test_copy_blocks_matches_jax_and_padding_writes_nothing(tiny):
    """Clones src -> dst across layers as the JAX copy_blocks does; padding
    entries (dst = num_blocks) change no block a table can name."""
    jcfg, _, model = tiny
    nb = 6
    rng = np.random.RandomState(4)
    shape = (jcfg.n_layers, nb, 4, jcfg.n_kv_heads, jcfg.head_dim)
    k0, v0 = (rng.randn(*shape).astype(np.float32) for _ in range(2))
    src = np.array([3, 0, 5, 9], np.int32)
    dst = np.array([1, nb, nb, nb], np.int32)
    ref = JL.copy_blocks({"k": jnp.asarray(k0), "v": jnp.asarray(v0)},
                         jnp.asarray(src), jnp.asarray(dst))
    cache = TL.init_cache(model.cfg, nb, 4, device="cpu")
    cache["k"][:, :nb] = torch.from_numpy(k0)
    cache["v"][:, :nb] = torch.from_numpy(v0)
    TL.copy_blocks(cache, torch.from_numpy(src), torch.from_numpy(dst))
    for name, before in (("k", k0), ("v", v0)):
        got = cache[name][:, :nb].numpy()
        np.testing.assert_array_equal(got, np.asarray(ref[name]))
        changed = [b for b in range(nb)
                   if not np.array_equal(got[:, b], before[:, b])]
        assert changed == [1]
        np.testing.assert_array_equal(got[:, 1], before[:, 3])


def test_invalid_positions_never_write_a_live_block(tiny):
    """Padding positions whose slot has a block for them, and an inactive
    slot with a stale table row, write nothing into blocks 0..num_blocks-1:
    only the valid positions' (block, offset) cells change."""
    _, _, model = tiny
    nb, bs = 8, 4
    cache = TL.init_cache(model.cfg, nb, bs, device="cpu")
    gen = torch.Generator().manual_seed(0)
    for pool in cache.values():
        pool[:, :nb] = torch.randn(pool[:, :nb].shape, generator=gen)
    before = {n: p.clone() for n, p in cache.items()}
    bt = torch.tensor([[3, 6, -1], [2, 5, 7]], dtype=torch.int32)
    toks = torch.randint(0, 256, (2, 8), generator=gen, dtype=torch.int32)
    # slot 0: 2 valid tokens at positions 1-2 (block 3); positions 3-8 are
    # padding and would reach blocks 3, 6 and (clamped) 6.  Slot 1 is
    # inactive though its row names blocks 2, 5 and 7.
    model.apply_cached(toks, cache, bt, torch.tensor([1, 0]),
                       torch.tensor([2, 0]))
    for name, pool in cache.items():
        diff = (pool[:, :nb] != before[name][:, :nb]).any(dim=(0, 3, 4))
        written = {(b, o) for b, o in zip(*torch.nonzero(diff, as_tuple=True))}
        assert {(int(b), int(o)) for b, o in written} == {(3, 1), (3, 2)}


def test_apply_rope_at_matches_apply_rope():
    """Explicit positions equal to an offset reproduce apply_rope."""
    cos, sin = TLayers.rope_freqs(16, 64, 500000.0)
    x = torch.randn(2, 5, 3, 16, generator=torch.Generator().manual_seed(1))
    pos = torch.arange(7, 12).expand(2, 5)
    torch.testing.assert_close(TLayers.apply_rope_at(x, cos, sin, pos),
                               TLayers.apply_rope(x, cos, sin, offset=7),
                               rtol=0, atol=0)


def test_init_cache_needs_a_device_on_cpu_only_hosts():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TL.init_cache(TL.CONFIGS["tiny"], 4, 4)
    cache = TL.init_cache(dataclasses.replace(TL.CONFIGS["tiny"],
                                              dtype=torch.bfloat16), 4, 4,
                          device="cpu")
    assert cache["k"].dtype == torch.bfloat16
    assert not cache["k"].any() and not cache["v"].any()
