"""The port's MoE decode path (``horovod_tpu_torch.models.moe_llama``
``dropfree_moe_fn``, ``init_cache``, ``copy_blocks``,
``MoeLlama.apply_cached``) and the MoE ``ServeEngine`` against
``horovod_tpu.models.moe_llama`` and the JAX engine, on the same weights
(``moe_llama_params_from_jax``) and numpy-seeded inputs.  Tolerances are
``test_torch_serve_decode.py``'s Llama cases: 1e-5 in fp32, 0.1 on bf16
logits."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from horovod_tpu.models import moe_llama as JM  # noqa: E402
from horovod_tpu.serve import engine as JE  # noqa: E402
from horovod_tpu.serve.config import ServeConfig as JServeConfig  # noqa: E402
from horovod_tpu_torch.models import moe_llama as M  # noqa: E402
from horovod_tpu_torch.serve.config import ServeConfig  # noqa: E402
from horovod_tpu_torch.serve.engine import ServeEngine  # noqa: E402


def _models(name, dtype=None, seed=0):
    jcfg, tcfg = JM.CONFIGS[name], M.CONFIGS[name]
    if dtype == "bf16":
        jcfg = dataclasses.replace(jcfg, dtype=jnp.bfloat16)
        tcfg = dataclasses.replace(tcfg, dtype=torch.bfloat16)
    params = JM.init(jax.random.PRNGKey(seed), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, params)
    return jcfg, params, M.moe_llama_params_from_jax(tree, tcfg,
                                                     device="cpu")


@pytest.fixture(scope="module")
def mixtral():
    return _models("mixtral-tiny")


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _ticks(vocab):
    """Two ticks over three slots, chunk 6, block size 4, 12 blocks (the
    Llama decode test's): a prefill chunk, a short prefill with padding,
    an inactive slot; then a decode step, more prefill, a stale row."""
    rng = np.random.RandomState(0)
    bt1 = np.array([[2, 0, 5], [7, 3, -1], [-1, -1, -1]], np.int32)
    bt2 = np.array([[2, 0, 5], [7, 3, -1], [1, 4, -1]], np.int32)
    toks1 = rng.randint(0, vocab, (3, 6)).astype(np.int32)
    toks2 = rng.randint(0, vocab, (3, 6)).astype(np.int32)
    return [(toks1, bt1, np.array([0, 0, 0], np.int32),
             np.array([6, 3, 0], np.int32)),
            (toks2, bt2, np.array([6, 3, 0], np.int32),
             np.array([1, 4, 0], np.int32))]


def _run_both(jcfg, params, model, num_blocks=12, block_size=4):
    jcache = JM.init_cache(jcfg, num_blocks, block_size)
    tcache = M.init_cache(model.cfg, num_blocks, block_size, device="cpu")
    assert tcache["k"].shape[1] == num_blocks + 1
    assert tcache["k"].dtype == model.cfg.dtype
    out = []
    for toks, bt, lengths, n_new in _ticks(jcfg.vocab):
        jl, jcache, jaux = JM.apply_cached(
            params, jnp.asarray(toks), jcfg, jcache, jnp.asarray(bt),
            jnp.asarray(lengths), jnp.asarray(n_new))
        tl, tcache2, taux = model.apply_cached(
            torch.from_numpy(toks), tcache, torch.from_numpy(bt),
            torch.from_numpy(lengths), torch.from_numpy(n_new))
        assert tcache2 is tcache  # written in place
        out.append((np.asarray(jl, np.float32), _np(tl),
                    float(jaux), float(taux)))
    return out, jcache, tcache


def test_apply_cached_matches_jax_mixtral_tiny(mixtral):
    """fp32 top-2: logits at every position, the router aux and the pool
    (blocks 0..num_blocks-1) within 1e-5 of the JAX ``apply_cached``."""
    jcfg, params, model = mixtral
    out, jcache, tcache = _run_both(jcfg, params, model)
    for jl, tl, ja, ta in out:
        np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(ta, ja, rtol=1e-5, atol=1e-5)
    for name in ("k", "v"):
        np.testing.assert_allclose(tcache[name][:, :12].numpy(),
                                   np.asarray(jcache[name]), rtol=1e-5,
                                   atol=1e-5)


def test_apply_cached_matches_jax_mini_bf16():
    """bf16 end to end on ``mini`` (8 experts, top-1): logits within
    0.1, the port's bf16 logit tolerance."""
    jcfg, params, model = _models("mini", dtype="bf16")
    out, _, tcache = _run_both(jcfg, params, model)
    assert tcache["k"].dtype == torch.bfloat16
    for jl, tl, _, _ in out:
        diff = np.abs(tl - jl)
        assert diff.max() <= 0.1, diff.max()


@pytest.mark.parametrize("name", ["tiny", "mixtral-tiny"])
def test_prefill_decode_matches_full_forward(name):
    """Prefill 8 tokens in one chunk, then decode the rest one token a
    call: the logits equal the port's full forward under the same
    ``dropfree_moe_fn`` within 1e-5 (tests/test_serve.py's contract)."""
    _, _, model = _models(name)
    fn = M.dropfree_moe_fn(model.cfg)
    ids = np.random.RandomState(7).randint(0, model.cfg.vocab, 12)
    with torch.no_grad():
        full = model(torch.from_numpy(ids[None]), moe_fn=fn)[0][0].numpy()
    bs, T, prefill = 4, len(ids), 8
    nb = -(-T // bs) + 1
    cache = M.init_cache(model.cfg, nb, bs, device="cpu")
    bt = -torch.ones((1, nb), dtype=torch.int32)
    bt[0, :nb - 1] = torch.arange(nb - 1)
    toks = torch.from_numpy(ids[None, :prefill].astype(np.int32))
    rows = [model.apply_cached(toks, cache, bt, torch.tensor([0]),
                               torch.tensor([prefill]))[0][0, :prefill]]
    for t in range(prefill, T):
        toks = torch.zeros((1, prefill), dtype=torch.int32)
        toks[0, 0] = int(ids[t])
        rows.append(model.apply_cached(toks, cache, bt, torch.tensor([t]),
                                       torch.tensor([1]))[0][0, :1])
    np.testing.assert_allclose(torch.cat(rows).numpy(), full, rtol=1e-5,
                               atol=1e-5)


def test_dropfree_logits_do_not_depend_on_batchmates(mixtral):
    """Capacity equals the token count: a slot's logits are the same alone
    and beside other slots' tokens (training's capacity-bounded routing
    would drop tokens by batch position)."""
    _, _, model = mixtral
    rng = np.random.RandomState(3)
    toks = torch.from_numpy(rng.randint(0, 256, (3, 6)).astype(np.int32))
    bt = torch.tensor([[0, 1], [2, 3], [4, 5]], dtype=torch.int32)
    zero = torch.zeros(3, dtype=torch.int32)
    cache = M.init_cache(model.cfg, 6, 4, device="cpu")
    both = model.apply_cached(toks, cache, bt, zero,
                              torch.tensor([6, 6, 6]))[0]
    cache = M.init_cache(model.cfg, 6, 4, device="cpu")
    alone = model.apply_cached(toks, cache, bt, zero,
                               torch.tensor([6, 0, 0]))[0]
    torch.testing.assert_close(alone[0], both[0], rtol=1e-5, atol=1e-5)


def test_copy_blocks_is_llamas(mixtral):
    _, _, model = mixtral
    cache = M.init_cache(model.cfg, 4, 2, device="cpu")
    for name in ("k", "v"):
        cache[name].normal_(generator=torch.Generator().manual_seed(1))
    before = {k: v.clone() for k, v in cache.items()}
    M.copy_blocks(cache, torch.tensor([1, 0]), torch.tensor([3, 4]))
    for name in ("k", "v"):
        torch.testing.assert_close(cache[name][:, 3], before[name][:, 1])
        torch.testing.assert_close(cache[name][:, :3], before[name][:, :3])


def _cfg(**kw):
    base = dict(max_slots=2, block_size=4, cache_blocks=32, max_seq_len=32,
                max_batch_tokens=12, prefill_chunk=8)
    base.update(kw)
    return ServeConfig(**base)


@pytest.mark.parametrize("spec", [False, True])
def test_moe_engine_matches_jax_moe_engine(mixtral, spec):
    """The reference's prompts (tests/test_serve.py:261, RandomState(11),
    lengths 9/4/6/11) through the port's MoE engine and the JAX engine
    over ``horovod_tpu.models.moe_llama``: the same tokens, ticks and
    sched_digest, and the port's full-forward greedy under
    ``dropfree_moe_fn``."""
    jcfg, params, model = mixtral
    rng = np.random.RandomState(11)
    prompts = [rng.randint(0, jcfg.vocab, n).tolist() for n in (9, 4, 6, 11)]
    scfg = _cfg(spec_decode=spec)
    engine = ServeEngine(model, scfg, device="cpu")
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("hvd",))
    ref = JE.ServeEngine(JM, jcfg, params,
                         JServeConfig(**dataclasses.asdict(scfg)), mesh=mesh)
    outs = []
    for e in (engine, ref):
        reqs = [e.submit(p, 5, req_id=f"r{i}") for i, p in enumerate(prompts)]
        e.flush()
        outs.append([r.out_tokens for r in reqs])
    assert outs[0] == outs[1]
    assert engine.sched_digest == ref.sched_digest
    assert engine.tick == ref.tick
    fn = M.dropfree_moe_fn(model.cfg)
    for p, out in zip(prompts, outs[0]):
        ids = list(p)
        with torch.no_grad():
            for _ in range(5):
                logits = model(torch.tensor([ids]), moe_fn=fn)[0]
                ids.append(int(logits[0, -1].argmax()))
        assert out == ids[len(p):]


def test_engine_refuses_an_expert_sharded_model():
    """Serving needs every expert on the rank: a model built with
    ``ep_size`` > 1 (what ``shard_experts`` makes) is refused, not routed
    around."""
    sharded = M.MoeLlama(M.CONFIGS["mixtral-tiny"], "cpu", ep_size=2)
    with pytest.raises(ValueError, match="every expert"):
        ServeEngine(sharded, _cfg(), device="cpu")
    with pytest.raises(ValueError, match="every expert"):
        sharded.apply_cached(torch.zeros((1, 2), dtype=torch.int32),
                             M.init_cache(sharded.cfg, 2, 4, device="cpu"),
                             torch.zeros((1, 1), dtype=torch.int32),
                             torch.zeros(1, dtype=torch.int32),
                             torch.ones(1, dtype=torch.int32))
