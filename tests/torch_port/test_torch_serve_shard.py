"""The KV pool sharded over a serving fleet's ranks (``serve/pool.py``)
against the JAX package's ``cache_shardings`` and its ``ServeEngine`` on a
sharded mesh.

The rule: the port's plan puts blocks and kv heads where the JAX
``PartitionSpec`` puts them, on ``tests/test_serve.py``'s cases and more,
and each coordinate's block and head ranges are the ones JAX's
``NamedSharding`` gives that device.  The math: the shards' fp32 partials
merged (``merge_partials``) equal the whole pool's attention within 1e-6,
with head shards too, and a row with no key anywhere merges to 0, not NaN.

The fleet: one spawned run of four gloo ranks
(``torch_port_serve_shard_worker.py``) serves ``tiny`` in fp32 from the
JAX weights, with prefix sharing, speculative decode and a spill tier,
from a pool split four ways over ``hvd`` (Llama and MoeLlama) and over
(dp, tp) = (2, 2).  Each must emit the JAX engine's tokens and
``sched_digest`` byte for byte on a 4-device mesh of the same axes
(``("hvd",)``, ``("dp", "tp")``), with copy-on-write pairs across owners,
a spill round trip and live blocks on every rank.  The 2 + 2
disaggregated run's handoff records carry the whole-pool engine's
payloads and decode to its tokens."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import dataclasses  # noqa: E402
import pickle  # noqa: E402
import time  # noqa: E402

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
import torch.multiprocessing as tmp  # noqa: E402

from horovod_tpu.models import llama as JL  # noqa: E402
from horovod_tpu.models import moe_llama as JM  # noqa: E402
from horovod_tpu.serve import engine as JE  # noqa: E402
from horovod_tpu.serve.config import ServeConfig as JServeConfig  # noqa: E402
from horovod_tpu_torch import serve  # noqa: E402
from horovod_tpu_torch.models import llama as TL  # noqa: E402
from horovod_tpu_torch.serve import pool as P  # noqa: E402
from horovod_tpu_torch.serve.engine import decode_block_payload  # noqa: E402

import torch_port_serve_shard_worker as W  # noqa: E402
from torch_port_ports import hold_ports  # noqa: E402

MERGE_ATOL = 1e-6
PAYLOAD_ATOL = 1e-5  # k/v of layers past the first, fp32 values of O(1)


# ------------------------------------------------------------- the rule
RULE_CASES = [
    # tests/test_serve.py:346-362
    (("data", "model"), (4, 2), 64, 4),
    (("data", "model"), (4, 2), 64, 3),
    (("hvd",), (8,), 64, 4),
    # the port's fleet axes
    (("hvd",), (4,), 16, 2),
    (("hvd",), (3,), 16, 2),
    (("dp", "tp", "pp"), (2, 2, 1), 16, 2),
    (("dp", "tp", "pp"), (1, 4, 1), 16, 2),
    (("dp", "tp", "pp"), (2, 1, 2), 6, 8),
]


@pytest.mark.parametrize("names,shape,blocks,heads", RULE_CASES)
def test_cache_shardings_matches_jax(names, shape, blocks, heads):
    """The spec equals the JAX function's, and at every coordinate the
    plan's block and kv-head ranges are the index JAX's sharding gives
    that device in the pool ``[L, blocks, bs, kv_heads, hd]``."""
    devs = np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape)
    mesh = jax.sharding.Mesh(devs, names)
    shd = JE.cache_shardings(mesh, blocks, heads)
    plan = P.cache_shardings(P.PoolMesh(names, shape), blocks, heads)
    assert plan.spec == tuple(shd.spec) + (None,) * (5 - len(shd.spec))
    index = shd.devices_indices_map((2, blocks, 4, heads, 8))
    for coord in np.ndindex(*shape):
        plan = P.cache_shardings(P.PoolMesh(names, shape, coord), blocks,
                                 heads)
        got = index[devs[coord]]
        assert plan.blocks == got[1].indices(blocks)[:2], coord
        assert plan.heads == got[3].indices(heads)[:2], coord
        assert plan.sharded == (plan.block_shards * plan.head_shards > 1)


# ------------------------------------------------------------- the math
def _tick(S=4, C=8, H=4, hk=2, D=16, bs=4, mb=6, nb=16, seed=0):
    """One mixed tick over a random pool: a decode-length prefill whose
    blocks lie in two shards, a chunk whose keys all lie in the last
    shard, a decode row over shards 0 and 1, and an inactive slot whose
    block-table row is all -1."""
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(S, C, H, D, generator=g)
    k = torch.randn(S, C, hk, D, generator=g)
    v = torch.randn(S, C, hk, D, generator=g)
    kp = torch.randn(nb + 1, bs, hk, D, generator=g)
    vp = torch.randn(nb + 1, bs, hk, D, generator=g)
    bt = torch.full((S, mb), -1, dtype=torch.long)
    bt[0, :3] = torch.tensor([0, 5, 9])
    bt[1, :4] = torch.tensor([12, 13, 14, 15])
    bt[2, :2] = torch.tensor([1, 6])
    lengths, n_new = torch.tensor([5, 0, 6, 0]), torch.tensor([3, 8, 1, 0])
    cols = torch.arange(C)
    positions = lengths[:, None] + cols[None]
    valid = cols[None] < n_new[:, None]
    return q, k, v, kp, vp, bt, positions, valid


@pytest.mark.parametrize("block_shards,head_shards", [(4, 1), (2, 2),
                                                      (1, 2), (4, 2)])
def test_merged_partials_equal_whole_attention(block_shards, head_shards):
    """Each (block, head) shard writes its share of the chunk and keeps
    its partials; merged over the block shards and concatenated over the
    head shards they give the whole pool's attention within 1e-6 at every
    valid position, the shards' pools hold the whole pool's writes
    exactly, and nothing is NaN (the inactive slot has no key anywhere)."""
    q, k, v, kp, vp, bt, positions, valid = _tick()
    nb, hk = kp.shape[0] - 1, kp.shape[2]
    rep = q.shape[2] // hk
    whole_k, whole_v = kp.clone(), vp.clone()
    ref = TL.paged_attention(q, k, v, whole_k, whole_v, bt, positions, valid)
    per_b, per_h = nb // block_shards, hk // head_shards
    heads_out = []
    for j in range(head_shards):
        h0, h1 = j * per_h, (j + 1) * per_h
        qs, ks, vs = q[:, :, h0 * rep:h1 * rep], k[:, :, h0:h1], v[:, :, h0:h1]
        parts = []
        for i in range(block_shards):
            b0, b1 = i * per_b, (i + 1) * per_b
            sk = torch.cat([kp[b0:b1, :, h0:h1], kp[-1:, :, h0:h1]]).clone()
            sv = torch.cat([vp[b0:b1, :, h0:h1], vp[-1:, :, h0:h1]]).clone()
            TL.write_paged_kv(sk, sv, ks, vs, bt, positions, valid, (b0, b1))
            assert torch.equal(sk[:-1], whole_k[b0:b1, :, h0:h1])
            assert torch.equal(sv[:-1], whole_v[b0:b1, :, h0:h1])
            parts.append(P.attn_partials(qs, sk, sv, bt, positions, (b0, b1)))
        m, l, o = (torch.stack(t) for t in zip(*parts))
        heads_out.append(P.merge_partials(m, l, o))
    out = torch.cat(heads_out, dim=2)
    assert not torch.isnan(out).any()
    assert (out[valid] - ref[valid]).abs().max().item() <= MERGE_ATOL
    assert torch.equal(out[3], torch.zeros_like(out[3]))


def test_merge_of_rows_without_keys_is_finite():
    """Partials of shards that hold no key for a row (``-inf`` and 0)
    merge to 0 where no shard has one, and to the other shards' result
    where one has."""
    m = torch.tensor([[[-float("inf"), 0.5]], [[-float("inf"),
                                                -float("inf")]]])
    l = torch.tensor([[[0.0, 2.0]], [[0.0, 0.0]]])
    o = torch.zeros(2, 1, 2, 3)
    o[0, 0, 1] = torch.tensor([2.0, 4.0, 6.0])
    out = P.merge_partials(m, l, o)
    assert torch.equal(out[0, 0], torch.zeros(3))
    assert torch.equal(out[0, 1], torch.tensor([1.0, 2.0, 3.0]))


def test_engine_refuses_a_plan_it_cannot_serve():
    """A plan for another pool, or one that shards without its process
    groups, fails at construction."""
    model = TL.init(TL.CONFIGS["tiny"], torch.Generator().manual_seed(0),
                    device="cpu")
    scfg = serve.ServeConfig(**W.SERVE)
    plan = P.cache_shardings(P.PoolMesh(("hvd",), (4,), (1,)), 32, 2)
    with pytest.raises(ValueError, match="pool plan"):
        serve.ServeEngine(model, scfg, device="cpu", pool=plan)
    plan = P.cache_shardings(P.PoolMesh(("hvd",), (4,), (1,)),
                             scfg.cache_blocks, 2)
    with pytest.raises(ValueError, match="process group"):
        serve.ServeEngine(model, scfg, device="cpu", pool=plan)
    one = P.cache_shardings(P.PoolMesh(("hvd",), (1,)), scfg.cache_blocks, 2)
    engine = serve.ServeEngine(model, scfg, device="cpu", pool=one)
    assert engine.pool is None and "shard" not in engine.kv_pool()
    assert engine.cache["k"].shape[1] == scfg.cache_blocks + 1


# ------------------------------------------------------------ the fleet
def _free_port() -> int:
    """A port below the ephemeral range, free when taken (``hold_ports``)."""
    return hold_ports(1).release()[0]


@pytest.fixture(scope="module")
def weights():
    llama = JL.init(jax.random.PRNGKey(0), JL.CONFIGS["tiny"])
    moe = JM.init(jax.random.PRNGKey(0), JM.CONFIGS["tiny"])
    return {"llama": llama, "moe": moe}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, weights):
    out_dir = str(tmp_path_factory.mktemp("serve_shard"))
    trees = {k: jax.tree_util.tree_map(np.asarray, v)
             for k, v in weights.items()}
    with open(os.path.join(out_dir, "weights.pkl"), "wb") as f:
        pickle.dump(trees, f)
    ctx = tmp.spawn(W.run, args=(_free_port(), out_dir), nprocs=W.SIZE,
                    join=False)
    deadline = time.monotonic() + 120
    while not ctx.join(timeout=2):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.terminate()
            pytest.fail("gloo ranks did not finish in 120 s")
    out = []
    for r in range(W.SIZE):
        with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def _jax_served(weights, name, mesh_shape, mesh_names):
    mod, cfg = (JL, JL.CONFIGS["tiny"]) if name == "llama" else \
        (JM, JM.CONFIGS["tiny"])
    devs = np.array(jax.devices()[:W.SIZE]).reshape(mesh_shape)
    mesh = jax.sharding.Mesh(devs, mesh_names)
    jcfg = JServeConfig(**dataclasses.asdict(serve.ServeConfig(**W.SERVE)))
    engine = JE.ServeEngine(mod, cfg, weights[name], jcfg, mesh=mesh)
    return W.serve_waves(engine), engine.sched_digest


FLEET_CASES = [("llama", "llama", (4,), ("hvd",)),
               ("moe", "moe", (4,), ("hvd",)),
               ("layout", "llama", (2, 2), ("dp", "tp"))]


@pytest.mark.parametrize("case,model,mesh_shape,mesh_names", FLEET_CASES)
def test_sharded_fleet_matches_the_jax_engine(ranks, weights, case, model,
                                              mesh_shape, mesh_names):
    """Every rank emits the JAX engine's tokens and ``sched_digest`` on
    the mesh of the same axes; each holds its shard at its share of the
    bytes, had live blocks, and the run crossed owners in copy-on-write
    and went through the spill tier and back."""
    for r, rec in enumerate(ranks):
        assert "_" + case not in rec, rec.get("_" + case)
    tokens, digest = _jax_served(weights, model, mesh_shape, mesh_names)
    whole = TL.CONFIGS["tiny"]
    nb = W.SERVE["cache_blocks"]
    block_bytes = (2 * whole.n_layers * W.SERVE["block_size"]
                   * whole.n_kv_heads * whole.head_dim * 4)
    for r, rec in enumerate(ranks):
        got = rec[case]
        assert got["tokens"] == tokens, r
        assert got["digest"] == digest, r
        pool, shard = got["kv_pool"], got["kv_pool"]["shard"]
        n = shard["block_shards"] * shard["head_shards"]
        assert pool["pool_bytes"] == nb * block_bytes // n, r
        assert got["shape"][1] == nb // shard["block_shards"] + 1, r
        assert got["shape"][3] == whole.n_kv_heads // shard["head_shards"]
        assert shard["peak_used_blocks"] > 0, (r, shard)
        assert shard["cross_copies"] >= 1, (r, shard)
        spill = got["stats"]["spill"]
        assert spill["spilled_total"] >= 1 and spill["reloaded_total"] >= 1
    want = ([None, "hvd", None, None, None] if case != "layout"
            else [None, "dp", None, "tp", None])
    assert {tuple(rec[case]["kv_pool"]["shard"]["spec"]) for rec in ranks} \
        == {tuple(want)}


def test_disaggregated_sub_fleets_shard_their_own_pools(ranks, weights):
    """Prefill on ranks 0-1 and decode on ranks 2-3, each sub-fleet's pool
    split over its two ranks: the handoff records carry the whole-pool
    prefill engine's requests, first tokens and payloads (layer 0 bitwise,
    the rest within the merge's rounding), both prefill ranks export the
    same records, and the decode ranks emit the whole-pool decode
    engine's tokens."""
    for rec in ranks:
        assert "_disagg" not in rec, rec.get("_disagg")
    model = TL.params_from_jax(jax.tree_util.tree_map(
        np.asarray, weights["llama"]), TL.CONFIGS["tiny"], device="cpu")
    scfg = serve.ServeConfig(**W.SERVE)
    pre = serve.ServeEngine(model, scfg, role="prefill", device="cpu")
    for i, p in enumerate(W.disagg_prompts()):
        pre.submit(p, 4, req_id=f"h{i}")
    whole = [h for rep in pre.flush() for h in rep["handoff"]]
    dec = serve.ServeEngine(model, scfg, role="decode", device="cpu")
    reqs = [dec.import_prefill(h) for h in whole]
    dec.flush()
    keys = ("req_id", "tokens", "first_token")
    for r in range(W.PREFILL_RANKS):
        got = ranks[r]["disagg"]
        assert got["spec"] == (None, "hvd", None, None, None)
        assert got["blocks"] == (8 * r, 8 * r + 8)
        assert [{k: h[k] for k in keys} for h in got["handoffs"]] == \
            [{k: h[k] for k in keys} for h in whole], r
        assert [h["blocks"] for h in got["handoffs"]] == \
            [h["blocks"] for h in ranks[0]["disagg"]["handoffs"]]
        for h, ref in zip(got["handoffs"], whole):
            assert len(h["blocks"]) == len(ref["blocks"])
            for enc, enc_ref in zip(h["blocks"], ref["blocks"]):
                a, b = decode_block_payload(enc), decode_block_payload(enc_ref)
                for name in ("k", "v"):
                    # layer 0's k/v come off the embeddings: bitwise; the
                    # next layers' carry the merge's rounding
                    assert torch.equal(a[name][0], b[name][0])
                    assert (a[name] - b[name]).abs().max().item() \
                        <= PAYLOAD_ATOL
        assert got["digest"] == pre.sched_digest
    for r in range(W.PREFILL_RANKS, W.SIZE):
        got = ranks[r]["disagg"]
        assert got["blocks"] == (8 * (r - 2), 8 * (r - 2) + 8)
        assert got["tokens"] == {q.req_id: q.out_tokens for q in reqs}, r
        assert got["digest"] == dec.sched_digest
