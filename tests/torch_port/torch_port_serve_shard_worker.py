"""One gloo rank of the sharded-pool run (``test_torch_serve_shard.py``),
started with torch.multiprocessing: four ranks serve the ``tiny`` models
from one KV pool split over them (``serve.pool``).  Imports torch and
horovod_tpu_torch only, never JAX.

The runtime comes up with ``HOROVOD_LAYOUT=2,2,1``.  Cases, each recorded
under its name in ``<out_dir>/rank<r>.pkl`` (a case that raised under
``_<name>`` with its traceback):

  * ``llama`` and ``moe``: the pool's blocks over one ``hvd`` axis of the
    four ranks, :func:`traffic` served wave by wave;
  * ``layout``: the runtime's (dp, tp, pp) = (2, 2, 1), kv heads over tp
    and blocks over dp;
  * ``disagg``: ranks 0-1 a prefill sub-fleet and ranks 2-3 a decode
    sub-fleet, each sharding over its own two ranks: the prefill side's
    handoff records, broadcast to the decode side, which imports them and
    decodes.
"""

import os
import pickle
import traceback

import numpy as np

SIZE = 4
LAYOUT = (2, 2, 1)
SERVE = dict(max_slots=2, block_size=4, cache_blocks=16, max_seq_len=32,
             max_batch_tokens=16, prefill_chunk=8, spill_blocks=8, spec_k=3)
PREFILL_RANKS = 2


def traffic():
    """Waves of ``(prompts, new tokens)``: a shared 10-token system prefix
    whose tail block later requests diverge inside (copy-on-write, across
    owners: the clones land in later blocks), enough cached prompts that
    the 16-block pool evicts into the spill tier, and a repeated prompt
    that reloads from it.  Live blocks reach every quarter of the pool."""
    rng = np.random.RandomState(3)
    system = rng.randint(0, 256, 10).tolist()
    pa = system + rng.randint(0, 256, 4).tolist()
    pb = rng.randint(0, 256, 13).tolist()
    pc = rng.randint(0, 256, 11).tolist()
    return [([pa, pb], 6),
            ([system + rng.randint(0, 256, 5).tolist(), pc], 6),
            ([pb[:10] + [1, 2, 3], rng.randint(0, 256, 14).tolist()], 6),
            ([pa, pb], 4)]


def disagg_prompts():
    """The disaggregated run's prompts, the first two waves': the decode
    side's radix tree keeps every imported prompt's blocks, so its
    16-block pool installs four requests, not all eight."""
    return [p for wave, _ in traffic()[:2] for p in wave]


def serve_waves(engine):
    outs = []
    for w, (prompts, n) in enumerate(traffic()):
        reqs = [engine.submit(p, n, req_id=f"w{w}r{i}")
                for i, p in enumerate(prompts)]
        engine.flush()
        assert all(r.state == "done" for r in reqs)
        outs += [list(r.out_tokens) for r in reqs]
    return outs


def _record(engine, outs):
    return {"tokens": outs, "digest": engine.sched_digest,
            "kv_pool": engine.kv_pool(), "stats": engine.stats(),
            "shape": tuple(engine.cache["k"].shape)}


def _served(torch, serve, model, plan):
    engine = serve.ServeEngine(model, serve.ServeConfig(**SERVE),
                               device="cpu", pool=plan)
    rec = _record(engine, serve_waves(engine))
    engine.close()
    return rec


def _disagg(torch, dist, serve, model, rank):
    from horovod_tpu_torch.serve.pool import fleet_pool_plan
    scfg = serve.ServeConfig(**SERVE)
    fleets = [list(range(PREFILL_RANKS)), list(range(PREFILL_RANKS, SIZE))]
    plan = fleet_pool_plan(scfg.cache_blocks, model.cfg.n_kv_heads, fleets)
    prompts = disagg_prompts()
    out = {"spec": plan.spec, "blocks": plan.blocks}
    handoffs = [None]
    if rank < PREFILL_RANKS:
        engine = serve.ServeEngine(model, scfg, role="prefill",
                                   device="cpu", pool=plan)
        for i, p in enumerate(prompts):
            engine.submit(p, 4, req_id=f"h{i}")
        records = []
        for rep in engine.flush():
            records += rep["handoff"]
        out["handoffs"] = records
        out["digest"] = engine.sched_digest
        engine.close()
        handoffs = [records]
    dist.broadcast_object_list(handoffs, src=0)
    if rank >= PREFILL_RANKS:
        engine = serve.ServeEngine(model, scfg, role="decode", device="cpu",
                                   pool=plan)
        reqs = [engine.import_prefill(h) for h in handoffs[0]]
        engine.flush()
        out["tokens"] = {r.req_id: list(r.out_tokens) for r in reqs}
        out["digest"] = engine.sched_digest
        engine.close()
    return out


def run(rank, port, out_dir):
    os.environ.update(HOROVOD_RANK=str(rank), HOROVOD_SIZE=str(SIZE),
                      HOROVOD_LOCAL_RANK=str(rank),
                      HOROVOD_LOCAL_SIZE=str(SIZE),
                      HOROVOD_COORDINATOR_ADDR=f"127.0.0.1:{port}",
                      HOROVOD_CONTROLLER="none",
                      HOROVOD_LAYOUT=",".join(map(str, LAYOUT)))
    import torch
    torch.set_num_threads(1)
    import torch.distributed as dist
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import serve
    from horovod_tpu_torch.models import llama, moe_llama
    rt = hvd.init(device="cpu")
    with open(os.path.join(out_dir, "weights.pkl"), "rb") as f:
        trees = pickle.load(f)
    model = llama.params_from_jax(trees["llama"], llama.CONFIGS["tiny"],
                                  device="cpu")
    moe = moe_llama.moe_llama_params_from_jax(
        trees["moe"], moe_llama.CONFIGS["tiny"], device="cpu")
    blocks, heads = SERVE["cache_blocks"], model.cfg.n_kv_heads
    cases = [
        ("llama", lambda: _served(torch, serve, model,
                                  serve.fleet_pool_plan(blocks, heads))),
        ("moe", lambda: _served(torch, serve, moe,
                                serve.fleet_pool_plan(blocks, heads))),
        ("layout", lambda: _served(torch, serve, model, serve.fleet_pool_plan(
            blocks, heads, dims=rt.layout.dims))),
        ("disagg", lambda: _disagg(torch, dist, serve, model, rank)),
    ]
    out = {}
    for name, fn in cases:
        try:
            out[name] = fn()
        except Exception:
            out["_" + name] = traceback.format_exc()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    hvd.shutdown()
