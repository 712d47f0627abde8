"""One gloo rank of the GPipe schedule's four-rank run
(tests/torch_port/test_torch_pipeline.py), started with
torch.multiprocessing.  Imports torch and horovod_tpu_torch only, never
JAX.  Four stages run over the world; two stages over each of the groups
[0, 1] and [2, 3].  Each rank records its stage's outputs and gradients
under ``out[name]``, saved to ``<out_dir>/rank<r>.npy``; a case that
raised is recorded under ``_<name>`` with its traceback."""

import dataclasses
import os
import traceback

import numpy as np

SIZE = 4
DIM, ROWS = 6, 8            # the tanh stages (tests/test_pipeline.py)
MICRO = (1, 2, 3, 4, 6, 12)  # forward at these microbatch counts, 12 rows
LLAMA_ROWS, LLAMA_SEQ = 4, 16


def stage_inputs(S):
    """Per-stage ``{"w", "b"}``, inputs and targets of the tanh stack."""
    rng = np.random.RandomState(10 + S)
    stages = [{"w": (rng.randn(DIM, DIM) * 0.3).astype(np.float32),
               "b": (rng.randn(DIM) * 0.1).astype(np.float32)}
              for _ in range(S)]
    x = rng.randn(ROWS, DIM).astype(np.float32)
    y = rng.randn(ROWS, DIM).astype(np.float32)
    x12 = rng.randn(12, DIM).astype(np.float32)
    return stages, x, y, x12


def llama_inputs(vocab, n_layers):
    rng = np.random.RandomState(20 + n_layers)
    ids = rng.randint(0, vocab, (LLAMA_ROWS, LLAMA_SEQ)).astype(np.int64)
    tgt = rng.randn(LLAMA_ROWS, LLAMA_SEQ, vocab).astype(np.float32)
    return ids, tgt


def _np(t):
    return t.detach().float().numpy().copy()


def _tanh_case(torch, P, group, S, stage):
    stages, x, y, x12 = stage_inputs(S)
    params = {k: torch.nn.Parameter(torch.from_numpy(v))
              for k, v in stages[stage].items()}

    def stage_fn(p, h):
        return torch.tanh(h @ p["w"] + p["b"])
    fn = P.make_pipeline_fn(stage_fn, n_micro=4, group=group)
    out = fn(params, torch.from_numpy(x))
    loss = torch.mean((out - torch.from_numpy(y)) ** 2)
    loss.backward()
    res = {"out": _np(out), "loss": float(loss),
           "grads": {k: _np(p.grad) for k, p in params.items()},
           "n_stages": fn.n_stages}
    with torch.no_grad():
        res["micro"] = [_np(P.make_pipeline_fn(stage_fn, n_micro=m,
                                               group=group)(
                            params, torch.from_numpy(x12)))
                        for m in MICRO]
    try:
        P.make_pipeline_fn(stage_fn, n_micro=5, group=group)(
            params, torch.zeros(12, DIM))
    except ValueError as e:
        res["indivisible"] = str(e)
    return res


def _llama_case(torch, P, tree, group, S, stage):
    from horovod_tpu_torch.models import llama
    cfg = dataclasses.replace(llama.CONFIGS["tiny"], n_layers=len(
        tree["layers"]))
    full = llama.params_from_jax(tree, cfg, device="cpu")
    apply_fn, restack = P.make_pipelined_llama(cfg, n_micro=2, group=group)
    pmodel = restack(full)
    ids, tgt = llama_inputs(cfg.vocab, cfg.n_layers)
    logits = apply_fn(pmodel, torch.from_numpy(ids))
    loss = torch.mean((logits - torch.from_numpy(tgt)) ** 2)
    loss.backward()
    res = {"logits": _np(logits),
           "grads": {n: _np(p.grad) for n, p in pmodel.named_parameters()
                     if n.startswith("layers.")},
           "first_layer": stage * (cfg.n_layers // S)}
    try:
        P.make_pipelined_llama(dataclasses.replace(cfg, n_layers=3),
                               n_micro=2, group=group)
    except ValueError as e:
        res["bad_layering"] = str(e)
    return res


def run(rank, port, out_dir):
    os.environ.update(HOROVOD_RANK=str(rank), HOROVOD_SIZE=str(SIZE),
                      HOROVOD_LOCAL_RANK=str(rank),
                      HOROVOD_LOCAL_SIZE=str(SIZE),
                      HOROVOD_COORDINATOR_ADDR=f"127.0.0.1:{port}",
                      HOROVOD_CONTROLLER="none")
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.parallel import pipeline as P
    hvd.init(device="cpu")
    pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    pair = pairs[rank // 2]
    trees = {n: np.load(os.path.join(out_dir, f"llama{n}.npy"),
                        allow_pickle=True).item() for n in (2, 4)}
    cases = [
        ("tanh S=4", lambda: _tanh_case(torch, P, None, 4, rank)),
        ("tanh S=2", lambda: _tanh_case(torch, P, pair, 2, rank % 2)),
        ("llama S=4", lambda: _llama_case(torch, P, trees[4], None, 4,
                                          rank)),
        ("llama S=2", lambda: _llama_case(torch, P, trees[2], pair, 2,
                                          rank % 2)),
    ]
    out = {}
    for name, fn in cases:
        try:
            out[name] = fn()
        except Exception:
            out["_" + name] = traceback.format_exc()
    np.save(os.path.join(out_dir, f"rank{rank}.npy"), out, allow_pickle=True)
    hvd.shutdown()
