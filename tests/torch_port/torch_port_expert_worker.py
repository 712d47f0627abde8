"""One gloo rank of expert parallelism's four-rank run
(tests/torch_port/test_torch_expert.py), started with
torch.multiprocessing.  Imports torch and horovod_tpu_torch only, never
JAX.

Each rank holds a quarter of the tokens (the rows of the global batch, in
rank order) and a quarter of the experts (``local_experts``), and records
under ``out[name]``: ``make_moe_fn``'s output shard and aux, and for the
gradient cases its share of the global loss and its gradients (the
router's summed over the ranks, the experts' its own); the MoE Llama's
logits shard and, with every replicated gradient summed, its gradients.
Saved to ``<out_dir>/rank<r>.npy``; a case that raised is recorded under
``_<name>`` with its traceback."""

import os
import traceback

import numpy as np

SIZE = 4
# (name, E, D, H, T, capacity factor, k, seed): tests/test_expert.py's
# shapes and capacity factors
MOE_CASES = (
    ("switch", 8, 16, 32, 64, 2.0, 1, 1),
    ("drops", 4, 8, 16, 32, 0.5, 1, 3),
    ("top2", 8, 16, 32, 64, 2.0, 2, 11),
)
AUX_COEF = 0.01
LLAMA_ROWS, LLAMA_SEQ = 4, 17
LLAMA_CF = 8.0  # ample: per-shard and global routing drop nothing


def moe_inputs(name):
    """The tokens ``[T, D]`` and targets of one case."""
    _, E, D, H, T, _, _, seed = next(c for c in MOE_CASES if c[0] == name)
    rng = np.random.RandomState(seed)
    return (rng.randn(T, D).astype(np.float32),
            rng.randn(T, D).astype(np.float32))


def llama_ids(vocab, seed):
    return np.random.RandomState(seed).randint(
        0, vocab, (LLAMA_ROWS, LLAMA_SEQ)).astype(np.int64)


def _np(t):
    return t.detach().float().numpy().copy()


def _moe_case(torch, hvd, E_, tree, x, tgt, cf, k, rank):
    from horovod_tpu_torch.parallel import expert as X
    full = X.moe_params_from_jax(tree)
    params = {n: torch.nn.Parameter(t.clone())
              for n, t in X.local_experts(full).items()}
    fn = X.make_moe_fn(n_experts=E_, capacity_factor=cf,
                       experts_per_token=k)
    t_local = x.shape[0] // SIZE
    xs = torch.from_numpy(x[rank * t_local:(rank + 1) * t_local])
    ts = torch.from_numpy(tgt[rank * t_local:(rank + 1) * t_local])
    y, aux = fn(params, xs)
    # this rank's share of mean((y - tgt)^2) + coef * aux over all tokens
    loss = ((y - ts) ** 2).sum() / tgt.size + AUX_COEF * aux / SIZE
    loss.backward()
    hvd.sync_gradients([params["router"]], op=hvd.Sum)
    return {"y": _np(y), "aux": float(aux),
            "grads": {n: _np(p.grad) for n, p in params.items()}}


def _llama_case(torch, hvd, tree, cfg_name, seed, rank):
    import dataclasses
    from horovod_tpu_torch.models import moe_llama as M
    from horovod_tpu_torch.parallel import expert as X
    cfg = dataclasses.replace(M.CONFIGS[cfg_name],
                              capacity_factor=LLAMA_CF)
    model = M.shard_experts(M.moe_llama_params_from_jax(tree, cfg, "cpu"))
    fn = X.make_moe_fn(n_experts=cfg.n_experts, capacity_factor=LLAMA_CF,
                       experts_per_token=cfg.experts_per_token)
    rows = LLAMA_ROWS // SIZE
    ids = torch.from_numpy(llama_ids(cfg.vocab, seed)[
        rank * rows:(rank + 1) * rows])
    with torch.no_grad():
        logits, _ = model(ids[:, :-1], moe_fn=fn)
    loss = M.loss_fn(model, ids, moe_fn=fn) / SIZE
    loss.backward()
    hvd.sync_gradients([p for n, p in model.named_parameters()
                        if not n.endswith(("moe.wi", "moe.wo"))], op=hvd.Sum)
    return {"logits": _np(logits), "loss": float(loss),
            "grads": {n: _np(p.grad) for n, p in model.named_parameters()}}


def run(rank, port, out_dir):
    os.environ.update(HOROVOD_RANK=str(rank), HOROVOD_SIZE=str(SIZE),
                      HOROVOD_LOCAL_RANK=str(rank),
                      HOROVOD_LOCAL_SIZE=str(SIZE),
                      HOROVOD_COORDINATOR_ADDR=f"127.0.0.1:{port}",
                      HOROVOD_CONTROLLER="none")
    import torch
    torch.set_num_threads(1)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.parallel import expert as X
    hvd.init(device="cpu")
    trees = np.load(os.path.join(out_dir, "trees.npy"),
                    allow_pickle=True).item()
    out = {}
    cases = [(name, lambda c=(name, E_, cf, k): _moe_case(
        torch, hvd, c[1], trees[c[0]], *moe_inputs(c[0]), c[2], c[3], rank))
        for name, E_, _, _, _, cf, k, _ in MOE_CASES]
    cases += [(f"llama {n}", lambda n=n, s=s: _llama_case(
        torch, hvd, trees[f"llama {n}"], n, s, rank))
        for n, s in (("tiny", 1), ("mixtral-tiny", 2))]
    for name, fn in cases:
        try:
            out[name] = fn()
        except Exception:
            out["_" + name] = traceback.format_exc()
    try:
        X.make_moe_fn(n_experts=6)
    except ValueError as e:
        out["indivisible"] = str(e)
    np.save(os.path.join(out_dir, f"rank{rank}.npy"), out, allow_pickle=True)
    hvd.shutdown()
