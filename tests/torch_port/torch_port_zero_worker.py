"""One gloo rank of the ZeRO chain's four-rank run
(tests/torch_port/test_torch_zero_gloo.py), started with
torch.multiprocessing.  Imports torch and horovod_tpu_torch only, never
JAX.  Every case's results land in ``out[name]`` as numpy arrays, saved to
``<out_dir>/rank<r>.npy``; the test runs the JAX chain on the same inputs
and compares.  A case that raised is recorded under ``_<name>`` with its
traceback."""

import os
import traceback

import numpy as np

SIZE = 4
THRESH = 64          # the toy's plan: buckets [b1], [w1], [w2]
LLAMA_THRESH = 4096  # several buckets on the tiny Llama
STEPS = 2
LR, EPS, WD = 1e-2, 1e-3, 0.01
LLAMA_LR = 1e-3  # as tests/torch_port/test_torch_data_parallel.py
WIRES = (("none", False), ("bf16", True), ("int8_ring", True))
TOY_CASES = [(level, wire, ef, k) for level in (1, 2, 3)
             for wire, ef in WIRES for k in (1, 2)]
PREFETCH_DEPTHS = (1, 2)  # level 3, wire none, k=2
LLAMA_LEVELS = (1, 3)
LLAMA_ROWS, LLAMA_SEQ = 2, 16  # per rank


def toy_params():
    """tests/test_zero.py's toy model (its draw order), leaves in sorted
    key order as the JAX plan takes them."""
    rng = np.random.RandomState(0)
    w1 = rng.randn(7, 5).astype(np.float32)
    b1 = rng.randn(5).astype(np.float32)
    w2 = rng.randn(5, 1).astype(np.float32)
    return {"b1": b1, "w1": w1, "w2": w2}


def toy_batches(k):
    """Global ``(xs, ys)`` per step, ``[k, 8 * SIZE, ...]`` (test_zero's
    draws); rank r takes rows 8r..8r+7."""
    rng = np.random.RandomState(1)
    return [(rng.randn(k, 8 * SIZE, 7).astype(np.float32),
             rng.randn(k, 8 * SIZE, 1).astype(np.float32))
            for _ in range(STEPS)]


def llama_batches(k=1):
    """Global token ids per step, ``[k, SIZE * LLAMA_ROWS, ...]`` when
    ``k > 1``; rank r takes rows ``LLAMA_ROWS * r`` onward."""
    rng = np.random.RandomState(2)
    shape = (SIZE * LLAMA_ROWS, LLAMA_SEQ + 1)
    return [rng.randint(0, 256, shape if k == 1 else (k,) + shape)
            .astype(np.int64) for _ in range(STEPS)]


def case_name(level, wire, ef, k):
    return f"toy L{level} {wire} ef={ef} k={k}"


def _np(t):
    return t.detach().float().numpy().copy()


def _toy(torch):
    class Toy(torch.nn.Module):
        def __init__(self):
            super().__init__()
            for name, a in toy_params().items():
                setattr(self, name, torch.nn.Parameter(torch.from_numpy(a)))

    def loss_fn(m, x, y):
        h = torch.tanh(x @ m.w1 + m.b1)
        return torch.mean((h @ m.w2 - y) ** 2)
    return Toy(), loss_fn


def _result(torch, Z, model, state, losses, level, thresh):
    params = (Z.gather_zero3_params(state.shards, model,
                                    fusion_threshold_bytes=thresh)
              if level == 3 else list(model.parameters()))
    opt = state.optimizer
    return {"params": [_np(p) for p in params],
            "mu": [_np(opt.state[s]["exp_avg"]) for s in state.shards],
            "nu": [_np(opt.state[s]["exp_avg_sq"]) for s in state.shards],
            "res": (None if state.residuals is None
                    else [_np(r) for r in state.residuals]),
            "losses": np.asarray(losses)}


def _toy_run(torch, Z, rank, level, wire, ef, k, ag_prefetch=None,
             interleaved=True):
    """One toy case; besides the results, ``xmax``: the largest |x| the
    wire format encoded (the scale of its one-ulp allowance)."""
    xmax = [0.0]
    real = Z._wire.wire_roundtrip

    def observed(buf, fmt):
        xmax[0] = max(xmax[0], float(buf.abs().max()))
        return real(buf, fmt)
    Z._wire.wire_roundtrip = observed
    try:
        out = _toy_steps(torch, Z, rank, level, wire, ef, k, ag_prefetch,
                         interleaved)
    finally:
        Z._wire.wire_roundtrip = real
    out["xmax"] = xmax[0]
    return out


def _toy_steps(torch, Z, rank, level, wire, ef, k, ag_prefetch,
               interleaved):
    model, loss_fn = _toy(torch)
    kw = dict(lr=LR, eps=EPS, weight_decay=WD)
    if interleaved:
        state = Z.init_zero_state(torch.optim.AdamW, model, zero_level=level,
                                  wire_policy=wire, error_feedback=ef,
                                  fusion_threshold_bytes=THRESH, **kw)
        step = Z.make_zero_train_step(
            model, loss_fn, state, zero_level=level, wire_policy=wire,
            error_feedback=ef, backward_passes_per_step=k,
            ag_prefetch=ag_prefetch, fusion_threshold_bytes=THRESH)
    else:
        state = Z.init_sharded_opt_state(torch.optim.AdamW, model, **kw)
        step = Z.make_zero1_train_step(model, loss_fn, state)
    rows = slice(8 * rank, 8 * rank + 8)
    losses = []
    for xs, ys in toy_batches(k):
        x, y = (torch.from_numpy(a[:, rows] if k > 1 else a[0, rows])
                for a in (xs, ys))
        losses.append(float(step(x, y)))
    return _result(torch, Z, model, state, losses, level, THRESH)


def _llama_run(torch, Z, rank, level, tree, k=1):
    from horovod_tpu_torch.models import llama
    cfg = llama.CONFIGS["tiny"]
    model = llama.params_from_jax(tree, cfg, device="cpu")
    state = Z.init_zero_state(torch.optim.AdamW, model, zero_level=level,
                              wire_policy="none",
                              fusion_threshold_bytes=LLAMA_THRESH, lr=LLAMA_LR,
                              eps=EPS, weight_decay=WD)
    step = Z.make_zero_train_step(model, lambda m, ids: llama.loss_fn(m, ids),
                                  state, zero_level=level, wire_policy="none",
                                  backward_passes_per_step=k,
                                  fusion_threshold_bytes=LLAMA_THRESH)
    rows = slice(LLAMA_ROWS * rank, LLAMA_ROWS * (rank + 1))
    losses = [float(step(torch.from_numpy(ids[..., rows, :])))
              for ids in llama_batches(k)]
    return _result(torch, Z, model, state, losses, level, LLAMA_THRESH)


def _reshard(torch, dist, Z, rank):
    """Gather the level-3 shards at four ranks, shard again on a two-rank
    group: the new geometry and the values."""
    model, _ = _toy(torch)
    shards = Z.shard_zero3_params(model, fusion_threshold_bytes=THRESH)
    full = Z.gather_zero3_params(shards, model, fusion_threshold_bytes=THRESH)
    pair = dist.new_group([0, 1])
    out = {"shard_lens4": np.asarray([s.numel() for s in shards]),
           "full4": [_np(p) for p in full]}
    if rank < 2:
        small = Z.shard_zero3_params(full, fusion_threshold_bytes=THRESH,
                                     group=pair)
        back = Z.gather_zero3_params(small, model,
                                     fusion_threshold_bytes=THRESH,
                                     group=pair)
        out["shard_lens2"] = np.asarray([s.numel() for s in small])
        out["full2"] = [_np(p) for p in back]
    return out


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
    from horovod_tpu_torch.parallel import zero as Z
    hvd.init(device="cpu")
    out = {}
    tree = np.load(os.path.join(out_dir, "tiny.npy"), allow_pickle=True).item()
    cases = [(case_name(*c), lambda c=c: _toy_run(torch, Z, rank, *c))
             for c in TOY_CASES]
    cases += [(f"toy L3 prefetch {d}", lambda d=d: _toy_run(
        torch, Z, rank, 3, "none", False, 2, ag_prefetch=d))
        for d in PREFETCH_DEPTHS]
    cases.append(("toy monolithic", lambda: _toy_run(
        torch, Z, rank, 1, "none", False, 1, interleaved=False)))
    cases += [(f"llama L{lv}", lambda lv=lv: _llama_run(torch, Z, rank, lv,
                                                        tree))
              for lv in LLAMA_LEVELS]
    cases.append(("llama L2 k=2", lambda: _llama_run(torch, Z, rank, 2, tree,
                                                     k=2)))
    cases.append(("reshard", lambda: _reshard(torch, dist, Z, rank)))
    for name, fn in cases:
        try:
            out[name] = fn()
        except Exception:
            out["_" + name] = traceback.format_exc()
    np.save(os.path.join(out_dir, f"rank{rank}.npy"), out, allow_pickle=True)
    hvd.shutdown()
