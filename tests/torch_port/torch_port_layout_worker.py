"""One gloo rank of the 3D layout plane's four-rank run
(tests/torch_port/test_torch_layout_gloo.py), started with
torch.multiprocessing.  Imports torch and horovod_tpu_torch only, never
JAX.  The runtime comes up with ``HOROVOD_LAYOUT=2,2,1``; every other
layout is built with ``layout.build_layout`` (every rank, same order).
Each case's results land in ``out[name]`` as numpy arrays, saved to
``<out_dir>/rank<r>.npy``; a case that raised is recorded under
``_<name>`` with its traceback."""

import os
import traceback

import numpy as np

SIZE = 4
STEPS = 3
ROWS, SEQ = 8, 16  # global rows per step, tokens per row
N_MICRO = 2
LR, EPS = 1e-2, 1e-3
INIT_LAYOUT = (2, 2, 1)
# (dims, level, wire, error feedback, k)
LLAMA_CASES = [
    ((4, 1, 1), 1, "none", False, 1),
    ((4, 1, 1), 3, "none", False, 1),
    ((2, 2, 1), 1, "none", False, 1),
    ((2, 1, 2), 1, "none", False, 1),
    ((1, 2, 2), 1, "none", False, 1),
    ((1, 2, 2), 2, "none", False, 1),
    ((1, 2, 2), 3, "none", False, 1),
    ((2, 2, 1), 1, "none", False, 2),
    ((1, 2, 2), 1, "int8_ring", True, 1),
    ((1, 2, 2), 2, "int8_ring", True, 1),
    ((1, 2, 2), 3, "int8_ring", True, 1),
    ((2, 2, 1), 1, "int8_ring", True, 1),
    ((2, 2, 1), 3, "int8_ring", True, 1),
]
TOY_LAYOUTS = ((2, 2, 1), (2, 1, 2))
TOY_STEPS, TOY_LR = 4, 0.1


def case_name(dims, level, wire, ef, k):
    return f"llama {dims} L{level} {wire} ef={ef} k={k}"


def llama_batches(k):
    """``STEPS`` global batches ``[k, ROWS, SEQ + 1]`` of token ids."""
    rng = np.random.RandomState(1 + k)
    return [rng.randint(0, 256, (k, ROWS, SEQ + 1)).astype(np.int64)
            for _ in range(STEPS)]


def toy_params():
    """tests/test_layout.py's generic toy: w linspace(-1, 1, 5), b 0.1."""
    return {"w": np.linspace(-1.0, 1.0, 5).astype(np.float32),
            "b": np.float32(0.1)}


def toy_data():
    rng = np.random.RandomState(0)
    return (rng.randn(16, 5).astype(np.float32),
            rng.randn(16).astype(np.float32))


def _np(t):
    return t.detach().float().numpy().copy()


def _llama_run(torch, Lay, tree, dims, level, wire, ef, k):
    from horovod_tpu_torch.models import llama
    cfg = llama.CONFIGS["tiny"]
    lay = Lay.build_layout(*dims)
    i = lay.coord[0]
    model = Lay.layout_params_from_jax(tree, cfg, lay.coord, dims,
                                       device="cpu")
    state = Lay.init_layout_state(torch.optim.Adam, model, zero_level=level,
                                  wire_policy=wire, error_feedback=ef,
                                  layout=lay, lr=LR, eps=EPS)
    step = Lay.make_llama_layout_train_step(
        model, state, n_micro=N_MICRO, layout=lay, zero_level=level,
        wire_policy=wire, error_feedback=ef, backward_passes_per_step=k)
    rows = slice(i * ROWS // dims[0], (i + 1) * ROWS // dims[0])
    losses = []
    for ids in llama_batches(k):
        local = ids[:, rows] if k > 1 else ids[0, rows]
        losses.append(float(step(torch.from_numpy(local))))
    full = Lay.gather_layout_params(
        model, state.shards if level == 3 else None, layout=lay)
    Lay.release_layout(lay)
    return {"losses": np.asarray(losses),
            "params": [_np(p) for p in full.values()],
            "res": (None if state.residuals is None
                    else [_np(r) for r in state.residuals])}


def _toy_run(torch, Lay, dims):
    class Toy(torch.nn.Module):
        def __init__(self):
            super().__init__()
            for name, a in toy_params().items():
                setattr(self, name,
                        torch.nn.Parameter(torch.tensor(a)))

    def loss_fn(m, x, y):
        return torch.mean((x @ m.w + m.b - y) ** 2)
    lay = Lay.build_layout(*dims)
    model = Toy()
    state = Lay.init_layout_state(torch.optim.Adam, model, zero_level=2,
                                  layout=lay, lr=TOY_LR, eps=EPS)
    step = Lay.make_layout_train_step(model, loss_fn, state, layout=lay,
                                      zero_level=2)
    x, y = toy_data()
    n = 16 // dims[0]
    rows = slice(lay.coord[0] * n, (lay.coord[0] + 1) * n)
    for _ in range(TOY_STEPS):
        step(torch.from_numpy(x[rows]), torch.from_numpy(y[rows]))
    Lay.release_layout(lay)
    return {"w": _np(model.w), "b": _np(model.b)}


def run(rank, port, out_dir):
    os.environ.update(HOROVOD_RANK=str(rank), HOROVOD_SIZE=str(SIZE),
                      HOROVOD_LOCAL_RANK=str(rank),
                      HOROVOD_LOCAL_SIZE=str(SIZE),
                      HOROVOD_COORDINATOR_ADDR=f"127.0.0.1:{port}",
                      HOROVOD_CONTROLLER="none",
                      HOROVOD_LAYOUT=",".join(map(str, INIT_LAYOUT)))
    import torch
    torch.set_num_threads(1)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.parallel import layout as Lay
    rt = hvd.init(device="cpu")
    out = {"init": {"dims": np.asarray(Lay.layout_of_runtime()),
                    "coord": np.asarray(rt.layout.coord),
                    "ranks": {a: np.asarray(r)
                              for a, r in rt.layout.ranks.items()}}}
    tree = np.load(os.path.join(out_dir, "tiny.npy"), allow_pickle=True).item()
    cases = [(case_name(*c), lambda c=c: _llama_run(torch, Lay, tree, *c))
             for c in LLAMA_CASES]
    cases += [(f"toy {d}", lambda d=d: _toy_run(torch, Lay, d))
              for d in TOY_LAYOUTS]
    for name, fn in cases:
        try:
            out[name] = fn()
        except Exception:
            out["_" + name] = traceback.format_exc()
    np.save(os.path.join(out_dir, f"rank{rank}.npy"), out, allow_pickle=True)
    hvd.shutdown()
