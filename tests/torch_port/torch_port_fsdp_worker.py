"""One gloo rank of the FSDP + TP step's four-rank run
(tests/torch_port/test_torch_fsdp.py), started with torch.multiprocessing.
Imports torch and horovod_tpu_torch only, never JAX.  The ``tiny`` Llama
(the JAX weights, carried over with ``params_from_jax``) takes one SGD step
sharded on a ``("dp", "fsdp", "tp")`` device mesh of shape (1, 2, 2), and
the same step unsharded; the results land in ``<out_dir>/rank<r>.npy`` (a
traceback under ``_error`` if the run raised)."""

import os
import traceback

import numpy as np

SIZE = 4
MESH = (1, 2, 2)
LR = 1e-2
ROWS, SEQ = 8, 16


def batch():
    """tests/test_fsdp.py's draw: ``RandomState(0)``, 8 rows of 16 tokens
    (15 positions)."""
    return np.random.RandomState(0).randint(0, 256, (ROWS, SEQ))


def _np(t):
    return t.detach().float().numpy().copy()


def _run(torch, tree):
    from torch.distributed.device_mesh import init_device_mesh
    from horovod_tpu_torch.models import llama
    from horovod_tpu_torch.parallel import fsdp as F
    cfg = llama.CONFIGS["tiny"]
    mesh = init_device_mesh("cpu", MESH, mesh_dim_names=F.MESH_AXES)
    ids = torch.from_numpy(batch())
    model = llama.params_from_jax(tree, cfg, device="cpu")
    specs = F.llama_param_specs(model, mesh=mesh)
    F.shard_params(model, mesh, specs)
    opt = F.init_opt_state(torch.optim.SGD, model, lr=LR)
    step = F.make_fsdp_train_step(model, F.llama_loss_fn, opt, mesh,
                                  batch_spec=(("dp", "fsdp"),))
    loss = step(ids)
    plain = llama.params_from_jax(tree, cfg, device="cpu")
    plain_opt = torch.optim.SGD(plain.parameters(), lr=LR)
    plain_loss = llama.loss_fn(plain, ids)
    plain_loss.backward()
    plain_opt.step()
    wq = model.layers[0].wq.weight
    return {"loss": float(loss), "plain_loss": float(plain_loss),
            "params": {n: _np(p.full_tensor())
                       for n, p in model.named_parameters()},
            "plain": {n: _np(p) for n, p in plain.named_parameters()},
            "wq_local": np.asarray(wq.to_local().shape),
            "wq_global": np.asarray(wq.shape),
            "placements": {n: repr(p.placements)
                           for n, p in model.named_parameters()}}


def run(rank, port, out_dir):
    os.environ.update(HOROVOD_RANK=str(rank), HOROVOD_SIZE=str(SIZE),
                      HOROVOD_LOCAL_RANK=str(rank),
                      HOROVOD_LOCAL_SIZE=str(SIZE),
                      HOROVOD_COORDINATOR_ADDR=f"127.0.0.1:{port}",
                      HOROVOD_CONTROLLER="none")
    import torch
    torch.set_num_threads(1)
    import horovod_tpu_torch as hvd
    hvd.init(device="cpu")
    tree = np.load(os.path.join(out_dir, "tiny.npy"), allow_pickle=True).item()
    try:
        out = _run(torch, tree)
    except Exception:
        out = {"_error": traceback.format_exc()}
    np.save(os.path.join(out_dir, f"rank{rank}.npy"), out, allow_pickle=True)
    hvd.shutdown()
