"""One gloo rank of the zoo's two-rank tests
(tests/torch_port/test_torch_zoo_train.py), started with
torch.multiprocessing.  Imports torch and horovod_tpu_torch only, never
JAX."""

import os

import numpy as np


def run(rank, size, port, out_dir, mlp_tree, mlp_batches, bn):
    os.environ.update(HOROVOD_RANK=str(rank), HOROVOD_SIZE=str(size),
                      HOROVOD_LOCAL_RANK=str(rank),
                      HOROVOD_LOCAL_SIZE=str(size),
                      HOROVOD_COORDINATOR_ADDR=f"127.0.0.1:{port}")
    import torch
    import torch.distributed as dist

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import layers as L, mlp

    torch.set_num_threads(1)
    hvd.init(device="cpu")
    out = {}

    # the MLP trained data-parallel: each rank its half of every batch
    model = mlp.params_from_jax(mlp_tree, device="cpu")
    opt = hvd.DistributedOptimizer(torch.optim.Adam(model.parameters(),
                                                    lr=1e-2),
                                   named_parameters=model.named_parameters())
    step = hvd.make_train_step(model, mlp.loss_fn, opt)
    out["mlp_losses"] = [float(step(torch.from_numpy(x), torch.from_numpy(y)))
                         for x, y in mlp_batches]
    out["mlp_params"] = {n: p.detach().numpy().copy()
                         for n, p in model.named_parameters()}

    # sync-BN: this rank's rows of an NCHW batch, statistics over both
    n = bn["x"].shape[0] // size
    x = torch.from_numpy(bn["x"][rank * n:(rank + 1) * n]).requires_grad_()
    layer = L.BatchNorm(x.shape[1], "cpu")
    L.load_state(layer, bn["params"])
    y = layer(x, training=True, group=dist.group.WORLD)
    (y * torch.from_numpy(bn["w"][rank * n:(rank + 1) * n])).sum().backward()
    out["bn"] = {"y": y.detach().numpy(), "dx": x.grad.numpy(),
                 "dscale": layer.scale.grad.numpy(),
                 "dbias": layer.bias.grad.numpy(),
                 "mean": layer.mean.numpy(), "var": layer.var.numpy()}
    hvd.shutdown()
    np.save(os.path.join(out_dir, f"rank{rank}.npy"),
            np.array(out, dtype=object), allow_pickle=True)
