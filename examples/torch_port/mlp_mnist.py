"""Data-parallel MLP on an MNIST-like dataset, the minimum end-to-end
example; the port's counterpart of examples/jax/mlp_mnist.py (reference:
examples/pytorch/pytorch_mnist.py).

The program places its own workers with ``hvd.run``: each trains its
share of every global batch through ``DistributedOptimizer(Adam)``, so a
step's gradient is the mean over the global batch, as in the JAX
example.  Each worker runs on its card, or on the CPU with ``--cpu``.

    python examples/torch_port/mlp_mnist.py --np 4
    python examples/torch_port/mlp_mnist.py --np 2 --cpu

The dataset is generated deterministically (class templates plus noise,
the JAX example's ``make_data``), so the example needs no download.
"""

import argparse
import time


def make_data(n=4096, classes=10, dim=784, seed=0):
    import numpy as np
    rng = np.random.RandomState(seed)
    templates = rng.randn(classes, dim).astype("float32")
    y = rng.randint(0, classes, n)
    x = templates[y] + 0.8 * rng.randn(n, dim).astype("float32")
    return x, y


def train(epochs: int, batch: int, lr: float, cpu: bool, tree=None):
    """One worker: ``epochs`` passes over the data in global batches of
    ``batch`` rows, this rank's share each step; returns every step's
    loss, the global batch's mean (alike on every rank).  ``tree`` is a
    JAX ``mlp.init`` tree (numpy leaves) to start from; without it the
    weights come from a seeded generator."""
    import os

    import numpy as np
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import mlp

    dev = hvd.init(device="cpu" if cpu else None).device
    if cpu:  # the workers share this host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1)
                                  // hvd.local_size()))
    if hvd.rank() == 0:
        print(f"workers={hvd.size()} device={dev}", flush=True)
    model = (mlp.params_from_jax(tree, device=dev) if tree is not None
             else mlp.init(784, 256, 10, device=dev,
                           generator=torch.Generator(device=dev)
                           .manual_seed(0)))
    opt = hvd.DistributedOptimizer(
        torch.optim.Adam(model.parameters(), lr=lr),
        named_parameters=model.named_parameters())
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    step = hvd.make_train_step(
        model, lambda m, b: mlp.loss_fn(m, b[:, :-1], b[:, -1].long()), opt)

    x, y = make_data()
    data = torch.from_numpy(np.concatenate(
        [x, y[:, None].astype("float32")], axis=1))
    n_batches = len(data) // batch
    out = []
    for epoch in range(epochs):
        t0 = time.time()
        for b in range(n_batches):
            out.append(float(step(data[b * batch:(b + 1) * batch])))
        if hvd.rank() == 0:
            mean = sum(out[-n_batches:]) / n_batches
            print(f"epoch {epoch}: loss={mean:.4f} "
                  f"({time.time() - t0:.1f}s)", flush=True)
    hvd.shutdown()
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--np", type=int, default=1, help="workers")
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args()

    import horovod_tpu_torch as hvd
    losses = hvd.run(train, args=(args.epochs, args.batch, args.lr,
                                  args.cpu), np=args.np)[0]
    if losses[-1] >= losses[0]:
        raise SystemExit(f"failed to learn: losses {losses[0]} to "
                         f"{losses[-1]}")
    print("done", flush=True)


if __name__ == "__main__":
    main()
