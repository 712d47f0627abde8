"""MNIST-like classification with Horovod's torch API on the port
(BASELINE config 1: "pytorch MNIST with hvd.DistributedOptimizer"): a
sharded dataset, the size-scaled learning rate with warmup, metric
averaging, rank-0 checkpoints and resume by epoch.

The data is generated (procedural "digits": blurred class templates plus
noise, shaped like MNIST), so the example needs no download.  Each rank
runs on its card, or on the CPU with ``--cpu``.

    python -m horovod_tpu_torch.runner.launch -np 4 --gpu \\
        python examples/torch_port/pytorch_mnist.py
    python -m horovod_tpu_torch.runner.launch -np 2 \\
        python examples/torch_port/pytorch_mnist.py --cpu --epochs 2
"""

import argparse
import os
import tempfile

import numpy as np
import torch
import torch.nn.functional as F

import horovod_tpu_torch.torch as hvd


class Net(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = torch.nn.Conv2d(1, 16, 3, padding=1)
        self.conv2 = torch.nn.Conv2d(16, 32, 3, padding=1)
        self.fc1 = torch.nn.Linear(32 * 7 * 7, 64)
        self.fc2 = torch.nn.Linear(64, 10)

    def forward(self, x):
        x = F.max_pool2d(F.relu(self.conv1(x)), 2)
        x = F.max_pool2d(F.relu(self.conv2(x)), 2)
        return self.fc2(F.relu(self.fc1(x.flatten(1))))


def make_data(n, seed):
    """``n`` 28x28 "digits": one smoothed random template per class (fixed,
    so training and validation share them) plus per-sample noise."""
    templates = np.random.RandomState(1234).rand(10, 28, 28) \
        .astype(np.float32)
    for _ in range(3):
        templates = (templates + np.roll(templates, 1, 1)
                     + np.roll(templates, 1, 2)) / 3.0
    rng = np.random.RandomState(seed)
    y = rng.randint(0, 10, n)
    x = templates[y] + 0.35 * rng.randn(n, 28, 28).astype(np.float32)
    return torch.from_numpy(x[:, None]).float(), torch.from_numpy(y).long()


def metric_average(value: float, name: str, dev) -> float:
    return float(hvd.allreduce(torch.tensor([value], device=dev), name=name,
                               op=hvd.Average)[0])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--warmup-epochs", type=float, default=1.0)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "hvd_torch_mnist.pt"))
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args()

    dev = hvd.init(device="cpu" if args.cpu else None).device
    torch.manual_seed(42)

    xs, ys = make_data(4096, seed=0)
    vxs, vys = (t.to(dev) for t in make_data(512, seed=1))
    rank, size = hvd.rank(), hvd.size()
    xs, ys = xs[rank::size].to(dev), ys[rank::size].to(dev)

    model = Net().to(dev)
    base_lr = args.lr * size
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=base_lr, momentum=0.9),
        named_parameters=model.named_parameters())

    start_epoch = 0
    if rank == 0 and os.path.exists(args.ckpt):
        ck = torch.load(args.ckpt, map_location=dev, weights_only=True)
        model.load_state_dict(ck["model"])
        opt.load_state_dict(ck["opt"])
        start_epoch = ck["epoch"] + 1
        print(f"resuming from epoch {start_epoch}")
    start_epoch = hvd.broadcast_object(start_epoch, root_rank=0)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    hvd.broadcast_optimizer_state(opt, root_rank=0)

    steps_per_epoch = max(1, len(xs) // args.batch_size)
    vacc = 0.0
    for epoch in range(start_epoch, args.epochs):
        model.train()
        perm = torch.randperm(len(xs), device=dev)
        total = 0.0
        for step in range(steps_per_epoch):
            idx = perm[step * args.batch_size:(step + 1) * args.batch_size]
            warm = (epoch + step / steps_per_epoch + 1e-9) / max(
                args.warmup_epochs, 1e-9)
            for group in opt.param_groups:
                group["lr"] = base_lr * min(1.0, warm)
            opt.zero_grad()
            loss = F.cross_entropy(model(xs[idx]), ys[idx])
            loss.backward()
            opt.step()
            total += loss.item()
        model.eval()
        with torch.no_grad():
            vout = model(vxs)
            vloss = metric_average(float(F.cross_entropy(vout, vys)),
                                   "val_loss", dev)
            vacc = metric_average(float((vout.argmax(1) == vys).float()
                                        .mean()), "val_acc", dev)
        if rank == 0:
            print(f"epoch {epoch}: train_loss {total / steps_per_epoch:.4f} "
                  f"val_loss {vloss:.4f} val_acc {vacc:.3f}", flush=True)
            torch.save({"model": model.state_dict(), "opt": opt.state_dict(),
                        "epoch": epoch}, args.ckpt)
    if rank == 0:
        if start_epoch >= args.epochs:
            print(f"nothing to do: checkpoint already at epoch "
                  f"{start_epoch - 1}")
        elif vacc <= 0.5:
            raise SystemExit(f"failed to learn: val_acc={vacc}")
        else:
            print("done")
    hvd.shutdown()


if __name__ == "__main__":
    main()
