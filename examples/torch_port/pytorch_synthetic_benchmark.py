"""Synthetic throughput benchmark for Horovod's torch API on the port:
timed iterations of a full training step on synthetic images, images/s
per rank and in total (the reference's pytorch_synthetic_benchmark
protocol).  Runs on the card, or on the CPU with ``--cpu``.

    python -m horovod_tpu_torch.runner.launch -np 4 --gpu \\
        python examples/torch_port/pytorch_synthetic_benchmark.py
"""

import argparse
import time

import torch
import torch.nn.functional as F

import horovod_tpu_torch.torch as hvd


def make_model(num_classes=10):
    return torch.nn.Sequential(
        torch.nn.Conv2d(3, 32, 3, stride=2, padding=1), torch.nn.ReLU(),
        torch.nn.Conv2d(32, 64, 3, stride=2, padding=1), torch.nn.ReLU(),
        torch.nn.AdaptiveAvgPool2d(1), torch.nn.Flatten(),
        torch.nn.Linear(64, num_classes))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--num-iters", type=int, default=10)
    ap.add_argument("--num-warmup", type=int, default=3)
    ap.add_argument("--image-size", type=int, default=64)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args()

    dev = hvd.init(device="cpu" if args.cpu else None).device
    torch.manual_seed(0)
    model = make_model().to(dev)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.01),
        named_parameters=model.named_parameters())
    data = torch.randn(args.batch_size, 3, args.image_size, args.image_size,
                       device=dev)
    target = torch.randint(0, 10, (args.batch_size,), device=dev)

    def step():
        opt.zero_grad()
        loss = F.cross_entropy(model(data), target)
        loss.backward()
        opt.step()
        return loss

    for _ in range(args.num_warmup):
        step()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(args.num_iters):
        loss = step()
    loss = float(loss)  # waits for the last step
    dt = time.perf_counter() - t0
    img_sec = args.batch_size * args.num_iters / dt
    if hvd.rank() == 0:
        print(f"Img/sec per rank: {img_sec:.1f}")
        print(f"Total img/sec on {hvd.size()} ranks: "
              f"{img_sec * hvd.size():.1f} (final loss {loss:.4f})")
    hvd.shutdown()


if __name__ == "__main__":
    main()
