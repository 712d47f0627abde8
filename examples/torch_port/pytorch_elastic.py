"""Elastic training with Horovod's torch API on the port: ``@hvd.elastic.run``
with a ``TorchState`` that commits every few batches and survives a change
of the hosts (the reference's pytorch elastic synthetic benchmark).  Runs
on the card, or on the CPU with ``--cpu``.

    python -m horovod_tpu_torch.runner.launch --min-np 1 --max-np 4 \\
        --host-discovery-script ./discover_hosts.sh \\
        python examples/torch_port/pytorch_elastic.py
"""

import argparse

import torch
import torch.nn.functional as F

import horovod_tpu_torch.torch as hvd
import horovod_tpu_torch.torch.elastic as hvd_elastic


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--batches-per-epoch", type=int, default=10)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args()

    dev = hvd.init(device="cpu" if args.cpu else None).device
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(16, 64), torch.nn.ReLU(),
                                torch.nn.Linear(64, 4)).to(dev)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.01),
        named_parameters=model.named_parameters())

    @hvd_elastic.run
    def train(state):
        for epoch in range(state.epoch, args.epochs):
            for b in range(state.batch, args.batches_per_epoch):
                data = torch.randn(args.batch_size, 16, device=dev)
                target = torch.randint(0, 4, (args.batch_size,), device=dev)
                opt.zero_grad()
                loss = F.cross_entropy(model(data), target)
                loss.backward()
                opt.step()
                state.batch = b + 1
                if b % 5 == 0:
                    state.commit()  # a checkpoint and a check of the hosts
            state.epoch, state.batch = epoch + 1, 0
            state.commit()
            if hvd.rank() == 0:
                print(f"epoch {epoch}: loss={loss.item():.4f}", flush=True)

    train(hvd_elastic.TorchState(model=model, optimizer=opt, epoch=0,
                                 batch=0))
    hvd.shutdown()


if __name__ == "__main__":
    main()
