"""ResNet-50 training on the port with the features of a real run: bf16
data-parallel training on the cards with BN statistics over the global
batch (sync-BN), SGD with momentum on a linear-warmup cosine schedule, a
validation batch, and checkpoints with resume (``CheckpointManager``).

Synthetic labeled images stand in for ImageNet (each step's batch made
from its step number, so a resumed run sees the batches it would have).
Runs on the cards at 224 px in bf16, or on the CPU with ``--cpu`` at
32 px in fp32.

    python -m horovod_tpu_torch.runner.launch -np 4 --gpu \\
        python examples/torch_port/resnet50_train.py
    python -m horovod_tpu_torch.runner.launch -np 2 \\
        python examples/torch_port/resnet50_train.py --cpu --steps 4
"""

import argparse
import math
import os
import tempfile

import numpy as np
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.checkpoint import CheckpointManager
from horovod_tpu_torch.models import resnet, zoo


def cosine_warmup(base_lr, warmup_steps, total_steps):
    """Linear warmup, then cosine decay to 0."""
    def lr(step):
        warm = base_lr * min(1.0, step / max(warmup_steps, 1))
        t = min(max((step - warmup_steps)
                    / max(total_steps - warmup_steps, 1), 0.0), 1.0)
        return warm * 0.5 * (1.0 + math.cos(math.pi * t))
    return lr


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8, help="per rank")
    ap.add_argument("--classes", type=int, default=100)
    ap.add_argument("--base-lr", type=float, default=0.05)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "hvd_torch_resnet_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--cpu", action="store_true",
                    help="32 px fp32 on the CPU")
    args = ap.parse_args()

    dev = hvd.init(device="cpu" if args.cpu else None).device
    n = hvd.size()
    size_hw = 32 if args.cpu else 224
    dtype = torch.float32 if args.cpu else torch.bfloat16

    model = resnet.init(50, args.classes, dtype,
                        torch.Generator(device=dev).manual_seed(0), dev)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    lr_fn = cosine_warmup(args.base_lr * n, args.steps // 10, args.steps)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.0, momentum=0.9),
        named_parameters=model.named_parameters())
    step_fn = zoo.make_cnn_train_step("resnet50", model, opt)

    def make_batch(step):
        """The global batch of ``step`` (every rank makes it; the step
        takes this rank's rows)."""
        rng = np.random.RandomState(step + 1)
        x = rng.randn(args.batch * n, size_hw, size_hw, 3)
        y = rng.randint(0, args.classes, args.batch * n)
        return (torch.from_numpy(x.astype(np.float32)).to(dtype),
                torch.from_numpy(y))

    mgr = CheckpointManager(args.ckpt_dir, max_to_keep=2)
    start = 0
    latest = mgr.latest_step()
    if latest is not None:
        out = mgr.restore(latest, params=model.state_dict(),
                          opt_state=opt.state_dict())
        model.load_state_dict(out["params"])
        opt.load_state_dict(out["opt_state"])
        start = latest + 1
        if hvd.rank() == 0:
            print(f"resumed from step {latest}", flush=True)

    vx, vy = (t[hvd.rank()::n].to(dev) for t in make_batch(-1))
    for step in range(start, args.steps):
        for group in opt.param_groups:
            group["lr"] = lr_fn(step)
        loss = step_fn(*make_batch(step))
        if step % 10 == 0 or step == args.steps - 1:
            with torch.no_grad():
                acc = (model(vx).argmax(-1) == vy).float().mean()
            acc = hvd.spmd.allreduce(acc, op=hvd.Average)
            if hvd.rank() == 0:
                print(f"step {step}: loss {float(loss):.6f} "
                      f"lr {lr_fn(step):.4f} val_acc {float(acc):.3f}",
                      flush=True)
        if step % args.ckpt_every == 0 and step > 0:
            mgr.save(step, params=model.state_dict(),
                     opt_state=opt.state_dict())
    if hvd.rank() == 0:
        print("done", flush=True)
    hvd.shutdown()


if __name__ == "__main__":
    main()
