"""BERT masked-LM pretraining with Ulysses sequence parallelism on the port
(BASELINE config 4, BERT-Large with all-to-all sequence parallelism).

Each rank holds ``S/n`` positions of every example, embeds their global
positions, and trades its sequence shard for a head shard in attention
(``parallel/sequence.py`` ``ulysses_attention``).  Its loss is its share
of the global masked mean (``bert.sp_loss_fn``: its masked positions'
summed loss over the count of masked positions in every shard), so the
gradients are summed over the ranks (``op=Sum``) and the shares sum to the
loss one rank would compute over the whole sequence.  Runs BERT-Large on
the cards, or ``tiny`` on the CPU with ``--cpu``.

    python -m horovod_tpu_torch.runner.launch -np 4 --gpu \\
        python examples/torch_port/bert_ulysses_sp.py
    python -m horovod_tpu_torch.runner.launch -np 2 \\
        python examples/torch_port/bert_ulysses_sp.py --cpu
"""

import argparse

import numpy as np
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.models import bert

MASK_ID = 0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=80)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512,
                    help="global sequence length (sharded over the ranks)")
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--mask-rate", type=float, default=0.15)
    ap.add_argument("--cpu", action="store_true", help="tiny on the CPU")
    args = ap.parse_args()

    dev = hvd.init(device="cpu" if args.cpu else None).device
    n, rank = hvd.size(), hvd.rank()
    cfg = bert.CONFIGS["tiny" if args.cpu else "large"]
    seq = min(args.seq, cfg.max_seq)
    if seq % n or cfg.n_heads % n:
        raise SystemExit(f"seq {seq} and heads {cfg.n_heads} must divide "
                         f"over {n} ranks")
    shard = seq // n

    model = bert.init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = hvd.DistributedOptimizer(
        torch.optim.Adam(model.parameters(), lr=args.lr),
        named_parameters=model.named_parameters(), op=hvd.Sum)

    # a masked-LM stream with structure: token i + 1 repeats token i, so
    # a masked position is predictable from its neighbour, which may sit
    # in another rank's shard
    rng = np.random.RandomState(0)

    def make_batch():
        base = rng.randint(1, cfg.vocab, (args.batch, seq // 2))
        ids = np.repeat(base, 2, axis=1)[:, :seq]
        labels = ids.copy()
        mask = rng.rand(args.batch, seq) < args.mask_rate
        ids = np.where(mask, MASK_ID, ids)
        cut = slice(rank * shard, (rank + 1) * shard)
        return (torch.from_numpy(ids[:, cut]).to(dev),
                torch.from_numpy(labels[:, cut]).to(dev),
                torch.from_numpy(mask[:, cut].astype(np.float32)).to(dev))

    first = last = None
    for i in range(args.steps):
        ids, labels, mask = make_batch()
        opt.zero_grad()
        share = bert.sp_loss_fn(model, ids, labels, mask)
        share.backward()
        opt.step()
        loss = hvd.spmd.allreduce(share.detach().float().clone(), op=hvd.Sum)
        last = float(loss)
        first = last if first is None else first
        if rank == 0 and (i % 10 == 0 or i == args.steps - 1):
            print(f"step {i:3d}  mlm loss {last:.6f}", flush=True)
    if rank == 0:
        print(f"seq {seq} over {n} ranks ({shard} a rank); "
              f"loss {first:.4f} -> {last:.4f}")
        if not last < first * 0.95:
            raise SystemExit("MLM loss did not drop")
        print("OK")
    hvd.shutdown()


if __name__ == "__main__":
    main()
