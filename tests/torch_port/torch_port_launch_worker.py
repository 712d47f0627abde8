"""One rank of the launcher's tests (tests/torch_port/test_torch_runner_gloo.py),
started by the port's launcher, ``python -m horovod_tpu_torch.runner.launch
-np 2 python torch_port_launch_worker.py <mode> <dir>``.  Imports torch and
horovod_tpu_torch only, never JAX.  Its rank and peers come from the env the
launcher stamps.

* ``train``: two data-parallel steps of the ``tiny`` Llama (the JAX weights
  and batches of ``<dir>/inputs.npy``) on gloo, ``device="cpu"``; the
  losses, the parameters, the stamped env and this rank's slot read back
  from the rendezvous KV land in ``<dir>/rank<r>.npy``.
* ``fail``: rank 1 exits 3 while rank 0 waits in an allreduce; rank 0 then
  keeps waiting, as a rank whose NCCL peer died does, until the launcher
  ends it.

``peer_info`` and ``divide`` are functions ``run()`` sends to its
workers."""

import os
import sys
import time

import numpy as np

ENV_KEYS = ("HOROVOD_RANK", "HOROVOD_SIZE", "HOROVOD_LOCAL_RANK",
            "HOROVOD_LOCAL_SIZE", "HOROVOD_CROSS_RANK", "HOROVOD_CROSS_SIZE",
            "HOROVOD_HOSTNAME", "HOROVOD_RENDEZVOUS_ADDR",
            "HOROVOD_RENDEZVOUS_PORT", "HOROVOD_CONTROLLER_PORT",
            "HOROVOD_COORDINATOR_ADDR")


def train(out_dir):
    import ast

    import torch
    torch.set_num_threads(1)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import llama
    from horovod_tpu_torch.runner.http_client import get_kv

    hvd.init(device="cpu")
    rank = hvd.rank()
    inp = np.load(os.path.join(out_dir, "inputs.npy"),
                  allow_pickle=True).item()
    model = llama.params_from_jax(inp["tree"], llama.CONFIGS["tiny"],
                                  device="cpu")
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), **inp["opt_kw"]),
        named_parameters=model.named_parameters())
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    step = hvd.make_train_step(model, llama.loss_fn, opt)
    out = {"rank": rank, "size": hvd.size(),
           "env": {k: os.environ.get(k) for k in ENV_KEYS},
           "slot": ast.literal_eval(get_kv(
               os.environ["HOROVOD_RENDEZVOUS_ADDR"],
               int(os.environ["HOROVOD_RENDEZVOUS_PORT"]), "rank",
               str(rank)).decode()),
           "losses": [float(step(torch.from_numpy(b)))
                      for b in inp["batches"]]}
    out["params"] = {n: p.detach().numpy().copy()
                     for n, p in model.named_parameters()}
    hvd.shutdown()
    np.save(os.path.join(out_dir, f"rank{rank}.npy"),
            np.array(out, dtype=object), allow_pickle=True)


def fail(out_dir):
    import torch
    import torch.distributed as dist
    import horovod_tpu_torch as hvd
    hvd.init(device="cpu")
    if hvd.rank() == 1:
        time.sleep(1.0)  # rank 0 is inside its allreduce by now
        with open(os.path.join(out_dir, "rank1.exit"), "w") as f:
            f.write(repr(time.time()))
        os._exit(3)
    with open(os.path.join(out_dir, "rank0.pid"), "w") as f:
        f.write(str(os.getpid()))
    try:
        dist.all_reduce(torch.ones(1))
    except RuntimeError:
        pass  # gloo reports the lost peer, where NCCL would keep waiting
    time.sleep(600)


def peer_info(tag):
    """``run()``'s function: this rank's coordinates and a gloo allreduce
    of ``rank + 1`` over the job."""
    import torch
    import torch.distributed as dist
    import horovod_tpu_torch as hvd
    hvd.init(device="cpu")
    t = torch.tensor([float(hvd.rank() + 1)])
    dist.all_reduce(t)
    out = {"tag": tag, "rank": hvd.rank(), "size": hvd.size(),
           "env_rank": int(os.environ["HOROVOD_RANK"]), "sum": float(t),
           "pid": os.getpid()}
    hvd.shutdown()
    return out


def divide(x):
    """A ``run()`` function that raises for ``x = 0``."""
    return 1 / x


if __name__ == "__main__":
    {"train": train, "fail": fail}[sys.argv[1]](sys.argv[2])
