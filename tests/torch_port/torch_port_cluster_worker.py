"""Functions the placement tests send to their tasks
(``test_torch_spark_run.py``, ``test_torch_ray.py``,
``test_torch_cluster_gloo.py``): module-level, so that the tasks, started
with ``spawn`` or by the elastic driver, import them by name.  Imports
neither JAX nor ``horovod_tpu``: a task's import of this module stays
cheap."""

import os

import numpy as np


def env_report():
    return (os.environ.get("HOROVOD_RANK"),
            os.environ.get("HOROVOD_SIZE"),
            os.environ.get("HOROVOD_COORDINATOR_ADDR", ""))


def env_block(keys):
    return {k: os.environ.get(k) for k in keys}


def add(a, b):
    return a + b + int(os.environ.get("HOROVOD_RANK", "0"))


def fail():
    raise ValueError("worker exploded")


def fail_on_rank_1_then_wait():
    """Rank 1 raises at once; rank 0 waits in the store's rendezvous
    for it, as a peer in a collective would."""
    import horovod_tpu_torch as hvd
    if os.environ["HOROVOD_RANK"] == "1":
        raise ValueError("rank 1 exploded")
    hvd.init(device="cpu")
    return "rank 0 was not ended"


def die_if_multi():
    size = int(os.environ.get("HOROVOD_SIZE", "1") or 1)
    if size > 1:
        raise ValueError(f"boom at size={size}")
    return "solo-ok"


def always_die():
    raise ValueError("always boom")


def exit_hard():
    """A task that dies without reporting (a native crash, a kill)."""
    os._exit(7)


def tensors():
    """A result holding tensors, on the card when there is one."""
    import torch
    r = int(os.environ["HOROVOD_RANK"])
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    return {"t": torch.full((2,), float(r), device=dev),
            "nested": [(torch.arange(3, device=dev) + r,)]}


def planes_without_kv():
    """``hvd.init()`` with every KV-publishing plane switched on and no
    rendezvous: the planes stay off, and a gloo allreduce and shutdown
    finish."""
    import torch
    import torch.distributed as dist
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import chaos
    hvd.init(device="cpu")
    rt = hvd.runtime.get()
    t = torch.tensor([float(hvd.rank() + 1)])
    dist.all_reduce(t)
    out = {"sum": float(t),
           "addrs": [getattr(p, "addr", None) for p in (
               rt.metrics_publisher, rt.perf_publisher, rt.heartbeat)],
           "timeline_publisher": rt.timeline_publisher is None,
           "no_chaos": chaos.active() is None}
    hvd.shutdown()
    return out


def train_tiny(inputs_path):
    """Data-parallel steps of the ``tiny`` Llama on gloo from the JAX
    weights and batches of ``inputs_path`` (as
    ``torch_port_launch_worker.train``): this rank's losses and
    parameters."""
    import torch
    torch.set_num_threads(1)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import llama
    inp = np.load(inputs_path, allow_pickle=True).item()
    hvd.init(device="cpu")
    model = llama.params_from_jax(inp["tree"], llama.CONFIGS["tiny"],
                                  device="cpu")
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), **inp["opt_kw"]),
        named_parameters=model.named_parameters())
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    step = hvd.make_train_step(model, llama.loss_fn, opt)
    out = {"rank": hvd.rank(), "size": hvd.size(),
           "losses": [float(step(torch.from_numpy(b)))
                      for b in inp["batches"]],
           "params": {n: p.detach().clone()
                      for n, p in model.named_parameters()}}
    hvd.shutdown()
    return out
