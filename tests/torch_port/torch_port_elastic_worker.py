"""One rank of the elastic tests (tests/torch_port/test_torch_elastic_gloo.py),
started by the port's launcher: ``python -m horovod_tpu_torch.runner.launch
--min-np N --max-np N --host-discovery-script S [--chaos SPEC] python
torch_port_elastic_worker.py <mode> <dir>`` (``internal``: ``-np 2``).
Imports torch and horovod_tpu_torch only, never JAX; gloo ranks on the CPU.

* ``train``: the ``tiny`` Llama (the JAX weights, batches and AdamW
  settings of ``<dir>/inputs.npy``) through the root
  ``DistributedOptimizer`` with ``flash_attention``'s plain path, each rank
  on its rows of every global batch (``make_train_step``), under
  ``hvd.elastic.run`` with a ``TreeState`` in the fast store under
  ``<dir>/commits``: a restarted
  round restores the last commit (``load_from_disk``, required when a
  commit exists), then trains to the last step.  After step ``i`` it calls
  ``hvd.chaos.step(i + 1)`` and commits after every second step but the
  last.  Every step's loss, the round and the restored commit land in
  ``<dir>/log.rank<r>.jsonl``; at the end the parameters' checksum.
* ``walk``: the JAX package's 3 -> 2 -> 3 membership walk
  (tests/integration/elastic_walk_worker.py) on gloo: round 0 (3 ranks) an
  allreduce, then the rank on the third host exits 1 (its host is
  blacklisted); round 1 (2 ranks) grows the discovery file by a new
  loopback host and parks; round 2 (3 ranks) an allreduce and a marker.
* ``internal``: the ``train`` loop under a static ``-np 2`` launch, no
  disk: after step 3 of the first incarnation every rank raises
  ``HorovodInternalError``, and ``run`` resets in this process (shutdown,
  init, the in-memory restore of the last commit); the next steps'
  collectives run on the new process group.
"""

import json
import os
import sys
import time

import numpy as np


def _log(out_dir, rank, **rec):
    rec["t"] = time.time()
    with open(os.path.join(out_dir, f"log.rank{rank}.jsonl"), "a") as f:
        f.write(json.dumps(rec) + "\n")


def _model_and_step(inp, hvd, torch):
    from horovod_tpu_torch.models import llama
    model = llama.params_from_jax(inp["tree"], llama.CONFIGS["tiny"],
                                  device="cpu")
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), **inp["opt_kw"]),
        named_parameters=model.named_parameters())
    step = hvd.make_train_step(
        model, lambda m, ids: llama.loss_fn(m, ids,
                                            attn_fn=hvd.flash_attention),
        opt)
    return model, opt, step


def train(out_dir, internal=False):
    import torch
    torch.set_num_threads(1)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common.exceptions import HorovodInternalError

    hvd.init(device="cpu")
    rank, size = hvd.rank(), hvd.size()
    rnd = int(os.environ.get("HOROVOD_ELASTIC_ROUND", "0"))
    inp = np.load(os.path.join(out_dir, "inputs.npy"),
                  allow_pickle=True).item()
    model, opt, step = _model_and_step(inp, hvd, torch)
    steps = len(inp["batches"])
    state = hvd.elastic.TreeState(
        params=model, opt_state=opt, step=0,
        sharded_commit_dir=None if internal else os.path.join(
            out_dir, "commits"))
    restored = None
    if not internal:
        fast = state._fast()
        own = sorted(fast.steps())
        if state.load_from_disk():
            restored = state.last_restore
        elif own:
            raise SystemExit(f"rank {rank}: commits {own} on disk, none "
                             "restored")
        _log(out_dir, rank, kind="start", round=rnd, size=size,
             own_steps=own, restored=restored, step=state.step)
    raised = []

    @hvd.elastic.run
    def loop(state):
        for i in range(state.step, steps):
            # the step takes this rank's rows of the global batch
            loss = float(step(torch.from_numpy(inp["batches"][i])))
            _log(out_dir, rank, kind="step", round=rnd, step=i, loss=loss,
                 inc=len(raised))
            state.step = i + 1
            hvd.chaos.step(state.step)
            if internal and state.step == 4 and not raised:
                raised.append(True)
                hvd.runtime.get().old_incarnation = True
                raise HorovodInternalError("simulated engine failure")
            if state.step % 2 == 0 and state.step < steps:
                state.commit()

    loop(state)
    sums = [float(p.detach().double().sum()) for p in model.parameters()]
    _log(out_dir, rank, kind="end", round=rnd, checksum=sums,
         new_runtime=bool(raised) and not getattr(
             hvd.runtime.get(), "old_incarnation", False),
         commits=None if internal else sorted(state._fast().steps()))
    hvd.shutdown()


def walk(out_dir):
    failed = os.path.join(out_dir, "failed_once")
    grew = os.path.join(out_dir, "grew")
    rank = int(os.environ.get("HOROVOD_RANK", "0"))
    size = int(os.environ.get("HOROVOD_SIZE", "0"))
    # the phase marker at spawn time: rank 2 writes it mid-round 0
    failed_at_start = os.path.exists(failed)
    if size == 2:
        # the shrunken world: grow the host set once and park; the driver
        # ends the round when its discovery poll sees the change
        assert failed_at_start, "shrink before any failure"
        if rank == 0 and not os.path.exists(grew):
            with open(os.path.join(out_dir, "hosts.txt"), "a") as f:
                f.write("127.0.0.3:1\n")
            open(grew, "w").write("x")
        open(os.path.join(out_dir, f"round1_seen_{rank}"), "w").write("x")
        time.sleep(120)
        return 1
    import torch
    import torch.distributed as dist
    import horovod_tpu_torch as hvd
    hvd.init(device="cpu")
    assert hvd.size() == 3, hvd.size()
    t = torch.tensor([float(hvd.rank())])
    dist.all_reduce(t)
    assert float(t) == 3.0, float(t)
    if not failed_at_start:
        if hvd.rank() == 2:
            open(failed, "w").write("x")
            return 1
        hvd.shutdown()
        return 0
    open(os.path.join(out_dir, f"walk_ok_{hvd.rank()}"), "w").write(
        os.environ["HOROVOD_HOSTNAME"])
    hvd.shutdown()
    return 0


if __name__ == "__main__":
    mode, out = sys.argv[1], sys.argv[2]
    if mode == "walk":
        sys.exit(walk(out))
    train(out, internal=mode == "internal")
