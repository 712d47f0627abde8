"""One rank of the perf plane's launch test
(tests/torch_port/test_torch_perf.py), started by the port's launcher
with ``--metrics-port`` and ``HOROVOD_PERF=1``.  Imports torch and
horovod_tpu_torch only, never JAX.

Each rank prices its steps with a fixed cost model, runs three timed
steps (a gradient sync of three small parameters and a sleep that grows
with the rank) and publishes its perf report; after a barrier rank 0
reads ``GET /perf`` and the raw ``perf`` scope entries into
``<dir>/perf.json``, then a second barrier lets every rank shut down
(whose final publish may rewrite the entries).
"""

import json
import os
import sys
import time


def main(out_dir: str) -> int:
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.runner import http_client
    rt = hvd.init(device="cpu")
    assert rt.perf_publisher is not None, "HOROVOD_PERF did not start it"
    rank = hvd.rank()
    hvd.perf.configure(flops_per_step=2e6, comm_bytes_per_step=4e5,
                       overlap_fraction=0.25)
    params = [torch.nn.Parameter(torch.zeros(n)) for n in (3000, 120, 7)]
    for i in range(3):
        with hvd.perf.timed_step():
            for p in params:
                p.grad = torch.full_like(p, float(rank + i))
            hvd.sync_gradients(params)
            time.sleep(0.02 * (rank + 1))
    assert rt.perf_publisher.publish_now()
    dist.barrier()
    if rank == 0:
        addr = os.environ["HOROVOD_RENDEZVOUS_ADDR"]
        port = int(os.environ["HOROVOD_RENDEZVOUS_PORT"])
        with __import__("urllib.request").request.urlopen(
                f"http://{addr}:{port}/perf", timeout=10) as resp:
            served = json.loads(resp.read())
        raw = {f"rank.{r}": http_client.get_kv(
            addr, port, "perf", f"rank.{r}", timeout=10).decode()
            for r in range(hvd.size())}
        with open(os.path.join(out_dir, "perf.json"), "w") as f:
            json.dump({"served": served, "raw": raw,
                       "url": f"http://{addr}:{port}/perf"}, f)
    dist.barrier()
    hvd.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
