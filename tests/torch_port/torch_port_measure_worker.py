"""One rank of the measurement plane's two-rank tests
(tests/torch_port/test_torch_autotune.py), started by
``torch.multiprocessing`` or by the port's launcher.  Imports torch and
horovod_tpu_torch only, never JAX.

* ``tune`` (spawned, gloo): three small parameters synced through
  ``hvd.sync_gradients`` under the autotuner, each step recorded with the
  seconds of a fixed sequence; every step's tuned threshold, cycle, the
  bucket count of the fused sync's plan and the plan cache's misses land
  in ``<dir>/tune.<rank>.json``.
* ``skip`` (spawned, gloo): rank 1 skips the second ``record()`` and
  leaves; rank 0 writes the error its ``record()`` raised, and when.
* ``trace`` (under the launcher with ``--timeline-merge`` and
  ``--metrics-port``): negotiated allreduces through the eager API, a
  final metrics publish, then rank 0 reads the fleet's ``/metrics`` into
  ``<dir>/metrics.txt``.
"""

import json
import os
import sys

SECONDS = [0.5, 0.4, 0.45, 0.3, 0.35, 0.6, 0.25, 0.3, 0.2, 0.28, 0.33, 0.31]
NBYTES = 3_000_000


def _init(rank, size, port, knobs):
    os.environ.update(HOROVOD_RANK=str(rank), HOROVOD_SIZE=str(size),
                      HOROVOD_LOCAL_RANK=str(rank),
                      HOROVOD_LOCAL_SIZE=str(size),
                      HOROVOD_COORDINATOR_ADDR=f"127.0.0.1:{port}",
                      HOROVOD_CONTROLLER="none", **knobs)
    import torch
    torch.set_num_threads(1)
    import horovod_tpu_torch as hvd
    return hvd.init(device="cpu")


def tune(rank, size, port, out_dir):
    import torch
    rt = _init(rank, size, port, {
        "HOROVOD_AUTOTUNE": "1", "HOROVOD_AUTOTUNE_WARMUP_SAMPLES": "1",
        "HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE": "2",
        "HOROVOD_FUSION_THRESHOLD": str(1 << 20)})
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import optimizer as O
    params = [torch.nn.Parameter(torch.zeros(n))
              for n in (300_000, 120_000, 50_000)]
    tuner = hvd.autotuner()
    rows = []
    for i, secs in enumerate(SECONDS):
        for j, p in enumerate(params):
            p.grad = torch.full_like(p, float(rank + i + j))
        threshold = rt.fusion_threshold()
        hvd.sync_gradients(params)
        plan = O._plan_for([p.grad for p in params], threshold)
        expect = (size - 1) / 2 + i
        ok = all(torch.equal(p.grad, torch.full_like(p, expect + j))
                 for j, p in enumerate(params))
        tuner.record(NBYTES, secs)
        rows.append({"threshold": threshold, "buckets": len(plan.buckets),
                     "misses": rt.plan_cache.misses, "ok": ok,
                     "after": tuner.fusion_threshold,
                     "cycle": tuner.cycle_ms})
    with open(os.path.join(out_dir, f"tune.{rank}.json"), "w") as f:
        json.dump(rows, f)
    hvd.shutdown()


def skip(rank, size, port, out_dir):
    import time
    _init(rank, size, port, {"HOROVOD_AUTOTUNE": "1"})
    import horovod_tpu_torch as hvd
    tuner = hvd.autotuner()
    tuner._sync_timeout_s = 5.0
    tuner.record(NBYTES, 0.5)
    t0, err = time.monotonic(), None
    if rank == 0:
        try:
            tuner.record(NBYTES, 0.5)  # rank 1 skips this one
        except RuntimeError as e:
            err = str(e)
    with open(os.path.join(out_dir, f"skip.{rank}.json"), "w") as f:
        json.dump({"error": err, "seconds": time.monotonic() - t0}, f)
    if rank == 0:
        os._exit(0)  # the unanswered exchange stays posted
    hvd.shutdown()


def trace(out_dir):
    import time
    import urllib.request
    import torch
    torch.set_num_threads(1)
    import horovod_tpu_torch as hvd
    import horovod_tpu_torch.torch as ht
    rt = ht.init(device="cpu")
    for i in range(3):
        ht.allreduce(torch.ones(16) * i, name="grad.a")
        ht.grouped_allreduce([torch.ones(4), torch.ones(5)], name="grad.b")
    rt.metrics_publisher.publish_now()
    ht.barrier()
    if ht.rank() == 0:
        url = (f"http://{os.environ['HOROVOD_RENDEZVOUS_ADDR']}:"
               f"{os.environ['HOROVOD_RENDEZVOUS_PORT']}/metrics")
        deadline = time.time() + 30
        while True:
            with urllib.request.urlopen(url, timeout=10) as resp:
                text = resp.read().decode()
            if 'rank="1"' in text or time.time() > deadline:
                break
            time.sleep(0.2)
        with open(os.path.join(out_dir, "metrics.txt"), "w") as f:
            f.write(text)
    ht.barrier()
    hvd.shutdown()


if __name__ == "__main__":
    trace(sys.argv[2])
