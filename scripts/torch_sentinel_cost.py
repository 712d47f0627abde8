"""What ``hvd.sentinel.wrap`` costs the port's ``1b`` step on one card.

Phase 5's step (``chip_smoke.py``: ``1b``, bf16, 4 x 2048, AdamW,
``ce_chunks=8``, the flash kernels) in process, once plain and once with
the sentinel's scalars computed between the backward and the optimizer
step, in turns, each variant 8 steps (the means over steps 3-8, each step
synchronized).  The variants:

* ``none``: the plain step;
* ``current``: ``watch/sentinel.py`` ``packed_stats`` on this rank's
  gradients, then its delivery;
* ``deliver``: no computation, only the delivery (the pinned copy behind
  an event).

Then a profiled window of ``none`` and one of ``current``: the device
time a step each of the sentinel's operators adds.  Needs a CUDA card and
``nvcc``; run from the repository's root:
``python3 scripts/torch_sentinel_cost.py``.
"""

import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import horovod_tpu_torch as hvd  # noqa: E402
from horovod_tpu_torch.models import llama  # noqa: E402
from horovod_tpu_torch.ops import _kernels  # noqa: E402
from horovod_tpu_torch.watch import sentinel as TS  # noqa: E402

STEPS = 8
WARMUP = 2


def current(loss, grads):
    return TS.packed_stats(loss, grads)


def deliver(loss, grads):
    z = torch.zeros((), dtype=torch.float32, device=loss.device)
    return torch.stack([z, z, loss.detach().float()])


VARIANTS = {"none": None, "current": current, "deliver": deliver}


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_sentinel_cost: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _kernels.build()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    hvd.init()
    dev = hvd.runtime.get().device
    cfg = llama.CONFIGS["1b"]
    model = llama.init(cfg, torch.Generator(device=dev).manual_seed(0))
    params = list(model.parameters())
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=0.01),
        named_parameters=model.named_parameters())
    rng = np.random.RandomState(0)
    batches = [torch.from_numpy(rng.randint(
        0, cfg.vocab, (4, 2049), dtype=np.int32)).to(dev)
        for _ in range(STEPS)]

    def run(fn, n=STEPS):
        ms = []
        for b in batches[:n]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            opt.zero_grad(set_to_none=True)
            loss = llama.loss_fn(model, b, attn_fn=hvd.flash_attention,
                                 ce_chunks=8)
            loss.backward()
            if fn is not None:
                TS.deliver(fn(loss, [p.grad for p in params]))
            opt.step()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        TS.drain()
        return ms

    run(None)  # warm-up: the allocator, the kernels' first load
    means = {name: [] for name in VARIANTS}
    for _ in range(2):
        for name, fn in VARIANTS.items():
            ms = run(fn)[WARMUP:]
            means[name].append(sum(ms) / len(ms))
    base = sum(means["none"]) / 2
    print(f"[{card}] 1b step, mean of steps {WARMUP + 1}-{STEPS} in two "
          "turns:", flush=True)
    for name, m in means.items():
        avg = sum(m) / len(m)
        print(f"  {name:<9} {m[0]:7.1f} {m[1]:7.1f} ms, ratio "
              f"{avg / base:.3f}", flush=True)

    from torch.profiler import ProfilerActivity, profile
    ops = ("aten::cat", "aten::sub", "aten::isnan", "aten::sum",
           "aten::nan_to_num_", "aten::linalg_vector_norm",
           "aten::_to_copy", "aten::copy_", "aten::stack")
    device_ms = {}
    for name in ("none", "current"):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run(VARIANTS[name], n=3)
        device_ms[name] = {e.key: (e.device_time_total / 3e3, e.count / 3)
                           for e in prof.key_averages() if e.key in ops}
    print(f"[{card}] current against none, device ms a step by operator "
          "(3 profiled steps each):", flush=True)
    for op in ops:
        ms, calls = device_ms["current"].get(op, (0.0, 0))
        ms0, calls0 = device_ms["none"].get(op, (0.0, 0))
        print(f"  {op:<26} {ms - ms0:7.2f} ms, {calls - calls0:.0f} calls",
              flush=True)
    hvd.shutdown()
    print("SENTINEL-COST-OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
