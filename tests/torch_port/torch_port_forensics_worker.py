"""One rank of the forensics planes' experiments
(tests/torch_port/test_torch_forensics_gloo.py), started by the port's
launcher, ``python -m horovod_tpu_torch.runner.launch -np 2 [--postmortem
DIR] [--chaos SPEC] [--alerts RULES] python torch_port_forensics_worker.py
<mode> <dir>``, on gloo ranks with ``HOROVOD_CONTROLLER=tcp``.  Imports
torch and horovod_tpu_torch only, never JAX.

* ``train``: six steps of the two-layer ``tiny`` Llama through the
  hook-driven optimizer (``horovod_tpu_torch.torch``, negotiated through
  the native controller), each step stamped (``postmortem.record_step``)
  and clocked into the chaos injector (``chaos.step``), so the launcher's
  ``--chaos`` spec decides what fails: a kill, or a stall the supervision
  ends with SIGABRT;
* ``nan``: a sentinel-wrapped toy step; rank 1's step-3 input is NaN, so
  its gradient and loss go nonfinite: the rank writes the ``.nan`` flight
  dump and both ranks see ``sentinel-nonfinite`` fire at ``GET /alerts``
  naming rank 1 and the step;
* ``reduce``: a sentinel-wrapped step of the two-layer ``tiny`` Llama
  with ``axis_name="hvd"``, four steps on the direct optimizer (the
  scalars take one ``dist.all_reduce``) and then four on the hook-driven
  one, whose wrapped function returns while the gradients' negotiated
  allreduces are still in flight (the scalars are negotiated through the
  engine beside them; rank 0 runs those allreduces first, rank 1 after
  its reduction is submitted); each rank trains on batches of its own, hands the
  sentinel a NaN in a copy of one gradient at step ``NAN_STEP`` of each
  path on rank 1 only, and writes ``reduce.<rank>.json``: per step its
  own unreduced scalars, the recorded ones, and the ops its engine had
  pending when the sentinel reduced;
* ``straggler``: paced negotiated allreduces while the spec stalls rank 1
  40 ms at ``complete``; both ranks see ``straggler-suspect`` fire at
  ``GET /alerts`` naming rank 1 while the job runs.  The test turns the
  memory sampler off (``HOROVOD_MEM=0``): on the CPU it walks the
  collector's objects under the GIL, long enough to make a rank late for
  a tick.

Each rank of ``nan`` and ``straggler`` prints ``FORENSICS-<MODE>-OK
<rank>`` when its checks hold; ``train`` prints ``FORENSICS-TRAIN-OK``
only if no fault ended it."""

import gc
import json
import math
import os
import sys
import time
import urllib.request

NAN_STEP = 3
# the straggler rehearsal reads /alerts between two paced ticks only when
# this many seconds are left before the next one
_ALERT_READ_S = 0.05


def _get_json(path: str):
    addr = os.environ["HOROVOD_RENDEZVOUS_ADDR"]
    port = os.environ["HOROVOD_RENDEZVOUS_PORT"]
    with urllib.request.urlopen(f"http://{addr}:{port}{path}",
                                timeout=10) as r:
        return json.loads(r.read())


def _firing(rule: str, rank: int):
    """The first firing entry of ``rule`` for ``rank`` at GET /alerts now,
    or None."""
    hits = [f for f in _get_json("/alerts")["firing"]
            if f["rule"] == rule and f["rank"] == rank]
    return hits[0] if hits else None


def _poll_alert(rule: str, rank: int, deadline_s: float = 60.0):
    """The first firing entry of ``rule`` for ``rank`` at GET /alerts,
    polled until ``deadline_s`` runs out (then None)."""
    deadline = time.time() + deadline_s
    while time.time() < deadline:
        hit = _firing(rule, rank)
        if hit is not None:
            return hit
        time.sleep(0.3)
    return None


def train(out_dir: str) -> int:
    import numpy as np
    import torch
    torch.set_num_threads(1)
    import horovod_tpu_torch as hvd
    import horovod_tpu_torch.torch as ht
    from horovod_tpu_torch.models import llama

    rt = ht.init(device="cpu")
    assert rt.core is not None, "the native controller is not up"
    assert rt.heartbeat is not None, "heartbeats are off (--postmortem)"
    assert hvd.chaos.active() is not None, "no chaos injector installed"
    rank = ht.rank()
    cfg = llama.CONFIGS["tiny"]
    model = llama.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    opt = ht.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=1e-3),
        named_parameters=model.named_parameters())
    ht.broadcast_parameters(model.state_dict(), root_rank=0)
    step = hvd.make_train_step(model, llama.loss_fn, opt)
    rng = np.random.RandomState(0)
    for i in range(6):
        with open(os.path.join(out_dir, f"step.{rank}.{i}"), "w") as f:
            f.write(repr(time.time()))
        hvd.postmortem.record_step(i)
        hvd.chaos.step(i)  # the spec's kill or stall fires here
        loss = float(step(torch.from_numpy(rng.randint(
            0, cfg.vocab, (4, 17)).astype(np.int64))))
        assert math.isfinite(loss), (i, loss)
        time.sleep(0.4)  # heartbeats flow between steps
    print(f"FORENSICS-TRAIN-OK {rank}", flush=True)
    ht.shutdown()
    return 0


def nan(out_dir: str) -> int:
    import torch
    torch.set_num_threads(1)
    import horovod_tpu_torch as hvd
    import horovod_tpu_torch.torch as ht
    from horovod_tpu_torch.postmortem import parse_flight_record

    rt = ht.init(device="cpu")
    assert rt.core is not None and rt.metrics_publisher is not None
    rank = ht.rank()
    # a point of the nonfinite counter at 0 before the NaN, so the rule's
    # rate of change sees the counter move
    assert rt.metrics_publisher.publish_now()
    time.sleep(0.5)

    def step(x):
        x = x.clone().requires_grad_(True)
        loss = (x ** 2).sum()
        loss.backward()
        return loss.detach(), x.grad

    wrapped = hvd.sentinel.wrap(step)
    for i in range(8):
        bad = rank == 1 and i == NAN_STEP
        x = torch.full((4,), float("nan") if bad else 1.0)
        _, grads = wrapped(x)
        synced = ht.allreduce(grads, name=f"g{i}", op=hvd.Sum)
        assert math.isfinite(float(synced[0])) == (i != NAN_STEP), \
            (i, synced)
    hvd.sentinel.drain()
    time.sleep(0.5)
    assert rt.metrics_publisher.publish_now()
    if rank == 1:
        flight = os.environ["HOROVOD_FLIGHT_RECORD"] + ".nan"
        assert os.path.exists(flight), f"no flight dump at {flight}"
        fr = parse_flight_record(flight)
        assert f"nan step={NAN_STEP}" in fr["reason"], fr["reason"]
        assert fr["complete"], "torn flight dump"
        fams = hvd.metrics_snapshot()["families"]
        total = sum(s["value"] for s in
                    fams["hvd_sentinel_nonfinite_total"]["samples"])
        assert total == 1, fams["hvd_sentinel_nonfinite_total"]
    verdict = _poll_alert("sentinel-nonfinite", 1)
    assert verdict is not None, "sentinel-nonfinite never fired"
    assert verdict["severity"] == "critical", verdict
    ctx = verdict.get("context") or {}
    assert ctx.get("hvd_sentinel_last_nonfinite_step") == NAN_STEP, verdict
    print(f"FORENSICS-NAN-OK {rank}", flush=True)
    # the peer may still be polling: leave together
    ht.allreduce(torch.ones(1), name="done")
    ht.shutdown()
    return 0


REDUCE_STEPS = 4
REDUCE_NAN_STEP = 2


def reduce(out_dir: str) -> int:
    import numpy as np
    import torch
    torch.set_num_threads(1)
    import horovod_tpu_torch as hvd
    import horovod_tpu_torch.torch as ht
    from horovod_tpu_torch.models import llama
    from horovod_tpu_torch.utils import metrics as M
    from horovod_tpu_torch.watch import sentinel as S

    rt = ht.init(device="cpu")
    assert rt.core is not None, "the native controller is not up"
    rank = ht.rank()
    cfg = llama.CONFIGS["tiny"]
    rng = np.random.RandomState(100 + rank)  # each rank its own batches
    rows = []
    for path in ("direct", "hook"):
        api = hvd if path == "direct" else ht
        model = llama.init(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
        params = list(model.parameters())
        opt = api.DistributedOptimizer(
            torch.optim.AdamW(model.parameters(), lr=1e-3),
            named_parameters=model.named_parameters())
        api.broadcast_parameters(model.state_dict(), root_rank=0)
        # the direct path has made no negotiated op: the sentinel's
        # reduction is a dist.all_reduce there, and the engine's after
        assert (rt.eager is None) == (path == "direct"), path
        seen = {}

        def fwd_bwd(ids):
            opt.zero_grad(set_to_none=True)
            loss = llama.loss_fn(model, ids)
            loss.backward()
            return loss, [p.grad for p in params]

        def extract(out):
            loss, grads = out
            if seen["poison"]:
                bad = grads[0].clone()
                bad.view(-1)[0] = float("nan")
                grads = [bad] + grads[1:]
            if path == "hook" and rank == 0:
                # the ranks pump at their own times: rank 0 runs every
                # gradient allreduce before it reduces, rank 1 none
                rt.eager.drain()
            seen["local"] = S.packed_stats(loss, grads).tolist()
            seen["pending"] = (len(rt.eager._pending)
                               if rt.eager is not None else 0)
            return loss, grads

        wrapped = hvd.sentinel.wrap(fwd_bwd, axis_name="hvd",
                                    extract=extract)
        for i in range(REDUCE_STEPS):
            seen["poison"] = rank == 1 and i == REDUCE_NAN_STEP
            wrapped(torch.from_numpy(rng.randint(
                0, cfg.vocab, (2, 17)).astype(np.int64)))
            opt.step()
            rows.append({
                "path": path, "step": i, "local": seen["local"],
                "pending": seen["pending"],
                "loss": M.SENTINEL_LOSS.value(),
                "grad_norm": M.SENTINEL_GRAD_NORM.value(),
                "nonfinite_total": M.SENTINEL_NONFINITE.value(),
                "last_nonfinite_step":
                    M.SENTINEL_LAST_NONFINITE_STEP.value()})
    with open(os.path.join(out_dir, f"reduce.{rank}.json"), "w") as f:
        json.dump(rows, f)
    print(f"FORENSICS-REDUCE-OK {rank}", flush=True)
    ht.shutdown()
    return 0


def straggler(out_dir: str) -> int:
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    import horovod_tpu_torch as hvd
    import horovod_tpu_torch.torch as ht

    rt = ht.init(device="cpu")
    assert rt.core is not None and rt.metrics_publisher is not None
    assert hvd.chaos.active() is not None, "no chaos injector installed"
    rank = ht.rank()
    # align the ranks outside the negotiated path, so no negotiation age
    # carries one rank's start-up wait
    dist.barrier()
    published = _get_json("/alerts/rules")
    names = {r["name"] for r in published["rules"]}
    assert {"forensics-test-user-rule", "straggler-suspect"} <= names, names
    x = torch.full((4,), float(rank + 1))
    # no collector pause may make rank 1 late for a tick (that wait would
    # land in rank 0's ages)
    gc.disable()
    start = time.monotonic()
    verdict = None
    for i in range(30):
        # paced ticks: the 40 ms stall stays inside rank 1's own window,
        # so rank 0 never waits for it and only rank 1's ages grow
        deadline = start + i * 0.3
        now = time.monotonic()
        if deadline > now:
            time.sleep(deadline - now)
        out = ht.allreduce(x, name=f"w{i}", op=hvd.Sum)
        assert torch.allclose(out, torch.full((4,), 3.0)), out
        # in flight: read /alerts between ticks, where the pace leaves
        # room, and keep the first firing entry; a later fast tick of
        # rank 0 may bring the skew back under the threshold and resolve
        # an alert that fired while the job ran
        if verdict is None and \
                time.monotonic() + _ALERT_READ_S < deadline + 0.3:
            verdict = _firing("straggler-suspect", 1)
    gc.enable()
    assert rt.metrics_publisher.publish_now()
    if verdict is None:
        verdict = _poll_alert("straggler-suspect", 1)
    assert verdict is not None, "straggler-suspect never fired"
    assert verdict["severity"] == "warning" and verdict["value"] >= 4.0, \
        verdict
    assert not [f for f in _get_json("/alerts")["firing"]
                if f["rule"] == "straggler-suspect" and f["rank"] == 0]
    merged = _get_json("/timeline")
    lanes = {e["pid"] for e in merged["traceEvents"]
             if e.get("name") == "alert.straggler-suspect"}
    assert lanes == {1}, lanes
    print(f"FORENSICS-STRAGGLER-OK {rank}", flush=True)
    dist.barrier()
    ht.shutdown()
    return 0


if __name__ == "__main__":
    mode, out_dir = sys.argv[1], sys.argv[2]
    sys.exit({"train": train, "nan": nan, "reduce": reduce,
              "straggler": straggler}[mode](out_dir))
