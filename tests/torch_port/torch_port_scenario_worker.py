"""One rank of the scenario plane's launch test
(tests/torch_port/test_torch_scenario_launch.py), started by the port's
launcher, ``python -m horovod_tpu_torch.runner.launch -np 2 --chaos BASE
--scenario SPEC python torch_port_scenario_worker.py``, on gloo ranks.
Imports torch and horovod_tpu_torch only, never JAX.

Each rank checks the three distribution legs from inside the fleet, as
the JAX package's ``tests/integration/scenario_worker.py`` does:

  1. the spec rides the rendezvous KV at scope ``scenario`` as JSON, and
     regenerating the trace from it gives the same digest on every rank
     (the ranks are separate interpreters, PYTHONHASHSEED not pinned);
  2. the storm arrived in the merged chaos spec, so the chaos injector is
     installed and carries the storm's stall after the ``--chaos`` one;
  3. the spec's embedded alert rule is in the ruleset published at KV
     scope ``alerts``, beside the defaults.

Then one gloo allreduce, and the rank prints ``SCENARIO-KV-OK <rank>
<digest>``."""

import json
import os
import sys
import urllib.request

import torch
import torch.distributed as dist

import horovod_tpu_torch as hvd
from horovod_tpu_torch.runner.http_client import get_kv
from horovod_tpu_torch.scenario import (KV_KEY, KV_SCOPE, events_digest,
                                        generate_events, loads_scenario)


def _get_json(path: str):
    addr = os.environ["HOROVOD_RENDEZVOUS_ADDR"]
    port = os.environ["HOROVOD_RENDEZVOUS_PORT"]
    with urllib.request.urlopen(f"http://{addr}:{port}{path}",
                                timeout=10) as r:
        return json.loads(r.read())


def main() -> int:
    hvd.init(device="cpu")
    assert hvd.size() == 2
    rank = hvd.rank()

    raw = get_kv(os.environ["HOROVOD_RENDEZVOUS_ADDR"],
                 int(os.environ["HOROVOD_RENDEZVOUS_PORT"]),
                 KV_SCOPE, KV_KEY, timeout=10)
    assert raw, "scenario spec not published on the rendezvous KV"
    spec = loads_scenario(raw.decode())
    assert spec.name == "integration-smoke", spec.name
    digest = events_digest(
        generate_events(spec.seed, spec.phases, spec.vocab))
    digests = hvd.allgather_object(digest)
    assert len(set(digests)) == 1, \
        f"trace digests diverged across ranks: {digests}"

    injector = hvd.chaos.active()
    assert injector is not None, \
        "chaos injector not installed from the scenario storm"
    kinds = [(e.kind, e.step, e.point) for e in injector.spec.events]
    assert kinds == [("stall", 100000, "complete"), ("stall", 50, "")], \
        kinds

    names = {r["name"] for r in _get_json("/alerts/rules")["rules"]}
    assert "scenario-smoke-rule" in names, names
    assert "straggler-suspect" in names, names

    x = torch.full((4,), float(rank + 1))
    dist.all_reduce(x)
    assert torch.equal(x, torch.full((4,), 3.0)), x

    print(f"SCENARIO-KV-OK {rank} {digest}", flush=True)
    hvd.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
