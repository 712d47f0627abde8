"""One rank of the port's serving-fleet lockstep test
(``test_torch_serve_launch.py``), started by the port's launcher with
``-np 2``: the port's twin of ``tests/integration/serve_worker.py``.

Every rank builds the same engine from the servable in $SERVE_TEST_DIR on
the CPU and runs ``serve.worker.FleetFrontend`` against the launcher's
rendezvous KV: rank 0 drains the request scope and publishes the plan
stream, rank 1 follows it.  A client thread on rank 0 plays the router:
it enqueues the requests with dense sequence numbers and waits for their
``.done`` records.  Each rank prints the digest of its finished
``{req_id: tokens}`` and the tokens themselves.
"""

import hashlib
import json
import os
import sys
import threading

N_REQUESTS = 3
MAX_NEW = 4


def main() -> int:
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.runner import http_client
    from horovod_tpu_torch.serve.config import ServeConfig
    from horovod_tpu_torch.serve.engine import ServeEngine, load_servable
    from horovod_tpu_torch.serve.router import OUT_SCOPE, REQ_SCOPE, req_key
    from horovod_tpu_torch.serve.worker import FleetFrontend

    rt = hvd.init(device="cpu")
    assert hvd.size() == 2, hvd.size()
    addr = rt.knobs["HOROVOD_RENDEZVOUS_ADDR"]
    port = int(rt.knobs["HOROVOD_RENDEZVOUS_PORT"])
    assert addr and port, "the launcher provides the rendezvous KV"
    _, cfg, model = load_servable(os.environ["SERVE_TEST_DIR"],
                                  device="cpu")
    scfg = ServeConfig(max_slots=2, block_size=4, cache_blocks=32,
                       max_seq_len=32, max_batch_tokens=16, prefill_chunk=8)
    engine = ServeEngine(model, scfg, device="cpu")

    # every rank records its own finished tokens: lockstep is per rank
    finished = {}
    orig_step = engine.step

    def recording_step():
        rep = orig_step()
        for r in rep["finished"]:
            finished[r.req_id] = list(r.out_tokens)
        return rep

    engine.step = recording_step

    if hvd.rank() == 0:
        def client():
            prompts = [[(7 * i + j) % cfg.vocab for j in range(5 + 2 * i)]
                       for i in range(N_REQUESTS)]
            for i, toks in enumerate(prompts):
                http_client.put_kv(addr, port, REQ_SCOPE, req_key(i),
                                   json.dumps({
                                       "id": req_key(i), "tokens": toks,
                                       "max_new_tokens": MAX_NEW}).encode())
            for i in range(N_REQUESTS):
                raw = http_client.get_kv(addr, port, OUT_SCOPE,
                                         f"{req_key(i)}.done", timeout=60)
                assert raw is not None, f"no done record for req {i}"
                done = json.loads(raw)
                assert len(done["tokens"]) == MAX_NEW, done
                assert done["ttft_s"] and done["ttft_s"] > 0, done
            print("CLIENT-OK", flush=True)

        threading.Thread(target=client, daemon=True).start()

    frontend = FleetFrontend(engine, addr, port, hvd.rank(), hvd.size())
    frontend.run(ttl_s=4.0)
    assert len(finished) == N_REQUESTS, sorted(finished)
    digest = hashlib.sha1(json.dumps(
        sorted(finished.items())).encode()).hexdigest()[:16]
    print(f"SERVE-OK rank {hvd.rank()} sched {engine.sched_digest} "
          f"tokens {json.dumps(sorted(finished.items()))} digest {digest}",
          flush=True)
    hvd.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
