"""The worker entry of ``ElasticRayExecutor``: ``python -m
horovod_tpu_torch.ray.elastic_run`` fetches the pickled function from the
driver's rendezvous KV, runs it, and puts this rank's result back
(reference: ray/elastic.py ships the function into the workers; results
return through the object store, here through the KV every elastic
worker dials already)."""

from __future__ import annotations

import io
import os
import pickle
import sys


def main() -> int:
    from ..runner.http_client import get_kv, put_kv
    from ..spark.runner import _to_host
    from .elastic import PAYLOAD_KEY, PAYLOAD_SCOPE, RESULT_SCOPE

    addr = os.environ["HOROVOD_RENDEZVOUS_ADDR"]
    port = int(os.environ["HOROVOD_RENDEZVOUS_PORT"])
    raw = get_kv(addr, port, PAYLOAD_SCOPE, PAYLOAD_KEY)
    if raw is None:
        print("elastic_run: no payload at rendezvous", file=sys.stderr)
        return 1
    buf = io.BytesIO(raw)
    for p in pickle.load(buf):  # the caller's sys.path, see elastic.py
        if p not in sys.path:
            sys.path.append(p)
    # a worker handed no card resolves to the CPU before the function's
    # module (imported by the unpickling) can touch CUDA
    from ..utils.platform import apply_env_platform
    apply_env_platform()
    fn, args, kwargs = pickle.load(buf)
    result = _to_host(fn(*args, **kwargs))
    rank = os.environ.get("HOROVOD_RANK", "0")
    put_kv(addr, port, RESULT_SCOPE, f"rank.{rank}", pickle.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
