"""One worker of ``run()`` (``runner/api.py``), started by the launcher:
``python -m horovod_tpu_torch.runner.task``.  It reads the pickled
``(func, args, kwargs)`` from the rendezvous KV (scope ``run``, key
``fn``), calls it, and puts ``("ok", result)`` or ``("error",
traceback)`` under ``result.<rank>``; a failure exits 1, so the launcher
ends the other ranks."""

from __future__ import annotations

import os
import pickle
import sys
import traceback


def main() -> int:
    from .api import SCOPE
    from .http_client import get_kv, put_kv
    addr = os.environ["HOROVOD_RENDEZVOUS_ADDR"]
    port = int(os.environ["HOROVOD_RENDEZVOUS_PORT"])
    rank = os.environ["HOROVOD_RANK"]
    try:
        raw = get_kv(addr, port, SCOPE, "fn")
        if raw is None:
            raise RuntimeError("no function at the rendezvous (scope "
                               f"{SCOPE!r}, key 'fn')")
        # a worker handed no card resolves to the CPU before the user's
        # module (imported by the unpickling) can touch CUDA
        from ..utils.platform import apply_env_platform
        apply_env_platform()
        func, args, kwargs = pickle.loads(raw)
        out = ("ok", func(*args, **kwargs))
        code = 0
    except BaseException:
        out = ("error", traceback.format_exc())
        code = 1
    try:
        payload = pickle.dumps(out)
    except Exception:
        payload = pickle.dumps(("error", "result not picklable:\n"
                                + traceback.format_exc()))
        code = 1
    put_kv(addr, port, SCOPE, f"result.{rank}", payload)
    if code:
        print(out[1], file=sys.stderr, flush=True)
    return code


if __name__ == "__main__":
    sys.exit(main())
