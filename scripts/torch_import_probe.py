"""What a fresh Python process pays to import the port's stack, with and
without a bytecode cache.

Four processes in turn each time ``import torch``, ``import
torch._dynamo`` (which the first ``AdamW.step`` of a process runs) and
``import horovod_tpu_torch``: first in this process's env, then with
``PYTHONDONTWRITEBYTECODE`` removed and ``PYTHONPYCACHEPREFIX`` at
``build/pycache`` (what ``chip_smoke.py`` ``keep_bytecode`` sets for the
processes it starts), so the first of those writes the cache and the rest
read it.  Prints each process's import seconds and its wall seconds, and
the files the cache holds.  Run from the repository's root:
``python3 scripts/torch_import_probe.py``.
"""

import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROG = ("import time; t = time.time(); import torch; t1 = time.time(); "
        "import torch._dynamo; t2 = time.time(); "
        "import horovod_tpu_torch; t3 = time.time(); "
        "print(f'torch {t1 - t:.2f} dynamo {t2 - t1:.2f} hvd {t3 - t2:.2f}')")


def run(label: str, env: dict) -> None:
    for i in range(4):
        t0 = time.time()
        out = subprocess.run([sys.executable, "-c", PROG], env=env, cwd=ROOT,
                             capture_output=True, text=True,
                             check=True).stdout.strip()
        print(f"{label} {i}: {out}; process {time.time() - t0:.2f} s",
              flush=True)


def main() -> None:
    env = dict(os.environ)
    print(f"PYTHONDONTWRITEBYTECODE={env.get('PYTHONDONTWRITEBYTECODE')!r}",
          flush=True)
    run("plain", env)
    env.pop("PYTHONDONTWRITEBYTECODE", None)
    env["PYTHONPYCACHEPREFIX"] = os.path.join(ROOT, "build", "pycache_probe")
    shutil.rmtree(env["PYTHONPYCACHEPREFIX"], ignore_errors=True)
    run("cache", env)
    n = sum(len(files) for _, _, files in os.walk(env["PYTHONPYCACHEPREFIX"]))
    print(f"build/pycache_probe: {n} files", flush=True)


if __name__ == "__main__":
    main()
