"""Build the port's own copy of the native coordination core.

``horovod_tpu_torch/csrc/core/`` holds the controller, its loopback and TCP
transports, the stall and cache machinery and their C API: a copy of the
JAX package's ``csrc/`` sources (six ``.cc`` files, eight headers), so the
port neither loads nor rebuilds the JAX package's library.  ``g++``
compiles each file (all at once, one process per file) with the flags of
``csrc/Makefile`` and links ``libhvd_torch_core-<digest>.so``, named by a
digest of the sources and the flags, into

* ``build/torch_core/`` at the root of a source checkout (a directory
  ``.gitignore`` lists), or
* ``$XDG_CACHE_HOME/horovod_tpu_torch/torch_core/`` (default ``~/.cache``)
  for an installed package.

Builders running at once (test workers) take turns on a lock file, and the
library is moved into place whole, so a loader never sees half a file.
Nothing is written beside the sources, and nothing here runs at import
time.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE_DIR = os.path.join(_PKG, "csrc", "core")
SOURCES = ("transport.cc", "controller.cc", "core.cc", "optim.cc",
           "postmortem.cc", "c_api.cc")
HEADERS = ("common.h", "trace.h", "transport.h", "controller.h", "core.h",
           "optim.h", "postmortem.h", "window.h")
CXX_FLAGS = ["-O2", "-fPIC", "-std=c++17", "-Wall", "-Wextra", "-pthread"]
LD_FLAGS = ["-shared", "-pthread"]


def build_dir() -> str:
    root = os.path.dirname(_PKG)
    if os.path.exists(os.path.join(root, "pyproject.toml")):
        return os.path.join(root, "build", "torch_core")
    cache = os.environ.get("XDG_CACHE_HOME") or os.path.join(
        os.path.expanduser("~"), ".cache")
    return os.path.join(cache, "horovod_tpu_torch", "torch_core")


def library_path() -> str:
    digest = hashlib.sha256(" ".join(CXX_FLAGS + LD_FLAGS).encode())
    for name in SOURCES + HEADERS:
        with open(os.path.join(SOURCE_DIR, name), "rb") as f:
            digest.update(name.encode() + b"\0" + f.read())
    return os.path.join(build_dir(),
                        f"libhvd_torch_core-{digest.hexdigest()[:12]}.so")


def _compile(out: str) -> None:
    cxx = os.environ.get("CXX") or shutil.which("g++") or "g++"
    with tempfile.TemporaryDirectory(dir=os.path.dirname(out)) as tmp:
        objs, procs = [], []
        for src in SOURCES:
            obj = os.path.join(tmp, src[:-3] + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [cxx, *CXX_FLAGS, "-c", os.path.join(SOURCE_DIR, src),
                 "-o", obj], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT)))
        failed = []
        for src, proc in procs:
            log = proc.communicate()[0].decode(errors="replace")
            if proc.returncode != 0:
                failed.append(f"{src}:\n{log}")
        if failed:
            raise RuntimeError("g++ failed on the native core:\n"
                               + "\n".join(failed))
        lib = os.path.join(tmp, "lib.so")
        proc = subprocess.run([cxx, *LD_FLAGS, "-o", lib, *objs],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        if proc.returncode != 0:
            raise RuntimeError("linking the native core failed:\n"
                               + proc.stdout.decode(errors="replace"))
        os.replace(lib, out)


def build() -> str:
    """Compile the library unless it is already built; return its path.
    Raises with the compiler's output if the build fails."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(os.path.join(os.path.dirname(out), ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(out):  # another builder may have finished
            _compile(out)
    return out
