"""Build and bind the port's CUDA kernels.

``horovod_tpu_torch/csrc/flash_attention.cu`` is compiled by ``nvcc`` for
Hopper (``sm_90a``) into a shared library with a plain C interface and
loaded with ``ctypes``: no PyTorch headers, so a build takes seconds.  It is
built at first use, named by a digest of its source and flags, with the
compiler's output (``-Xptxas -v``: registers, shared memory and spills of
each kernel) kept beside it as ``<library>.log``, into

* ``build/torch_kernels/`` at the root of a source checkout (a directory
  ``.gitignore`` lists), or
* ``$XDG_CACHE_HOME/horovod_tpu_torch/`` (default ``~/.cache``) for an
  installed package, whose directory may be read-only or shared.

Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "flash_attention.cu")


def _build_dir() -> str:
    root = os.path.dirname(_PKG)
    if os.path.exists(os.path.join(root, "pyproject.toml")):
        return os.path.join(root, "build", "torch_kernels")
    cache = os.environ.get("XDG_CACHE_HOME") or os.path.join(
        os.path.expanduser("~"), ".cache")
    return os.path.join(cache, "horovod_tpu_torch")


BUILD_DIR = _build_dir()

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# hvd_kernel_resources' kernel numbers
KERNEL_IDS = {"flash_fwd": 0, "flash_bwd_dq": 1, "flash_bwd_dkv": 2}

_LIB: Optional[ctypes.CDLL] = None


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``nvcc`` on PATH, or the
    toolkit's default location.  Raises when there is none."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
        "kernels of horovod_tpu_torch cannot be built")


def library_path() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR,
                        f"libflash_attention_{digest.hexdigest()[:12]}.so")


def build() -> str:
    """Compile the library unless it is already built; return its path.
    Raises with the compiler's output if the build fails."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", tmp, SOURCE],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    log = proc.stdout.decode(errors="replace")
    if proc.returncode != 0:
        raise RuntimeError("nvcc failed on flash_attention.cu:\n" + log)
    with open(f"{tmp}.log", "w") as f:
        f.write(log)
    os.replace(f"{tmp}.log", f"{out}.log")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out


def load() -> ctypes.CDLL:
    """The bound kernel library, built on first use."""
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = ctypes.CDLL(build())
    # pointers and the stream as c_void_p: a bare int would be cut to 32 bits
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    # (q, k, v, out, lse | B, S, H, HK, D, causal, bf16 | stream)
    lib.hvd_flash_fwd.argtypes = [ptr] * 5 + [i32] * 7 + [ptr]
    # (q, k, v, dO, lse, delta, dq | ... | stream)
    lib.hvd_flash_bwd_dq.argtypes = [ptr] * 7 + [i32] * 7 + [ptr]
    # (q, k, v, dO, lse, delta, dk, dv | ... | stream)
    lib.hvd_flash_bwd_dkv.argtypes = [ptr] * 8 + [i32] * 7 + [ptr]
    for f in (lib.hvd_flash_fwd, lib.hvd_flash_bwd_dq, lib.hvd_flash_bwd_dkv):
        f.restype = i32  # the launch's cudaError_t
    # (kernel, D, bf16, int[4] out)
    lib.hvd_kernel_resources.argtypes = [i32, i32, i32, ptr]
    lib.hvd_kernel_resources.restype = i32
    lib.hvd_error_string.argtypes = [i32]
    lib.hvd_error_string.restype = ctypes.c_char_p
    _LIB = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise when a launch function returned a CUDA error."""
    if err != 0:
        msg = lib.hvd_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def resources(kernel: str, D: int, bf16: bool) -> dict:
    """One kernel instantiation's launch resources on the current CUDA
    device, as the runtime reports them: static and dynamic shared memory
    per block, threads per block and resident blocks per SM."""
    lib = load()
    out = (ctypes.c_int * 4)()
    check(lib, lib.hvd_kernel_resources(KERNEL_IDS[kernel], D, int(bf16),
                                        ctypes.addressof(out)),
          f"resources of {kernel}")
    keys = ("static_smem", "dynamic_smem", "threads", "blocks_per_sm")
    return dict(zip(keys, out))
