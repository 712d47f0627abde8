"""Deterministic CPU-platform forcing for smoke modes and tests: the
port's counterpart of ``horovod_tpu/utils/platform.py``.

The JAX package binds its backend through jax's config, which a site
customization can pin to the hardware, so it sets the config as well as
``JAX_PLATFORMS``.  On this stack the device is chosen per process, by
``hvd.init(device=...)`` and CUDA's visible devices (the reference pins
devices per process with ``CUDA_VISIBLE_DEVICES`` at spawn time,
horovod/runner/gloo_run.py).  So:

  * :func:`force_cpu` hides the cards from spawned children
    (``CUDA_VISIBLE_DEVICES=""``) and makes ``hvd.init()`` with no device
    (and every entry point that resolves its device from the runtime)
    take the CPU in this process.  It raises once CUDA is initialized
    here: the process ran too late to be a CPU-only one, and saying so
    beats a job that half runs on a card.
  * :func:`apply_env_platform` makes a process that was handed no card
    (``CUDA_VISIBLE_DEVICES=""`` in its env, as :func:`force_cpu` leaves
    for children) resolve to the CPU as well.

Without either, a process with no card and no ``device="cpu"`` still
raises at ``hvd.init()``: the port never falls back to the CPU silently.
"""

from __future__ import annotations

import os
from typing import Optional

_cpu_forced = False


def cpu_forced() -> bool:
    """Did :func:`force_cpu` or :func:`apply_env_platform` pin this
    process to the CPU?"""
    return _cpu_forced


def force_cpu(virtual_chips: Optional[int] = None) -> None:
    """Force this process (and spawned children) onto the CPU.

    ``virtual_chips`` (the JAX package's count of virtual CPU devices in
    one process) has no counterpart here: a port rank is one process on
    one device, so N CPU ranks are N processes (``launch -np N`` or
    ``hvd.run(fn, np=N)``).  None or 1 is accepted; more raises
    ValueError.

    Safe to call multiple times; raises RuntimeError when CUDA is already
    initialized in this process (the caller ran too late to be a
    CPU-only process)."""
    global _cpu_forced
    if virtual_chips is not None and virtual_chips > 1:
        raise ValueError(
            f"force_cpu(virtual_chips={virtual_chips}): one port rank is "
            "one process on one device; start N CPU ranks with "
            "`launch -np N` or hvd.run(fn, np=N)")
    import torch

    if torch.cuda.is_initialized():
        raise RuntimeError(
            "force_cpu() called after CUDA was initialized in this "
            "process; call it before anything touches a card")
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    _cpu_forced = True


def apply_env_platform() -> None:
    """Pin this process to the CPU when its env hands it no card
    (``CUDA_VISIBLE_DEVICES`` set and empty, as :func:`force_cpu` leaves
    for children).  Task-entry shims call this before unpickling a user
    function.  No-op, importing nothing, when the variable is unset or
    names devices (runs on a card stay untouched)."""
    global _cpu_forced
    if os.environ.get("CUDA_VISIBLE_DEVICES") == "":
        _cpu_forced = True
