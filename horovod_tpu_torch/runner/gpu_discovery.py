"""This host's GPU slots: the port's counterpart of
``horovod_tpu/runner/tpu_discovery.py``.

The TPU launcher asks the slice's runtime for its worker hosts, one
process per host.  The port runs one process per card, and NCCL cannot put
two ranks on one card, so what ``--gpu`` discovers is the number of cards
this host lets a process see: the GPUs ``nvidia-smi -L`` lists, cut to the
ones ``CUDA_VISIBLE_DEVICES`` names when it is set.  The launcher never
touches CUDA itself (no ``torch.cuda`` call, so no CUDA context in the
process that spawns the workers); a worker picks ``cuda:<local rank>``
among its visible cards (``runtime.py``).

On a machine with no card (no ``nvidia-smi``, or none listed), discovery
returns None, as the TPU version does off a slice.
"""

from __future__ import annotations

import os
import subprocess
from typing import Callable, List, Optional

from .hosts import HostInfo


def _smi_count() -> int:
    """Cards ``nvidia-smi -L`` lists (one ``GPU <i>: ...`` line each); 0
    when the tool is missing or fails."""
    try:
        out = subprocess.run(["nvidia-smi", "-L"], capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return 0
    if out.returncode != 0:
        return 0
    return sum(1 for line in out.stdout.splitlines()
               if line.startswith("GPU "))


def visible_gpu_count(environ=None,
                      count_fn: Optional[Callable[[], int]] = None) -> int:
    """Cards a process on this host may use: the physical count
    (``count_fn``, default ``nvidia-smi -L``), cut by
    ``CUDA_VISIBLE_DEVICES`` when set.  As CUDA reads that list, an empty
    value hides every card and the list ends at its first negative
    index."""
    env = os.environ if environ is None else environ
    physical = int((count_fn or _smi_count)())
    spec = env.get("CUDA_VISIBLE_DEVICES")
    if spec is None:
        return physical
    named = 0
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry or (entry.lstrip("-").isdigit() and int(entry) < 0):
            break
        named += 1
    return min(named, physical)


def discover_gpu_hosts(slots_per_host: Optional[int] = None,
                       environ=None,
                       count_fn: Optional[Callable[[], int]] = None
                       ) -> Optional[List[HostInfo]]:
    """``[HostInfo("localhost", cards)]`` for this host's visible cards, or
    None when it has none.  ``slots_per_host`` (``--slots``) asks for
    fewer; more than the visible cards raises."""
    cards = visible_gpu_count(environ, count_fn)
    if cards < 1:
        return None
    slots = cards if slots_per_host is None else int(slots_per_host)
    if not 1 <= slots <= cards:
        raise ValueError(
            f"--slots {slots}: this host shows {cards} CUDA device(s), and "
            "NCCL cannot put two ranks on one card")
    return [HostInfo(hostname="localhost", slots=slots)]
