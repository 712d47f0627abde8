"""LSF allocation host discovery: the port's copy of
``horovod_tpu/runner/lsf.py`` (covers the role of the reference's
runner/util/lsf.py:1-103, by a different mechanism).

Inside an LSF job (`bsub`), the scheduler publishes the allocated hosts
— ``LSB_DJOB_HOSTFILE`` points at a file listing one hostname per
granted slot (repeats = slot count), with ``LSB_HOSTS`` as the inline
fallback.  The launcher consumes that allocation automatically so LSF users launch
with a bare ``python -m horovod_tpu_torch.runner.launch python train.py``.

Mechanism note for parity auditing: the reference queries CSM
(``csm_allocation_query`` — compute nodes x gpus-per-node), which only
exists on CORAL/Summit-class systems; the LSB_* variables are standard
LSF on any cluster, so slot counts here come from hostname multiplicity
and may include the launch host that CSM would exclude.  Use explicit
``-H`` where that distinction matters.

Deliberately NOT ported: the reference's jsrun/Spectrum-MPI launch
vector (runner/js_run.py:1-146).  jsrun is IBM's MPI process starter
for Summit-class GPU machines; this framework's slot executor launches
over ssh/subprocess, which works in an LSF allocation without an MPI
runtime.  docs/migration.md records the decision.
"""

from __future__ import annotations

import os
from typing import List, Optional

from .hosts import HostInfo


def lsf_hosts(environ=None) -> Optional[List[HostInfo]]:
    """Hosts of the surrounding LSF allocation, or None outside LSF.

    Slot counts come from hostname multiplicity, the LSF convention for
    expressing cores-per-host in both the hostfile and LSB_HOSTS."""
    env = os.environ if environ is None else environ
    names: List[str] = []
    hostfile = env.get("LSB_DJOB_HOSTFILE", "").strip()
    if hostfile:
        try:
            with open(hostfile) as f:
                names = [ln.strip() for ln in f if ln.strip()]
        except OSError:
            names = []
    if not names:
        names = env.get("LSB_HOSTS", "").split()
    if not names:
        return None
    counts: dict = {}
    for n in names:  # insertion order = allocation order (rank 0 first)
        counts[n] = counts.get(n, 0) + 1
    return [HostInfo(hostname=h, slots=c) for h, c in counts.items()]
