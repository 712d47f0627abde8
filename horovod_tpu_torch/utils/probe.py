"""Fast, killable CUDA reachability probe: the port of
``horovod_tpu/utils/probe.py``.

A card that hangs or a driver that fails can take CUDA's first call in a
process with it, and no in-process watchdog interrupts that.  A
SUBPROCESS can be killed, so the probe asks torch for the devices in a
child with a hard timeout and reports what it saw.  Exposed as
``horovod_tpu_torch.probe_backend`` for interactive sessions and
supervisors ("does a card answer before I call init()?").
"""

from __future__ import annotations

import json
import subprocess
import sys
from typing import Dict, Optional

_CHILD = ("import json, torch; n = torch.cuda.device_count(); "
          "print(json.dumps({'count': n, 'names': "
          "[torch.cuda.get_device_name(i) for i in range(n)], "
          "'torch': torch.__version__, 'cuda': torch.version.cuda}))")


def probe_backend(timeout_s: float = 55.0,
                  env: Optional[Dict[str, str]] = None) -> str:
    """Returns '' when a CUDA device answers, else a human-readable
    reason (probe timeout, the child's exit code and stderr tail, or a
    torch that sees no device).  A CPU-only answer is never healthy.
    ``env`` replaces the child's environment (default: this process's)."""
    try:
        res = subprocess.run([sys.executable, "-c", _CHILD],
                             capture_output=True, text=True,
                             timeout=timeout_s, env=env)
    except subprocess.TimeoutExpired:
        return (f"CUDA backend unreachable: device probe exceeded "
                f"{timeout_s:.0f}s")
    if res.returncode != 0:
        tail = (res.stderr or "").strip().splitlines()[-3:]
        detail = " | ".join(tail) if tail else "no stderr (killed?)"
        return (f"CUDA backend probe failed (rc={res.returncode}): "
                f"{detail}")
    try:
        seen = json.loads((res.stdout or "").strip().splitlines()[-1])
    except (ValueError, IndexError):
        return "CUDA backend probe printed no device list"
    if not seen.get("count"):
        return (f"CUDA expected but torch sees no device (torch "
                f"{seen.get('torch')}, built for CUDA {seen.get('cuda')})")
    return ""
