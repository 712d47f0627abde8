"""A pytest plugin for tests/torch_port/test_torch_thread_fixtures.py:
loaded with ``-p torch_port_threads_plugin`` in a child pytest, it writes
torch's intra-op thread count at the session's start and at its end (after
every fixture's teardown) to the file ``TORCH_PORT_THREADS_OUT`` names."""

import json
import os

_start = {}


def pytest_configure(config):
    import torch
    _start["threads"] = torch.get_num_threads()


def pytest_sessionfinish(session, exitstatus):
    import torch
    with open(os.environ["TORCH_PORT_THREADS_OUT"], "w") as f:
        json.dump({"start": _start["threads"],
                   "end": torch.get_num_threads(),
                   "exitstatus": int(exitstatus)}, f)
