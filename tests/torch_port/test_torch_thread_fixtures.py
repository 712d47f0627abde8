"""The fixtures that run the port's tests on one CPU thread
(``test_torch_eager_ops.py``'s module fixture ``runtimes``,
``test_torch_wire.py``'s ``runtime``) give the thread count back: under
``--dist loadfile`` one xdist worker runs many files in one process, and
a count left at 1 made a later file's fp32 gradients round differently
(``test_torch_zoo_inception.py`` failed in the six-worker run).  A child
pytest runs one test of each file with OMP_NUM_THREADS=3 and reports the
count at its start and after every teardown."""

import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))


def test_one_thread_fixtures_restore_the_thread_count(tmp_path):
    out = tmp_path / "threads.json"
    env = dict(os.environ, OMP_NUM_THREADS="3", JAX_PLATFORMS="cpu",
               TORCH_PORT_THREADS_OUT=str(out))
    env["PYTHONPATH"] = os.pathsep.join(
        [HERE, REPO] + [p for p in env.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    res = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "-p", "no:randomly", "-p", "torch_port_threads_plugin",
         os.path.join(HERE, "test_torch_wire.py")
         + "::test_set_overlap_only_between_cycles",
         os.path.join(HERE, "test_torch_eager_ops.py")
         + "::test_eager_ops_single_rank"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    got = json.loads(out.read_text())
    assert got == {"start": 3, "end": 3, "exitstatus": 0}, got
