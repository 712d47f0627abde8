"""The port's backend probe (``utils/probe.py``), platform helpers
(``utils/platform.py``) and the rest of ``common/util.py``, on the CPU:

  * ``probe_backend`` never calls a CPU-only answer healthy: here (no
    card) it names the torch that sees no device, and a child that does
    not answer in time is reported as a timeout, a child that fails with
    its exit code and stderr tail;
  * ``force_cpu`` hides the cards from children and makes ``hvd.init()``
    take the CPU, and raises once CUDA is initialized in the process
    (monkeypatched here); ``virtual_chips`` above one raises;
    ``apply_env_platform`` pins a process handed no card and imports
    nothing otherwise;
  * ``check_num_rank_power_of_2`` and ``split_list`` agree with the JAX
    package's on the same inputs; ``check_extension`` loads the port's
    native core and turns a build failure into ImportError;
    ``gpu_available`` is False here and in a CPU-pinned process."""

import os
import subprocess
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import pytest  # noqa: E402
import torch  # noqa: E402

import horovod_tpu_torch as hvd  # noqa: E402
from horovod_tpu.common import util as JU  # noqa: E402
from horovod_tpu_torch.common import util as TU  # noqa: E402
from horovod_tpu_torch.utils import platform, probe  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


@pytest.fixture
def unpinned(monkeypatch):
    """Undo what ``force_cpu``/``apply_env_platform`` set, after the test."""
    monkeypatch.setattr(platform, "_cpu_forced", False)
    if "CUDA_VISIBLE_DEVICES" in os.environ:
        monkeypatch.setenv("CUDA_VISIBLE_DEVICES",
                           os.environ["CUDA_VISIBLE_DEVICES"])
    else:
        monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    return monkeypatch


# ------------------------------------------------------------------- probe
def test_probe_backend_gives_a_reason_without_a_card():
    assert torch.cuda.device_count() == 0
    why = hvd.probe_backend(timeout_s=120)
    assert why.startswith("CUDA expected but torch sees no device"), why
    assert torch.__version__ in why


def test_probe_backend_reports_a_hidden_card():
    why = probe.probe_backend(timeout_s=120, env=dict(
        os.environ, CUDA_VISIBLE_DEVICES=""))
    assert why.startswith("CUDA expected but torch sees no device"), why


def test_probe_backend_reports_its_timeout():
    assert probe.probe_backend(timeout_s=0.01) == (
        "CUDA backend unreachable: device probe exceeded 0s")


def test_probe_backend_reports_a_failing_child(monkeypatch):
    monkeypatch.setattr(probe, "_CHILD",
                        "import sys; sys.stderr.write('boom\\n'); "
                        "sys.exit(3)")
    assert probe.probe_backend(timeout_s=60) == (
        "CUDA backend probe failed (rc=3): boom")
    monkeypatch.setattr(probe, "_CHILD", "print('no json')")
    assert probe.probe_backend(timeout_s=60) == (
        "CUDA backend probe printed no device list")


# ---------------------------------------------------------------- platform
def test_force_cpu_pins_init_and_hides_the_cards(unpinned):
    assert not platform.cpu_forced()
    platform.force_cpu()
    platform.force_cpu(virtual_chips=1)  # idempotent; one device a rank
    assert platform.cpu_forced()
    assert os.environ["CUDA_VISIBLE_DEVICES"] == ""
    rt = hvd.init()
    try:
        assert rt.device == torch.device("cpu")
    finally:
        hvd.shutdown()


def test_force_cpu_raises_once_cuda_is_initialized(unpinned):
    unpinned.setenv("CUDA_VISIBLE_DEVICES", "0")
    unpinned.setattr(torch.cuda, "is_initialized", lambda: True)
    with pytest.raises(RuntimeError, match="after CUDA was initialized"):
        platform.force_cpu()
    assert not platform.cpu_forced()
    assert os.environ["CUDA_VISIBLE_DEVICES"] == "0"


def test_force_cpu_refuses_virtual_chips(unpinned):
    with pytest.raises(ValueError, match="-np N"):
        platform.force_cpu(virtual_chips=4)
    assert not platform.cpu_forced()


def test_init_without_a_device_still_raises_unpinned(unpinned):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hvd.init()
    assert not hvd.is_initialized()


def test_apply_env_platform(unpinned):
    unpinned.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    platform.apply_env_platform()
    assert not platform.cpu_forced()
    unpinned.setenv("CUDA_VISIBLE_DEVICES", "0,1")
    platform.apply_env_platform()
    assert not platform.cpu_forced()
    unpinned.setenv("CUDA_VISIBLE_DEVICES", "")
    platform.apply_env_platform()
    assert platform.cpu_forced()
    assert TU.gpu_available() is False


def test_apply_env_platform_imports_nothing_without_env():
    prog = f"""
import importlib.util, os, sys
os.environ.pop("CUDA_VISIBLE_DEVICES", None)
spec = importlib.util.spec_from_file_location(
    "platform_mod", os.path.join({REPO!r}, "horovod_tpu_torch", "utils",
                                 "platform.py"))
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
mod.apply_env_platform()
assert "torch" not in sys.modules, "apply_env_platform imported torch"
assert not mod.cpu_forced()
print("OK")
"""
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and "OK" in out.stdout, out.stderr[-800:]


# -------------------------------------------------------------------- util
@pytest.mark.parametrize("n", [-4, 0, 1, 2, 3, 4, 6, 8, 12, 64, 96, 1024])
def test_check_num_rank_power_of_2_matches_jax(n):
    assert TU.check_num_rank_power_of_2(n) == \
        JU.check_num_rank_power_of_2(n)


@pytest.mark.parametrize("n,parts", [(0, 3), (1, 1), (7, 3), (8, 4),
                                     (5, 8), (13, 5)])
def test_split_list_matches_jax(n, parts):
    items = [f"t{i}" for i in range(n)]
    got = TU.split_list(items, parts)
    assert got == JU.split_list(items, parts)
    assert sum(got, []) == items and len(got) == parts


def test_check_extension_loads_the_native_core(monkeypatch):
    TU.check_extension()
    from horovod_tpu_torch.common import basics

    def broken():
        raise OSError("g++: not found")
    monkeypatch.setattr(basics, "load_library", broken)
    with pytest.raises(ImportError, match="g\\+\\+: not found"):
        TU.check_extension("horovod_tpu_torch.csrc")


def test_gpu_available_without_a_card(unpinned):
    assert TU.gpu_available() is False
    assert TU.gpu_available(verbose=True) is False
    platform.force_cpu()
    assert TU.gpu_available() is False
