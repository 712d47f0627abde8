"""``horovod_tpu_torch.ray`` against ``horovod_tpu.ray``: the Ray cases of
``tests/test_spark_ray.py`` on the port (the local pool's env and
results, ``start`` required, a failure propagated, the ray pool and the
ray discovery requiring ray, ``ElasticRayExecutor`` running a function
elastically and propagating a failure), and the port's own rules (the
same per-rank env as the JAX executor's, tensors back on the CPU, a dead
worker, the payload's records, a ``__main__`` function without
cloudpickle).  Workers are local processes (``spawn``) or the elastic
driver's; every test that starts them has a time limit of its own and
its ports from ``hold_ports``."""

import io
import os
import pickle
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import pytest  # noqa: E402
import torch  # noqa: E402

from horovod_tpu_torch.elastic.discovery import FixedHosts  # noqa: E402
from horovod_tpu_torch.ray import (ElasticRayExecutor,  # noqa: E402
                                   LocalWorkerPool, RayExecutor)
from horovod_tpu_torch.ray import elastic as E  # noqa: E402
from horovod_tpu_torch.runner.hosts import HostInfo  # noqa: E402

import torch_port_cluster_worker as W  # noqa: E402
from torch_port_deadline import deadline  # noqa: E402
from torch_port_ports import hold_ports  # noqa: E402


def _executor(n):
    return RayExecutor(num_workers=n, pool=LocalWorkerPool(),
                       coordinator_port=hold_ports(1).release()[0])


def _elastic(n, **kw):
    coord, ctrl = hold_ports(2).release()
    return ElasticRayExecutor(
        min_np=n, max_np=n, discovery=FixedHosts([HostInfo("localhost", n)]),
        coordinator_port=coord, controller_port=ctrl, **kw)


# ------------------------------------------------ tests/test_spark_ray.py
def test_ray_executor_local_pool_env_and_results():
    ex = _executor(3)
    try:
        with deadline(60, "RayExecutor on three local workers"):
            ex.start()
            out = ex.run(W.env_report)
            out2 = ex.execute(W.add, args=(1,), kwargs={"b": 1})
    finally:
        ex.shutdown()
    assert [int(r) for r, _, _ in out] == [0, 1, 2]
    assert all(s == "3" for _, s, _ in out)
    assert out2 == [2, 3, 4]


def test_ray_executor_requires_start():
    ex = RayExecutor(num_workers=1, pool=LocalWorkerPool())
    with pytest.raises(RuntimeError, match="start"):
        ex.run(W.env_report)


def test_ray_executor_propagates_failure():
    ex = _executor(2)
    try:
        with deadline(60, "RayExecutor of a failing function"):
            ex.start()
            with pytest.raises(RuntimeError, match="worker exploded"):
                ex.run(W.fail)
            # the pool still answers after a failure: every pipe was read
            assert ex.run(W.add, args=(0, 0)) == [0, 1]
    finally:
        ex.shutdown()


def test_ray_pool_requires_ray():
    try:
        import ray  # noqa: F401
        pytest.skip("ray installed; the gate does not apply")
    except ImportError:
        pass
    from horovod_tpu_torch.ray import RayWorkerPool
    with pytest.raises(ImportError, match="LocalWorkerPool"):
        RayWorkerPool()
    with pytest.raises(ImportError, match="LocalWorkerPool"):
        RayExecutor(num_workers=1)


def test_elastic_ray_executor_runs_function_elastically():
    ex = _elastic(2, elastic_timeout=60)
    ex.start()
    with deadline(120, "ElasticRayExecutor on two workers"):
        out = ex.run(W.env_report)
        out2 = ex.run(W.add, args=(10,), kwargs={"b": 1})
    ex.shutdown()
    assert [int(r) for r, _, _ in out] == [0, 1]
    assert all(s == "2" for _, s, _ in out)
    assert out2 == [11, 12]


def test_elastic_ray_executor_requires_start():
    ex = ElasticRayExecutor(min_np=1)
    with pytest.raises(RuntimeError, match="start"):
        ex.run(W.env_report)


def test_elastic_ray_executor_propagates_failure():
    ex = _elastic(1, elastic_timeout=5, reset_limit=1)
    ex.start()
    with deadline(60, "ElasticRayExecutor of a failing function"):
        with pytest.raises(RuntimeError, match="elastic run failed"):
            ex.run(W.fail)


def test_ray_host_discovery_requires_ray():
    try:
        import ray  # noqa: F401
        pytest.skip("ray installed; the gate does not apply")
    except ImportError:
        pass
    from horovod_tpu_torch.ray import RayHostDiscovery
    with pytest.raises(ImportError, match="ray"):
        RayHostDiscovery()
    ex = ElasticRayExecutor(min_np=1)  # no discovery: start needs ray
    with pytest.raises(ImportError, match="FixedHosts"):
        ex.start()


# ------------------------------------------------------- the port's rules
def test_same_env_as_the_jax_executor():
    from horovod_tpu.ray import LocalWorkerPool as JaxPool
    from horovod_tpu.ray import RayExecutor as JaxExecutor
    keys = ("HOROVOD_RANK", "HOROVOD_SIZE", "HOROVOD_LOCAL_RANK",
            "HOROVOD_LOCAL_SIZE", "HOROVOD_CROSS_RANK",
            "HOROVOD_CROSS_SIZE", "HOROVOD_COORDINATOR_ADDR", "EXTRA")
    port = hold_ports(1).release()[0]
    got, want = [], []
    for cls, pool, out in ((RayExecutor, LocalWorkerPool, got),
                           (JaxExecutor, JaxPool, want)):
        ex = cls(num_workers=2, pool=pool(), coordinator_port=port,
                 env={"EXTRA": "x"})
        try:
            with deadline(120, f"{cls.__module__} on two workers"):
                ex.start()
                out.extend(ex.run(W.env_block, args=(keys,)))
        finally:
            ex.shutdown()
    assert got == want
    assert [g["HOROVOD_RANK"] for g in got] == ["0", "1"]


def test_tensors_come_back_on_the_cpu():
    ex = _executor(2)
    try:
        with deadline(60, "RayExecutor returning tensors"):
            ex.start()
            out = ex.run(W.tensors)
    finally:
        ex.shutdown()
    for r, got in enumerate(out):
        assert got["t"].device.type == "cpu"
        assert torch.equal(got["t"], torch.full((2,), float(r)))


def test_a_dead_worker_raises():
    ex = _executor(1)
    try:
        with deadline(60, "RayExecutor of a worker that dies"):
            ex.start()
            with pytest.raises(RuntimeError, match="died"):
                ex.run(W.exit_hard)
    finally:
        ex.shutdown()


def test_the_payload_carries_the_callers_path_first():
    raw = E._serialize_closure(W.add, (1,), {"b": 2})
    buf = io.BytesIO(raw)
    assert pickle.load(buf) == list(sys.path)
    fn, args, kwargs = pickle.load(buf)
    assert fn is W.add and args == (1,) and kwargs == {"b": 2}


def test_a_main_function_needs_cloudpickle(monkeypatch):
    def local():
        return 1
    local.__module__ = "__main__"
    monkeypatch.setitem(sys.modules, "cloudpickle", None)  # not importable
    with pytest.raises(RuntimeError, match="requires cloudpickle"):
        E._serialize_closure(local, (), {})
