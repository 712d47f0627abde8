"""``horovod_tpu_torch.spark`` against ``horovod_tpu.spark``'s placement
layer: the placement cases of ``tests/test_spark_ray.py`` and
``tests/test_spark_estimator_depth.py`` on the port (ranks and results,
args and kwargs, a worker's failure, the local fallback without pyspark,
``run_elastic``'s reset, shrink and ``reset_limit``), the port's own rules
(tensors back on the CPU, a dead task, fail-fast, loopback aliases on a
machine with cards, the KV planes with no rendezvous), and parity: the
same ``env_for_tasks`` blocks as the JAX package's for the same hostname
lists, and the same per-rank results from the JAX ``spark.run`` and the
port's for one module-level function.  Tasks are local processes
(``spawn``); each test that places tasks has a time limit of its own and
its store port from ``hold_ports``."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import time  # noqa: E402

import pytest  # noqa: E402
import torch  # noqa: E402

from horovod_tpu_torch import spark  # noqa: E402
from horovod_tpu_torch.spark import runner as R  # noqa: E402
from horovod_tpu_torch.spark import LocalTaskExecutor  # noqa: E402

import torch_port_cluster_worker as W  # noqa: E402
from torch_port_deadline import deadline  # noqa: E402
from torch_port_ports import hold_ports  # noqa: E402


def _port():
    """A store port for tasks started right away."""
    return hold_ports(1).release()[0]


def _run(fn, n, limit=60, **kw):
    with deadline(limit, f"spark.run of {fn.__name__} on {n} tasks"):
        return spark.run(fn, num_proc=n, executor=LocalTaskExecutor(n),
                         coordinator_port=_port(), **kw)


# ------------------------------------------------ tests/test_spark_ray.py
def test_spark_run_local_executor_ranks_and_results():
    out = _run(W.env_report, 3)
    assert [int(r) for r, _, _ in out] == [0, 1, 2]
    assert all(s == "3" for _, s, _ in out)
    assert all(c for _, _, c in out)  # the store's address, multi-task


def test_spark_run_args_kwargs():
    out = _run(W.add, 2, args=(10,), kwargs={"b": 5})
    assert out == [15, 16]


def test_spark_run_propagates_worker_failure():
    with pytest.raises(RuntimeError, match="worker exploded"):
        _run(W.fail, 2)


def test_spark_executor_fallback_is_local_without_pyspark():
    try:
        import pyspark  # noqa: F401
        pytest.skip("pyspark installed; the fallback does not apply")
    except ImportError:
        pass
    with deadline(60, "spark.run with no executor"):
        out = spark.run(W.env_report, num_proc=2, coordinator_port=_port())
    assert [int(r) for r, _, _ in out] == [0, 1]


def test_spark_task_executor_requires_pyspark_and_never_falls_back():
    try:
        import pyspark  # noqa: F401
        pytest.skip("pyspark installed; the gate does not apply")
    except ImportError:
        pass
    with pytest.raises(ImportError, match="LocalTaskExecutor"):
        R.SparkTaskExecutor(2)
    with pytest.raises(ImportError, match="requires pyspark"):
        spark.run(W.env_report, num_proc=2, use_spark=True)


# ----------------------------------- tests/test_spark_estimator_depth.py
def test_run_elastic_shrinks_to_min_np():
    with deadline(120, "run_elastic from 3 tasks to 1"):
        out = spark.run_elastic(W.die_if_multi, num_proc=3, min_np=1,
                                reset_limit=5,
                                executor_factory=LocalTaskExecutor,
                                coordinator_port=_port(), verbose=0)
    assert out == ["solo-ok"]


def test_run_elastic_respects_reset_limit():
    with deadline(120, "run_elastic up to its reset limit"):
        with pytest.raises(RuntimeError, match="reset_limit"):
            spark.run_elastic(W.always_die, num_proc=1, min_np=1,
                              reset_limit=2,
                              executor_factory=LocalTaskExecutor,
                              coordinator_port=_port(), verbose=0)


def test_run_elastic_validates_bounds():
    with pytest.raises(ValueError, match="below min_np"):
        spark.run_elastic(W.die_if_multi, num_proc=1, min_np=2)


def test_executors_resize_for_elastic_resets():
    ex = LocalTaskExecutor(3, start_method="spawn").with_num_tasks(2)
    assert isinstance(ex, LocalTaskExecutor) and ex.num_tasks() == 2
    with pytest.raises(NotImplementedError, match="with_num_tasks"):
        R.TaskExecutor().with_num_tasks(2)


# ------------------------------------------------------- the port's rules
def test_tensors_come_back_on_the_cpu():
    out = _run(W.tensors, 2)
    for r, got in enumerate(out):
        assert got["t"].device.type == "cpu"
        assert torch.equal(got["t"], torch.full((2,), float(r)))
        (inner,), = got["nested"]
        assert torch.equal(inner, torch.arange(3) + r)


def test_a_task_that_dies_without_a_result_raises():
    with pytest.raises(RuntimeError, match=r"task\(s\) \[0\] died"):
        _run(W.exit_hard, 1)


def test_the_first_failure_ends_its_peers():
    """Rank 1 raises while rank 0 waits for it at the store; the job ends
    at once instead of at the store's timeout."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 exploded"):
        _run(W.fail_on_rank_1_then_wait, 2,
             env={"HOROVOD_START_TIMEOUT": "120"})
    assert time.monotonic() - t0 < 45


def test_two_loopback_aliases_raise_on_a_machine_with_cards(monkeypatch):
    from horovod_tpu_torch.runner import gpu_discovery
    monkeypatch.setattr(gpu_discovery, "visible_gpu_count", lambda: 1)
    with pytest.raises(ValueError, match="same card"):
        R.check_card_aliases(["localhost", "127.0.0.1"])
    R.check_card_aliases(["localhost", "localhost", "otherhost"])
    monkeypatch.setattr(gpu_discovery, "visible_gpu_count", lambda: 0)
    R.check_card_aliases(["localhost", "127.0.0.1"])


def test_planes_stay_off_without_a_rendezvous(tmp_path):
    """A task has no launcher: with the metrics, perf, heartbeat, chaos
    and timeline knobs on, ``hvd.init()`` comes up from the task's env
    alone, nothing publishes, and the job ends."""
    env = {"HOROVOD_METRICS": "1", "HOROVOD_PERF": "1",
           "HOROVOD_HEARTBEAT": "1", "HOROVOD_CHAOS": "1",
           "HOROVOD_TIMELINE": str(tmp_path / "timeline.json"),
           "HOROVOD_CONTROLLER": "none"}
    out = _run(W.planes_without_kv, 2, env=env)
    for got in out:
        assert got["sum"] == 3.0
        assert got["addrs"] == ["", "", ""]
        assert got["timeline_publisher"] and got["no_chaos"]


# ------------------------------------------------------------ parity
@pytest.mark.parametrize("hostnames", [
    ["h1"], ["h1", "h1"], ["h1", "h2", "h1", "h2"],
    ["b", "a", "b", "c", "a", "b"], ["localhost"] * 4])
def test_env_for_tasks_blocks_equal_jax(hostnames):
    from horovod_tpu.runner.hosts import env_for_tasks as jax_env
    from horovod_tpu_torch.runner.hosts import env_for_tasks
    assert env_for_tasks(hostnames, 29511) == jax_env(hostnames, 29511)


def test_same_results_as_the_jax_spark_run():
    from horovod_tpu.spark import LocalTaskExecutor as JaxExecutor
    from horovod_tpu.spark import run as jax_run
    keys = ("HOROVOD_RANK", "HOROVOD_SIZE", "HOROVOD_LOCAL_RANK",
            "HOROVOD_LOCAL_SIZE", "HOROVOD_CROSS_RANK",
            "HOROVOD_CROSS_SIZE", "HOROVOD_COORDINATOR_ADDR")
    port = _port()
    with deadline(120, "the JAX and the port's spark.run"):
        want = jax_run(W.env_block, args=(keys,), num_proc=2,
                       executor=JaxExecutor(2), coordinator_port=port)
        got = spark.run(W.env_block, args=(keys,), num_proc=2,
                        executor=LocalTaskExecutor(2), coordinator_port=port)
    assert got == want
    assert [g["HOROVOD_RANK"] for g in got] == ["0", "1"]
