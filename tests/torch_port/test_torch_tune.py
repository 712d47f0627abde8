"""``horovod_tpu_torch.tune`` against ``horovod_tpu.tune``: the 13 cases of
``tests/test_tune.py`` run on the port, and each search the JAX package
can run here held to it: the same trials (configs and metrics, exact) for
the grid runs and for the Bayesian runs, whose proposals come from the two
packages' copies of the native GP (``csrc/core/optim.cc`` and
``csrc/optim.cc``) with the same seed.  The distributed trials place
their workers through ``spark.run``'s executors (local processes, or an
``executor_factory``'s) on free store ports."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import pytest  # noqa: E402

from horovod_tpu import tune as jtune  # noqa: E402
from horovod_tpu_torch import tune  # noqa: E402
from torch_port_deadline import deadline  # noqa: E402
from torch_port_ports import hold_ports  # noqa: E402


def quad(config):
    # minimum at lr=0.3
    return (config["lr"] - 0.3) ** 2


def _trials(res):
    return [(t.config, t.metrics, t.error) for t in res.trials]


def _same_as_jax(fn, **kw):
    """The port's search and the JAX package's on the same arguments: the
    same trials in the same order, the same best."""
    got = tune.run(fn, **kw)
    want = jtune.run(fn, **{k: _jax_domains(v) if k == "config" else v
                            for k, v in kw.items()})
    assert _trials(got) == _trials(want)
    assert (got.best_config, got.best_metric) == \
        (want.best_config, want.best_metric)
    return got


def _jax_domains(config):
    out = {}
    for k, v in config.items():
        if isinstance(v, tune.grid_search):
            out[k] = jtune.grid_search(list(v.values))
        elif isinstance(v, tune.loguniform):
            out[k] = jtune.loguniform(v.low, v.high)
        elif isinstance(v, tune.uniform):
            out[k] = jtune.uniform(v.low, v.high)
        elif isinstance(v, tune.choice):
            out[k] = jtune.choice(list(v.options))
        else:
            out[k] = v
    return out


def test_grid_search_exhaustive_best():
    res = _same_as_jax(quad, config={"lr": tune.grid_search(
        [0.1, 0.2, 0.3, 0.4])}, metric="loss", mode="min")
    assert len(res.trials) == 4
    assert res.best_config["lr"] == 0.3
    assert res.best_metric == 0.0


def test_grid_search_crosses_axes():
    seen = []

    def f(cfg):
        seen.append((cfg["a"], cfg["b"]))
        return cfg["a"] + cfg["b"]

    res = _same_as_jax(f, config={"a": tune.grid_search([1, 2]),
                                  "b": tune.grid_search([10, 20]),
                                  "c": "fixed"},
                       metric="loss", mode="min")
    assert sorted(seen[:4]) == [(1, 10), (1, 20), (2, 10), (2, 20)]
    assert res.best_config["a"] == 1 and res.best_config["b"] == 10
    assert res.best_config["c"] == "fixed"


def test_bayes_converges_on_quadratic():
    res = _same_as_jax(quad, config={"lr": tune.uniform(0.0, 1.0)},
                       metric="loss", mode="min", num_trials=20, seed=7)
    assert res.best_metric < 0.01  # |lr - 0.3| < 0.1
    assert abs(res.best_config["lr"] - 0.3) < 0.1


def test_bayes_mode_max_and_report_api():
    def f(cfg):
        tune.report(acc=1.0 - (cfg["x"] - 0.7) ** 2)  # no return value

    def jf(cfg):
        jtune.report(acc=1.0 - (cfg["x"] - 0.7) ** 2)

    res = tune.run(f, config={"x": tune.uniform(0.0, 1.0)},
                   metric="acc", mode="max", num_trials=20, seed=3)
    want = jtune.run(jf, config={"x": jtune.uniform(0.0, 1.0)},
                     metric="acc", mode="max", num_trials=20, seed=3)
    assert _trials(res) == _trials(want)
    assert res.best_metric > 0.95
    assert abs(res.best_config["x"] - 0.7) < 0.25


def test_choice_and_loguniform_domains():
    def f(cfg):
        assert cfg["opt"] in ("sgd", "adam")
        assert 1e-5 <= cfg["lr"] <= 1e-1
        return cfg["lr"] if cfg["opt"] == "sgd" else cfg["lr"] * 10

    res = _same_as_jax(f, config={"lr": tune.loguniform(1e-5, 1e-1),
                                  "opt": tune.choice(["sgd", "adam"])},
                       metric="loss", mode="min", num_trials=12, seed=1)
    assert res.best_metric is not None


def test_failed_trials_do_not_kill_search():
    def f(cfg):
        if cfg["lr"] > 0.5:
            raise RuntimeError("diverged")
        return cfg["lr"]

    res = _same_as_jax(f, config={"lr": tune.grid_search(
        [0.1, 0.9, 0.2, 0.8])}, metric="loss", mode="min")
    errs = [t for t in res.trials if t.error]
    assert len(errs) == 2 and "diverged" in errs[0].error
    assert res.best_config["lr"] == 0.1


def test_grid_may_not_mix_with_continuous():
    for T in (tune, jtune):
        with pytest.raises(ValueError, match="grid_search"):
            T.run(quad, config={"lr": T.grid_search([1]),
                                "x": T.uniform(0, 1)},
                  metric="loss")
    with pytest.raises(ValueError, match="min|max"):
        tune.run(quad, config={"lr": 0.1}, metric="loss", mode="best")


def test_report_is_noop_outside_trials():
    tune.report(loss=1.0)  # must not raise


# module-level for the workers' unpickling
def _dist_trial(config):
    import horovod_tpu_torch as hvd
    hvd.init(device="cpu")
    # every worker computes the same metric; rank 0's scores the trial
    out = (config["lr"] - 0.25) ** 2 + 0.0 * hvd.rank()
    hvd.shutdown()
    return out


def _port():
    return hold_ports(1).release()[0]


def test_distributed_trainable_runs_workers():
    trial = tune.distributed_trainable(_dist_trial, num_proc=2,
                                       coordinator_port=_port())
    res = tune.run(trial, config={"lr": tune.grid_search([0.1, 0.25])},
                   metric="loss", mode="min")
    assert [t.error for t in res.trials] == [None, None]
    assert res.best_config["lr"] == 0.25
    assert res.best_metric == 0.0


def test_no_search_axes_runs_single_trial():
    res = _same_as_jax(lambda c: c["batch"] * 0.5, config={"batch": 2},
                       metric="loss")
    assert len(res.trials) == 1 and res.best_metric == 1.0


def test_loguniform_validates_bounds():
    with pytest.raises(ValueError, match="0 < low < high"):
        tune.loguniform(0, 1e-1)
    with pytest.raises(ValueError, match="low < high"):
        tune.uniform(2.0, 1.0)


def test_domains_map_the_unit_interval_as_jax():
    pairs = [(tune.uniform(-1.0, 3.0), jtune.uniform(-1.0, 3.0)),
             (tune.loguniform(1e-5, 1e-1), jtune.loguniform(1e-5, 1e-1)),
             (tune.choice(["a", "b", "c"]), jtune.choice(["a", "b", "c"]))]
    for t, j in pairs:
        for u in (-0.5, 0.0, 0.2, 0.5, 0.999, 1.0, 1.5):
            assert t.from_unit(u) == j.from_unit(u)
        v = j.from_unit(0.3)
        assert t.to_unit(v) == j.to_unit(v)


def _report_only_dist(config):
    import horovod_tpu_torch as hvd
    hvd.init(device="cpu")
    from horovod_tpu_torch import tune as t
    t.report(loss=(config["lr"] - 0.25) ** 2)  # no return value
    hvd.shutdown()


def test_distributed_trainable_forwards_worker_reports():
    trial = tune.distributed_trainable(_report_only_dist, num_proc=2,
                                       coordinator_port=_port())
    res = tune.run(trial, config={"lr": tune.grid_search([0.1, 0.25])},
                   metric="loss", mode="min")
    assert res.best_config["lr"] == 0.25 and res.best_metric == 0.0


def _silent_dist(config):
    import horovod_tpu_torch as hvd
    hvd.init(device="cpu")
    hvd.shutdown()


def test_distributed_trainable_raises_on_no_metric():
    trial = tune.distributed_trainable(_silent_dist, num_proc=1,
                                       coordinator_port=_port())
    res = tune.run(trial, config={"lr": tune.grid_search([0.1])},
                   metric="loss")
    assert res.trials[0].error and "no metric" in res.trials[0].error
    from horovod_tpu_torch.spark import LocalTaskExecutor
    trial = tune.distributed_trainable(_silent_dist, num_proc=1,
                                       executor_factory=LocalTaskExecutor,
                                       coordinator_port=_port())
    res = tune.run(trial, config={"lr": tune.grid_search([0.1])},
                   metric="loss")
    assert res.trials[0].error and "no metric" in res.trials[0].error


def _plain_dist(config):
    # no init: the JAX package's tasks import JAX, the port's torch
    import os as _os
    return (config["lr"] - 0.25) ** 2 + 0.0 * int(_os.environ["HOROVOD_RANK"])


def test_distributed_trainable_executor_factory_trials_equal_jax():
    """Trials placed through ``executor_factory(num_proc)``: the factory
    is called once a trial with ``num_proc``, its tasks run the trial, and
    the trials equal the JAX package's through its own executors."""
    from horovod_tpu.spark import LocalTaskExecutor as JaxExecutor
    from horovod_tpu_torch.spark import LocalTaskExecutor
    calls = []

    def factory(n):
        calls.append(n)
        return LocalTaskExecutor(n)

    config = {"lr": tune.grid_search([0.1, 0.25])}
    with deadline(180, "two trials of each package on two tasks"):
        got = tune.run(tune.distributed_trainable(
            _plain_dist, num_proc=2, executor_factory=factory,
            coordinator_port=_port()), config=config, metric="loss")
        want = jtune.run(jtune.distributed_trainable(
            _plain_dist, num_proc=2, executor_factory=JaxExecutor,
            coordinator_port=_port()), config=_jax_domains(config),
            metric="loss")
    assert calls == [2, 2]
    assert _trials(got) == _trials(want)
    assert [t.error for t in got.trials] == [None, None]
    assert got.best_config == {"lr": 0.25} and got.best_metric == 0.0
