"""``horovod_tpu_torch.spark``'s estimators against ``horovod_tpu.spark``'s,
both training on the CPU from the same numpy-seeded data:

- ``LinearEstimator`` at one task: history and ``w``, ``b`` within 1e-12
  relative (both float64; the port's state is float64 tensors, and only
  the summation order differs), with validation metrics, and with the data
  knobs and ``sample_weight_col`` of ``tests/test_spark_estimator_depth.py``
  in one fit; at two gloo tasks, ``w_sum`` bitwise equal on both and
  within 1e-10 of the JAX package's two-task fit;
- ``TorchEstimator`` with the same seeded ``model_fn``: ``cross_entropy``
  with ``accuracy``, and ``mse`` with ``sample_weight_col``: the history
  and the final state dict bitwise equal at one task (the same torch ops
  on the same CPU, one thread each); the custom-loss guard and the
  unknown-loss error;
- weights carried across: a Store the JAX estimator fitted for 2 epochs
  resumes in the port's ``fit_on_parquet`` to 4, matching the JAX
  package's own continuation (Linear within 1e-12, Torch bitwise), and
  the JAX package reads the port's envelope back;
- ``fit(elastic=True)`` on two gloo tasks with ``HOROVOD_SPARK_FAULT``
  killing rank 1 after epoch 1: placed again at one task, resumed from the
  epoch-1 envelope, the history whole;
- the device rule: a task with no card that was not asked for the CPU
  raises.

Tasks are spawned local processes on the CPU (``CUDA_VISIBLE_DEVICES=``,
one thread each), each placement under a time limit, its ports held."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import io  # noqa: E402
import pickle  # noqa: E402
import shutil  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import horovod_tpu.spark as JSP  # noqa: E402
from horovod_tpu.spark import estimator as JE  # noqa: E402
from horovod_tpu_torch import runtime as _rt  # noqa: E402
from horovod_tpu_torch import spark  # noqa: E402
from horovod_tpu_torch.spark import estimator as E  # noqa: E402
from horovod_tpu_torch.utils import platform  # noqa: E402

from torch_port_deadline import deadline  # noqa: E402
from torch_port_ports import hold_ports  # noqa: E402

RTOL = 1e-12


@pytest.fixture()
def cpu_tasks(monkeypatch):
    """Tasks (and this driver's predict) on the CPU, one thread a task, the
    native controller on a held port; all given back after the test."""
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv("HOROVOD_CONTROLLER_PORT",
                       str(hold_ports(1).release()[0]))
    monkeypatch.setattr(platform, "_cpu_forced", True)


def _port():
    return hold_ports(1).release()[0]


def _make_xy(n=192, d=4, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, d)
    y = x @ rng.randn(d, 1) + 0.1 * rng.randn(n, 1)
    return x, y


def _fit(est, df=None, parquet=False, limit=120, **kw):
    with deadline(limit, f"{type(est).__module__} fit"):
        return est.fit_on_parquet(**kw) if parquet else est.fit(df, **kw)


def _linear(mod, store, epochs, **kw):
    extra = {"coordinator_port": _port()} if mod is spark else {}
    return mod.LinearEstimator(store, num_proc=kw.pop("num_proc", 1),
                               epochs=epochs,
                               executor=mod.LocalTaskExecutor(
                                   kw.pop("tasks", 1)), **extra, **kw)


def _envelope(mod, store, run_id="run0"):
    env = mod._load_epoch_checkpoint(store, run_id)
    return env, pickle.loads(env["model"])


def _close_history(got, want, rtol=RTOL):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=0,
                                   err_msg=k)


# ------------------------------------------------------------ LinearEstimator
def test_linear_one_task_matches_jax_and_resumes_a_jax_store(tmp_path,
                                                             cpu_tasks):
    """Two epochs on each package, then the JAX Store resumed to four by
    the port and, from a copy, by the JAX package itself."""
    x, y = _make_xy()
    df = {"features": x, "label": y}
    common = dict(batch_size=32, lr=0.05, validation=0.25,
                  metrics=["mse", "mae"])
    jstore = JSP.FilesystemStore(str(tmp_path / "jax"))
    want2 = _fit(_linear(JSP, jstore, 2, **common), df)
    got2 = _fit(_linear(spark, spark.FilesystemStore(str(tmp_path / "port")),
                        2, **common), df)
    _close_history(got2.history, want2.history)
    assert len(got2.history["val_mae"]) == 2
    _, jw = _envelope(JE, jstore)
    pstore = spark.FilesystemStore(str(tmp_path / "port"))
    _, pw = _envelope(E, pstore)
    for k in ("w", "b"):
        assert pw[k].dtype == np.float64
        np.testing.assert_allclose(pw[k], jw[k], rtol=RTOL, atol=0)
    # the JAX package loads the port's envelope and predicts alike
    np.testing.assert_allclose(
        JE.LinearEstimator(jstore)._load_model(
            E._load_epoch_checkpoint(pstore, "run0")["model"])(x),
        got2.transform({"features": x})["predict"], rtol=RTOL)

    shutil.copytree(tmp_path / "jax", tmp_path / "jax2")
    resumed = _fit(_linear(spark, spark.FilesystemStore(str(tmp_path / "jax")),
                           4, **common), parquet=True)
    own = _fit(_linear(JSP, JSP.FilesystemStore(str(tmp_path / "jax2")), 4,
                       **common), parquet=True)
    assert len(resumed.history["train_loss"]) == 4
    assert resumed.history["train_loss"][:2] == want2.history["train_loss"]
    _close_history(resumed.history, own.history)
    _, rw = _envelope(E, spark.FilesystemStore(str(tmp_path / "jax")))
    _, ow = _envelope(JE, JSP.FilesystemStore(str(tmp_path / "jax2")))
    for k in ("w", "b"):
        np.testing.assert_allclose(rw[k], ow[k], rtol=RTOL, atol=0)
    assert resumed.history["val_mse"][-1] < resumed.history["val_mse"][0]


def _double_labels(batch):
    batch = dict(batch)
    batch["label"] = batch["label"] * 2.0
    return batch


def test_linear_data_knobs_and_weights_match_jax(tmp_path, cpu_tasks,
                                                 capfd):
    """``shuffle_buffer_size``, the steps caps, ``val_batch_size``,
    ``transformation_fn``, ``verbose`` and ``sample_weight_col`` in one fit
    on each package: the same history and weights; the doubled labels
    (``transformation_fn`` ran in the workers) learned as 2w."""
    rng = np.random.RandomState(0)
    x = rng.randn(256, 3)
    y = x @ np.asarray([[1.0], [-1.0], [0.5]])
    df = {"features": x, "label": y, "wt": 0.5 + rng.rand(256)}
    knobs = dict(batch_size=32, lr=0.05, validation=0.2, metrics=["mse"],
                 shuffle_buffer_size=64, train_steps_per_epoch=6,
                 validation_steps_per_epoch=1, val_batch_size=16,
                 transformation_fn=_double_labels, verbose=1,
                 sample_weight_col="wt")
    # 12 epochs: the loss is still far above its rounding floor, where a
    # relative bound would read the two summation orders' noise
    want = _fit(_linear(JSP, JSP.FilesystemStore(str(tmp_path / "j")), 12,
                        **knobs), df)
    got = _fit(_linear(spark, spark.FilesystemStore(str(tmp_path / "p")), 12,
                       **knobs), df)
    _close_history(got.history, want.history)
    pred = got.transform({"features": x})["predict"]
    np.testing.assert_allclose(pred, want.transform({"features": x})
                               ["predict"], rtol=1e-10, atol=1e-13)
    assert float(np.mean((pred - 2.0 * y) ** 2)) < 5e-2
    assert "[estimator] epoch 11" in capfd.readouterr().out
    assert got.history["val_mse"][-1] < got.history["val_mse"][0]


def _tasks(mod, est, df, n, port):
    """prepare_data, then the estimator's own train task on ``n`` tasks:
    every task's result (the estimator's fit keeps none)."""
    train, val = mod.prepare.prepare_data(
        est.store, df, est.feature_cols, est.label_cols,
        validation=est.validation, seed=est.seed, run_id=est.run_id)
    with deadline(180, f"{mod.__name__} two tasks"):
        return mod.run(est._make_train_task(), args=(train, val),
                       num_proc=n, executor=mod.LocalTaskExecutor(n),
                       coordinator_port=port)


def test_linear_two_gloo_tasks_match_jax(tmp_path, cpu_tasks):
    x, y = _make_xy(n=256, seed=2)
    df = {"features": x, "label": y}
    common = dict(batch_size=32, lr=0.05, validation=0.25, metrics=["mse"])
    got = _tasks(spark, _linear(spark, spark.FilesystemStore(
        str(tmp_path / "p")), 3, num_proc=2, **common), df, 2, _port())
    assert [r["device"] for r in got] == ["cpu", "cpu"]
    assert got[0]["w_sum"] == got[1]["w_sum"]
    # the JAX tasks' eager allreduce rounds float64 gradients to float32
    # unless jax's x64 mode is on (5.7e-8 relative on w_sum here): the
    # reference runs with it on, so both syncs are float64
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("JAX_ENABLE_X64", "1")
        want = _tasks(JSP, _linear(JSP, JSP.FilesystemStore(
            str(tmp_path / "j")), 3, num_proc=2, **common), df, 2, _port())
    assert abs(got[0]["w_sum"] - want[0]["w_sum"]) <= \
        1e-10 * abs(want[0]["w_sum"])
    hist = pickle.loads(spark.FilesystemStore(str(tmp_path / "p"))
                        .read_log("run0"))
    jhist = pickle.loads(JSP.FilesystemStore(str(tmp_path / "j"))
                         .read_log("run0"))
    _close_history(hist, jhist, rtol=1e-10)


# ------------------------------------------------------------ TorchEstimator
def _cls_model_fn():
    torch.manual_seed(3)
    return torch.nn.Sequential(torch.nn.Linear(4, 8), torch.nn.Tanh(),
                               torch.nn.Linear(8, 3))


def _reg_model_fn():
    torch.manual_seed(4)
    return torch.nn.Linear(4, 1)


def _torch_est(mod, store, model_fn, epochs, **kw):
    extra = {"coordinator_port": _port()} if mod is spark else {}
    return mod.TorchEstimator(store, model_fn, num_proc=1, lr=0.1,
                              batch_size=30, epochs=epochs,
                              executor=mod.LocalTaskExecutor(1), **extra,
                              **kw)


def _state(mod, store):
    env = mod._load_epoch_checkpoint(store, "run0")
    return torch.load(io.BytesIO(env["model"]), weights_only=True)


def _same_state(got, want):
    assert list(got) == list(want)
    for k in want:
        assert got[k].device.type == "cpu"
        assert torch.equal(got[k], want[k]), k


def _cls_data(n=120):
    rng = np.random.RandomState(0)
    x = rng.randn(n, 4).astype(np.float32)
    y = (x @ rng.randn(4, 3)).argmax(axis=1).astype(np.int64)
    return {"f": x, "l": y}


def test_torch_cross_entropy_matches_jax_and_resumes_a_jax_store(
        tmp_path, cpu_tasks):
    df = _cls_data()
    common = dict(feature_cols=["f"], label_cols=["l"],
                  loss="cross_entropy", metrics=["accuracy"],
                  validation=0.25)
    jstore = JSP.FilesystemStore(str(tmp_path / "jax"))
    want2 = _fit(_torch_est(JSP, jstore, _cls_model_fn, 2, **common), df)
    pstore = spark.FilesystemStore(str(tmp_path / "port"))
    got2 = _fit(_torch_est(spark, pstore, _cls_model_fn, 2, **common), df)
    assert got2.history == want2.history  # bitwise
    _same_state(_state(E, pstore), _state(JE, jstore))
    np.testing.assert_array_equal(got2.transform(df)["predict"],
                                  want2.transform(df)["predict"])

    shutil.copytree(tmp_path / "jax", tmp_path / "jax2")
    resumed = _fit(_torch_est(spark, spark.FilesystemStore(
        str(tmp_path / "jax")), _cls_model_fn, 4, **common), parquet=True)
    own = _fit(_torch_est(JSP, JSP.FilesystemStore(str(tmp_path / "jax2")),
                          _cls_model_fn, 4, **common), parquet=True)
    assert len(resumed.history["val_accuracy"]) == 4
    assert resumed.history == own.history
    _same_state(_state(E, spark.FilesystemStore(str(tmp_path / "jax"))),
                _state(JE, JSP.FilesystemStore(str(tmp_path / "jax2"))))
    assert resumed.history["val_accuracy"][-1] > 0.5


def test_torch_weighted_mse_matches_jax(tmp_path, cpu_tasks):
    rng = np.random.RandomState(1)
    x = rng.randn(128, 4).astype(np.float32)
    y = (x @ rng.randn(4, 1)).astype(np.float32)
    df = {"features": x, "label": y, "wt": 0.5 + rng.rand(128)}
    kw = dict(sample_weight_col="wt", batch_size=32, lr=0.05)
    want = _fit(JSP.TorchEstimator(
        JSP.FilesystemStore(str(tmp_path / "j")), _reg_model_fn, epochs=3,
        executor=JSP.LocalTaskExecutor(1), **kw), df)
    store = spark.FilesystemStore(str(tmp_path / "p"))
    got = _fit(spark.TorchEstimator(
        store, _reg_model_fn, epochs=3, executor=spark.LocalTaskExecutor(1),
        coordinator_port=_port(), **kw), df)
    assert got.history == want.history
    assert got.history["train_loss"][-1] < got.history["train_loss"][0]
    _same_state(_state(E, store),
                _state(JE, JSP.FilesystemStore(str(tmp_path / "j"))))


def test_torch_loss_guards():
    with pytest.raises(ValueError, match="unknown torch loss"):
        E._torch_loss_fn("not_a_loss")
    with pytest.raises(ValueError, match="NAMED loss"):
        E._torch_loss_fn(torch.nn.MSELoss(), weighted=True)
    with pytest.raises(ValueError, match="NAMED loss"):
        E._torch_loss_fn(lambda p, y: (p - y).sum(), weighted=True)
    assert isinstance(E._torch_loss_fn(None), torch.nn.MSELoss)
    assert E._torch_loss_fn("mae", weighted=True).reduction == "none"
    custom = torch.nn.SmoothL1Loss()
    assert E._torch_loss_fn(custom) is custom


# ------------------------------------------------------------------- elastic
def test_elastic_fit_shrinks_after_a_fault(tmp_path, cpu_tasks, monkeypatch):
    x, y = _make_xy(n=256, seed=2)
    store = spark.FilesystemStore(str(tmp_path / "store"))
    marker = str(tmp_path / "fault_marker")
    sizes = []

    class Counting(spark.LocalTaskExecutor):
        def with_num_tasks(self, n):
            sizes.append(n)
            return Counting(n)

    est = spark.LinearEstimator(store, num_proc=2, batch_size=32, epochs=4,
                                lr=0.05, executor=Counting(2),
                                validation=0.25, metrics=["mse"],
                                coordinator_port=_port())
    monkeypatch.setenv("HOROVOD_SPARK_FAULT", f"1,1,{marker}")
    model = _fit(est, {"features": x, "label": y}, limit=240, elastic=True,
                 min_np=1, reset_limit=3)
    assert os.path.exists(marker), "the fault was never injected"
    assert sizes == [2, 1]
    env, _ = _envelope(E, store)
    assert env["epoch"] == 3
    # epochs 0-1 from the two tasks, 2-3 from the one: no gap, no repeat
    assert len(model.history["train_loss"]) == 4
    assert len(model.history["val_mse"]) == 4
    assert model.history["val_mse"][-1] < model.history["val_mse"][0]


# ---------------------------------------------------------------- the rest
def test_task_without_a_card_raises(tmp_path, monkeypatch):
    """Not asked for the CPU and no card: the train task's ``hvd.init()``
    raises; nothing falls back to the CPU."""
    monkeypatch.setattr(platform, "_cpu_forced", False)
    monkeypatch.setattr(_rt, "_runtime", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    store = spark.FilesystemStore(str(tmp_path))
    x, y = _make_xy(n=16)
    train, _ = spark.prepare_data(store, {"features": x, "label": y},
                                  ["features"], ["label"])
    for est in (spark.LinearEstimator(store),
                spark.TorchEstimator(store, _reg_model_fn)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            est._make_train_task()(train)
    assert not _rt.is_initialized()


def test_metrics_envelope_and_model_surface(tmp_path):
    assert [n for n, _ in E._resolve_metrics(["mse", "mae", "accuracy"])] \
        == ["mse", "mae", "accuracy"]
    with pytest.raises(ValueError, match="unknown metric"):
        E._resolve_metrics(["not_a_metric"])
    with pytest.raises(ValueError, match="unknown metric"):
        spark.LinearEstimator(spark.FilesystemStore(str(tmp_path)),
                              metrics=["nope"])
    p = np.asarray([[0.1, 0.9], [0.8, 0.2], [0.3, 0.7]])
    y = np.asarray([1, 0, 0])
    for name, fn in E._NAMED_METRICS.items():
        assert fn(p, y[:, None] if name != "accuracy" else y) == \
            JE._NAMED_METRICS[name](p, y[:, None] if name != "accuracy"
                                    else y)
    store = spark.FilesystemStore(str(tmp_path))
    assert E._load_epoch_checkpoint(store, "r") is None
    store.save_checkpoint("r", b"raw bytes, no envelope")
    assert E._load_epoch_checkpoint(store, "r") == \
        JE._load_epoch_checkpoint(store, "r")
    E._save_epoch_checkpoint(store, "r", 3, b"m", {"train_loss": [1.0]})
    assert JE._load_epoch_checkpoint(store, "r") == {
        "fmt": 1, "epoch": 3, "model": b"m", "history": {"train_loss": [1.0]}}
    est = spark.LinearEstimator(store, run_id="r")
    assert est.has_checkpoint() and est._has_checkpoint()
    with pytest.raises(ValueError, match="no parquet dataset"):
        est.fit_on_parquet()
    with pytest.raises(ValueError, match="shuffle_buffer_size"):
        spark.LinearEstimator(store, shuffle_buffer_size=-1)
    model = E.EstimatorModel(lambda x: x.sum(axis=1, keepdims=True),
                             ["a", "b"], history={"train_loss": [2.0]})
    out = model.transform({"a": np.ones((2, 2)), "b": np.ones(2),
                           "id": np.arange(2)})
    np.testing.assert_array_equal(out["predict"], [[3.0], [3.0]])
    assert sorted(out) == ["a", "b", "id", "predict"]
    with pytest.raises(ValueError, match="sample_weight_col 'wt'"):
        E._batch_weights({"features": np.ones(4)},
                         {"sample_weight_col": "wt"})


def test_exports():
    for name in ("Store", "FilesystemStore", "LocalStore", "DBFSLocalStore",
                 "Estimator", "EstimatorModel", "LinearEstimator",
                 "TorchEstimator"):
        assert name in spark.__all__ and hasattr(spark, name)
        assert hasattr(JSP, name)
    for name in ("KerasEstimator", "LightningEstimator"):
        assert not hasattr(spark, name)
