"""``horovod_tpu_torch.spark.LightningEstimator`` against
``horovod_tpu.spark.LightningEstimator``, both training on the CPU from the
same numpy-seeded data with modules whose initial weights are seeded
(``torch_port_lightning.py``):

- the protocol helpers: ``_first_optimizer`` and ``_unwrap_scheduler``
  give the JAX package's results on every form ``configure_optimizers``
  may return, the raise on None included;
- one task: callbacks, a logger, ``validation_step``, ``self.log``, a
  skipped batch, a step-interval scheduler, the clip and an early stop in
  one fit on each package: the history, the logger's records, the
  callbacks' record and the final ``state_dict`` bitwise equal (the same
  torch CPU ops on one thread each); ``tests/test_spark_ray.py``'s
  assertions on the port's fit;
- two gloo tasks with the same surface: the history, the logger's records
  and the final ``state_dict`` within 1e-5 relative of the JAX package's
  two-task fit (float32 rounding, the JAX package's own keras tests'
  rtol; the two eager allreduces average the float32 gradients in another
  order: 1.9e-7 and 2.2e-7 measured), with jax's x64 mode on so that its
  float64 syncs stay float64; and ``tests/test_spark_ray.py``'s end-to-end
  test on the port;
- weights carried across: a Store the JAX estimator fitted for 2 epochs
  resumes in the port's ``fit_on_parquet`` to 4, as the JAX package's own
  continuation does, bitwise;
- an ``nn.Module`` speaking the protocol, moved with ``.to``; the guards;
  the device rule;
- ``chip_smoke.py`` phase 23 (a) and (b) rehearsed on the CPU at the
  ``tiny`` config, every check of the card's run.

Tasks are spawned local processes on the CPU (``CUDA_VISIBLE_DEVICES=``,
one thread each), each placement under a time limit, its ports held."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import io  # noqa: E402
import json  # noqa: E402
import shutil  # noqa: E402
import signal  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import horovod_tpu.spark as JSP  # noqa: E402
from horovod_tpu.spark import estimator as JE  # noqa: E402
from horovod_tpu.spark import lightning as JL  # noqa: E402
from horovod_tpu_torch import runtime as _rt  # noqa: E402
from horovod_tpu_torch import spark  # noqa: E402
from horovod_tpu_torch.spark import estimator as E  # noqa: E402
from horovod_tpu_torch.spark import lightning as PL  # noqa: E402
from horovod_tpu_torch.utils import platform  # noqa: E402

import torch_port_lightning as TL  # noqa: E402
from torch_port_deadline import deadline  # noqa: E402
from torch_port_ports import hold_ports  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
TWO_TASK_RTOL = 1e-5


@pytest.fixture()
def cpu_tasks(monkeypatch):
    """Tasks (and this driver's predict) on the CPU, one thread a task, the
    native controller on a held port; all given back after the test."""
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv("HOROVOD_CONTROLLER_PORT",
                       str(hold_ports(1).release()[0]))
    monkeypatch.setattr(platform, "_cpu_forced", True)


def _linear_data(n=256, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 4).astype("float32")
    w = np.array([[1.0], [-1.0], [0.5], [2.0]], "float32")
    return {"features": x, "label": (x @ w).astype("float32")}


def _est(mod, store, model_fn, epochs, tasks=1, **kw):
    extra = {"coordinator_port": hold_ports(1).release()[0]} \
        if mod is spark else {}
    return mod.LightningEstimator(
        store=store, model_fn=model_fn, num_proc=tasks,
        feature_cols=["features"], label_cols=["label"], batch_size=32,
        epochs=epochs, executor=mod.LocalTaskExecutor(tasks), **extra, **kw)


def _fit(est, df=None, parquet=False, limit=180):
    with deadline(limit, f"{type(est).__module__} fit"):
        return est.fit_on_parquet() if parquet else est.fit(df)


def _paths(mod, est, df):
    """``df`` written to ``est``'s Store as its fit writes it (None: the
    dataset already there, as ``fit_on_parquet`` reads it)."""
    if df is not None:
        return mod.prepare.prepare_data(
            est.store, df, est.feature_cols, est.label_cols,
            validation=est.validation, seed=est.seed, run_id=est.run_id)
    val = est.store.get_val_data_path(est.run_id)
    return (est.store.get_train_data_path(est.run_id),
            val if est.store.is_parquet_dataset(val) else None)


def _fit_both(jest, est, df=None, limit=240, jax_env=None):
    """Both packages' fits of ``df`` (None: of their Stores' datasets), as
    ``fit`` runs them, with only the two placements at once: the JAX
    tasks from a thread, on ports of their own (``jax_env`` joins their
    env), each placement's tasks processes of their own.  The data are
    written before and the models loaded after, in this thread: a pyarrow
    write in one thread beside a spawn in another crashed the process.
    Returns the port's model and the JAX package's."""
    jpaths, ppaths = _paths(JSP, jest, df), _paths(spark, est, df)
    errors = []

    def place_jax():
        try:
            JSP.run(jest._make_train_task(), args=jpaths,
                    num_proc=jest.num_proc, executor=jest.executor,
                    env=dict(jax_env or {}),
                    coordinator_port=hold_ports(1).release()[0])
        except BaseException as e:  # raised in the test's thread below
            errors.append(e)
    t = threading.Thread(target=place_jax, daemon=True)
    with deadline(limit, "the two packages' fits"):
        t.start()
        spark.run(est._make_train_task(), args=ppaths, num_proc=est.num_proc,
                  executor=est.executor, env=est._task_env(),
                  coordinator_port=est.coordinator_port)
        t.join()
    if errors:
        raise errors[0]
    out = []
    for mod, e in ((E, est), (JE, jest)):
        env = mod._load_epoch_checkpoint(e.store, e.run_id)
        out.append(mod.EstimatorModel(e._load_model(env["model"]),
                                      e.feature_cols,
                                      history=env.get("history")))
    return out


def _state(mod, store):
    env = mod._load_epoch_checkpoint(store, "run0")
    return torch.load(io.BytesIO(env["model"]), weights_only=True)


def _same_state(got, want):
    assert list(got) == list(want)
    for k in want:
        assert got[k].device.type == "cpu"
        assert torch.equal(got[k], want[k]), k


def _lines(path):
    with open(path) as f:
        return f.read().splitlines()


# ----------------------------------------------------------------- helpers
def _forms():
    lin = torch.nn.Linear(2, 1)
    opt = torch.optim.SGD(lin.parameters(), lr=0.1)
    opt2 = torch.optim.SGD(lin.parameters(), lr=0.2)
    sched = torch.optim.lr_scheduler.StepLR(opt, 1)
    step_cfg = {"scheduler": sched, "interval": "step", "frequency": 2}
    return {
        "optimizer": (opt, (opt, None)),
        "list": ([opt], (opt, None)),
        "lists pair": (([opt], [sched]), (opt, (sched, "epoch", 1))),
        "pair": ((opt, sched), (opt, (sched, "epoch", 1))),
        "empty schedulers": (([opt], []), (opt, None)),
        "dict": ({"optimizer": opt, "lr_scheduler": sched},
                 (opt, (sched, "epoch", 1))),
        "dict with config": ({"optimizer": opt, "lr_scheduler": step_cfg},
                             (opt, (sched, "step", 2))),
        "scheduler config": (([opt], [step_cfg]), (opt, (sched, "step", 2))),
        "config without scheduler": (([opt], [{"interval": "step"}]),
                                     (opt, None)),
        "list of dicts": ([{"optimizer": opt}], (opt, None)),
        "list of dicts with config": (
            [{"optimizer": opt, "lr_scheduler": step_cfg}],
            (opt, (sched, "step", 2))),
        "two optimizers": ((opt, opt2), (opt, None)),
    }


@pytest.mark.parametrize("form", sorted(_forms()))
def test_first_optimizer_matches_jax(form):
    configured, want = _forms()[form]
    got = PL._first_optimizer(configured)
    assert got == want  # the very optimizer and scheduler objects
    assert got == JL._first_optimizer(configured)
    assert PL._is_optimizer(got[0])


def test_first_optimizer_refuses_manual_optimization():
    for mod in (PL, JL):
        with pytest.raises(NotImplementedError, match="manual"):
            mod._first_optimizer(None)


def test_unwrap_scheduler_matches_jax():
    lin = torch.nn.Linear(2, 1)
    sched = torch.optim.lr_scheduler.StepLR(
        torch.optim.SGD(lin.parameters(), lr=0.1), 1)
    for s in (None, sched, {"scheduler": None}, {"scheduler": sched},
              {"scheduler": sched, "interval": "step", "frequency": "3"}):
        assert PL._unwrap_scheduler(s) == JL._unwrap_scheduler(s)
    assert PL._unwrap_scheduler({"scheduler": sched, "frequency": "3"}) == \
        (sched, "epoch", 3)


def test_lightning_first_optimizer_unpacking():
    """tests/test_spark_ray.py's unpacking tests on the port."""
    lin = torch.nn.Linear(2, 1)
    opt = torch.optim.SGD(lin.parameters(), lr=0.1)
    sched = torch.optim.lr_scheduler.StepLR(opt, 1)
    f = PL._first_optimizer
    assert f(opt) == (opt, None)
    assert f([opt]) == (opt, None)
    assert f(([opt], [sched])) == (opt, (sched, "epoch", 1))
    assert f((opt, sched)) == (opt, (sched, "epoch", 1))
    assert f({"optimizer": opt, "lr_scheduler": sched}) == \
        (opt, (sched, "epoch", 1))
    assert f(([opt], [{"scheduler": sched, "interval": "step",
                       "frequency": 2}])) == (opt, (sched, "step", 2))
    assert f([{"optimizer": opt}]) == (opt, None)
    opt2 = torch.optim.SGD(lin.parameters(), lr=0.2)
    assert f((opt, opt2)) == (opt, None)


# ------------------------------------------------------------------- fits
def _callbacks_fit(mod, root, stop=True, tasks=1, epochs=5):
    ev, log = str(root / "events.txt"), str(root / "logger.jsonl")
    est = _est(mod, mod.FilesystemStore(str(root / "store")),
               TL.LogValModule, epochs, tasks=tasks, validation=0.25,
               metrics=["mse"],
               callbacks=[TL.FileRecorderCB(ev)]
               + ([TL.StopAfter2CB()] if stop else []),
               logger=TL.FileLogger(log), log_every_n_steps=2,
               gradient_clip_val=TL.CLIP)
    return est, ev, log


def test_callbacks_logger_validation_and_clip_match_jax(tmp_path,
                                                        cpu_tasks):
    """tests/test_spark_ray.py's callbacks, logger, validation and clip
    test on both packages, one task each: everything either wrote is the
    same, bitwise."""
    df = _linear_data(128)
    (tmp_path / "j").mkdir()
    (tmp_path / "p").mkdir()
    jest, jev, jlog = _callbacks_fit(JSP, tmp_path / "j")
    est, ev, log = _callbacks_fit(spark, tmp_path / "p")
    model, want = _fit_both(jest, est, df)

    assert model.history == want.history
    assert _lines(ev) == _lines(jev)
    assert _lines(log) == _lines(jlog)
    _same_state(_state(E, est.store), _state(JE, jest.store))
    x = df["features"][:16]
    np.testing.assert_array_equal(model.transform({"features": x})["predict"],
                                  want.transform({"features": x})["predict"])

    # the JAX test's own assertions, on the port's fit
    events = [e.split()[0] for e in _lines(ev)]
    assert events[0] == "start" and events[-1] == "end"
    assert "epoch0" in events and "epoch1" in events
    assert "epoch2" not in events  # should_stop honoured
    assert "val" in events
    hist = model.history
    assert len(hist["val_loss"]) == 2 and len(hist["val_mse"]) == 2
    assert "val_mae" in hist and 0 < hist["val_mae"][-1] < 10
    rows = [json.loads(line) for line in _lines(log)]
    assert rows[-1].get("finalized") == "success"
    logged = [r for r in rows if "metrics" in r]
    keys = set().union(*(set(r["metrics"]) for r in logged))
    assert {"train_loss_logged", "val_mae", "val_loss"} <= keys
    steps = [r["step"] for r in logged if r["step"] is not None]
    assert steps == sorted(steps)


def _close_records(got, want, rtol):
    """Two JSON-lines records alike: the same keys, steps and strings,
    numbers within ``rtol``."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = json.loads(g), json.loads(w)
        assert g.keys() == w.keys() and g.get("step") == w.get("step")
        for k in w:
            if isinstance(w[k], dict):
                assert sorted(g[k]) == sorted(w[k])
                for m in w[k]:
                    assert abs(g[k][m] - w[k][m]) <= rtol * abs(w[k][m]), m
            elif k != "step":
                assert g[k] == w[k]


def test_two_tasks_match_jax(tmp_path, cpu_tasks, monkeypatch):
    """Two gloo tasks, 4 epochs, on both packages with the callbacks fit's
    surface (validation, ``self.log``, the logger, the clip): the port's
    history, logger records and weights within ``TWO_TASK_RTOL`` of the
    JAX package's."""
    df = _linear_data()
    (tmp_path / "j").mkdir()
    (tmp_path / "p").mkdir()
    est, ev, log = _callbacks_fit(spark, tmp_path / "p", stop=False,
                                  tasks=2, epochs=4)
    jest, jev, jlog = _callbacks_fit(JSP, tmp_path / "j", stop=False,
                                     tasks=2, epochs=4)
    monkeypatch.setenv("JAX_ENABLE_X64", "1")
    # the JAX tasks' native controller on a port of its own
    model, want = _fit_both(jest, est, df, jax_env={
        "HOROVOD_CONTROLLER_PORT": str(hold_ports(1).release()[0])})
    want = want.history

    assert sorted(model.history) == sorted(want)
    assert {"val_loss", "val_mae", "val_mse"} <= set(want)
    hgap = max(abs(a - b) / abs(b) for k in want
               for a, b in zip(model.history[k], want[k]))
    got, ref = _state(E, est.store), _state(JE, jest.store)
    wgap = max(float(((got[k] - ref[k]).abs() / ref[k].abs()).max())
               for k in ref)
    assert hgap <= TWO_TASK_RTOL and wgap <= TWO_TASK_RTOL, (hgap, wgap)
    _close_records(_lines(log), _lines(jlog), TWO_TASK_RTOL)
    # both ranks' callbacks write the one file, in either order
    assert sorted(e.split()[:2] for e in _lines(ev)) == \
        sorted(e.split()[:2] for e in _lines(jev))


def test_lightning_estimator_end_to_end(tmp_path, cpu_tasks):
    """tests/test_spark_ray.py's end-to-end test on the port: two tasks, 10
    epochs, the transformer's error bound."""
    df = _linear_data()
    model = _fit(_est(spark, spark.FilesystemStore(str(tmp_path)),
                      TL.ToyModule, 10, tasks=2), df, limit=240)
    x, y = df["features"][:16], df["label"][:16]
    out = model.transform({"features": x, "label": y})
    assert float(np.mean((out["predict"] - y) ** 2)) < 0.5


def test_a_jax_store_resumes_in_the_port(tmp_path, cpu_tasks):
    """Two epochs by the JAX estimator, then the port's ``fit_on_parquet``
    to four, against the JAX package's own continuation from a copy: the
    history (the logger's steps after the resume included) and the weights
    bitwise."""
    df = _linear_data(128)
    (tmp_path / "j").mkdir()
    jest, _, _ = _callbacks_fit(JSP, tmp_path / "j", stop=False)
    jest.epochs = 2
    first = _fit(jest, df)
    shutil.copytree(tmp_path / "j", tmp_path / "j2")
    for root in ("j", "j2"):
        for name in ("events.txt", "logger.jsonl"):
            os.remove(tmp_path / root / name)

    est, ev, log = _callbacks_fit(spark, tmp_path / "j", stop=False)
    est.epochs = 4
    own_est, own_ev, own_log = _callbacks_fit(JSP, tmp_path / "j2",
                                              stop=False)
    own_est.epochs = 4
    resumed, own = _fit_both(own_est, est)

    assert len(resumed.history["train_loss"]) == 4
    assert resumed.history["train_loss"][:2] == first.history["train_loss"]
    assert resumed.history == own.history
    assert _lines(ev) == _lines(own_ev)
    # on_train_start after the resume sees the steps of the epochs before
    assert _lines(ev)[0] != "start 0"
    assert _lines(log) == _lines(own_log)
    _same_state(_state(E, est.store), _state(JE, own_est.store))


def test_an_nn_module_is_moved_and_served(tmp_path, cpu_tasks):
    """A module with ``.to``: trained, checkpointed as CPU tensors, and the
    JAX package's loader predicts alike from the port's envelope."""
    df = _linear_data(128)
    est = _est(spark, spark.FilesystemStore(str(tmp_path)),
               TL.nn_toy_module, 3)
    model = _fit(est, df)
    tl = model.history["train_loss"]
    assert len(tl) == 3 and tl[-1] < tl[0]
    x = df["features"][:8]
    want = JSP.LightningEstimator(JSP.FilesystemStore(str(tmp_path)),
                                  TL.nn_toy_module)._load_model(
        E._load_epoch_checkpoint(est.store, "run0")["model"])(x)
    np.testing.assert_array_equal(model.transform({"features": x})["predict"],
                                  want)


# ----------------------------------------------------------------- the rest
def test_lightning_rejects_sample_weight_col_and_a_loss_metric(tmp_path):
    """tests/test_spark_estimator_depth.py's guard, and the metric that
    would collide with ``val_loss``."""
    store = spark.FilesystemStore(str(tmp_path))
    with pytest.raises(ValueError, match="sample_weight_col"):
        spark.LightningEstimator(store, TL.ToyModule, sample_weight_col="wt")

    def loss(p, y):
        return 0.0
    with pytest.raises(ValueError, match="collides"):
        spark.LightningEstimator(store, TL.ToyModule, metrics=[loss])


def test_task_without_a_card_raises(tmp_path, monkeypatch):
    """Not asked for the CPU and no card: the Lightning and Keras tasks'
    ``hvd.init()`` raises before anything else (keras is never imported);
    nothing falls back to the CPU."""
    monkeypatch.setattr(platform, "_cpu_forced", False)
    monkeypatch.setattr(_rt, "_runtime", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    store = spark.FilesystemStore(str(tmp_path))
    df = _linear_data(16)
    train, _ = spark.prepare_data(store, df, ["features"], ["label"])
    keras_loaded = "keras" in sys.modules
    for est in (spark.LightningEstimator(store, TL.ToyModule),
                spark.KerasEstimator(store, TL.ToyModule)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            est._make_train_task()(train)
    assert not _rt.is_initialized()
    assert ("keras" in sys.modules) == keras_loaded
    assert spark.KerasEstimator(store, TL.ToyModule)._task_env() == \
        {"KERAS_BACKEND": "torch", "JAX_PLATFORMS": "cpu"}


_REHEARSAL = """
import sys
import numpy as np
import torch
sys.path.insert(0, {repo!r})
torch.set_num_threads(1)
from horovod_tpu_torch.utils import platform
platform.force_cpu()
import chip_smoke as C
if __name__ == "__main__":
    cpu = C.ESTIMATOR_CPU
    ref = C.cluster_task(dict(device="cpu", cfg=cpu["cfg_name"],
                              batch=cpu["batch"], seq=cpu["seq"],
                              steps=C.ESTIMATOR_LLAMA_BATCHES))
    out = C.phase_lightning(torch, np, "CPU", ref["losses"], 0.0,
                            device_type="cpu", keras=False, **cpu)
    assert out["launches"] == {{n: 0 for n in C.REPLACES}}, out
    print("REHEARSAL-OK", flush=True)
"""


def test_chip_smoke_lightning_rehearsal_on_cpu():
    """``chip_smoke.py`` phase 23 (a) and (b) on the CPU at
    ``ESTIMATOR_CPU``, in a subprocess of its own session, killed at its
    time limit."""
    env = dict(os.environ, OMP_NUM_THREADS="1",
               HOROVOD_CONTROLLER_PORT=str(hold_ports(1).release()[0]))
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    p = subprocess.Popen([sys.executable, "-c", _REHEARSAL.format(
        repo=REPO)], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, start_new_session=True)
    try:
        out, err = p.communicate(timeout=300)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        out, err = p.communicate()
        pytest.fail(f"the rehearsal did not end in 300 s: "
                    f"{out.decode()[-3000:]} {err.decode()[-3000:]}")
    out, err = out.decode(), err.decode()
    assert p.returncode == 0 and "REHEARSAL-OK" in out, (out[-4000:],
                                                         err[-4000:])
    for line in ("estimator [lightning mnist] cpu: ",
                 "estimator [lightning llama] cpu: ",
                 "lightning [llama tiny]: transform on cpu",
                 "lightning [keras]: the Keras estimator was not run"):
        assert line in out, line


def test_lightning_example_learns():
    """``examples/torch_port/lightning_spark_mnist.py --np 2 --cpu --epochs
    2``, as ``tests/test_examples_smoke.py`` runs the JAX package's: its
    own accuracy and logger checks, two gloo tasks."""
    coord, ctrl = hold_ports(2).release()
    env = dict(os.environ, OMP_NUM_THREADS="1",
               HOROVOD_CONTROLLER_PORT=str(ctrl))
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    p = subprocess.Popen(
        [sys.executable, os.path.join(REPO, "examples", "torch_port",
                                      "lightning_spark_mnist.py"),
         "--np", "2", "--cpu", "--epochs", "2", "--coordinator-port",
         str(coord)], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, start_new_session=True)
    try:
        out, err = p.communicate(timeout=240)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        p.communicate()
        pytest.fail("lightning_spark_mnist.py did not end in 240 s")
    out = out.decode()
    assert p.returncode == 0, (out[-2000:], err.decode()[-3000:])
    assert "holdout accuracy" in out and "logger captured" in out
    assert "OK" in out
