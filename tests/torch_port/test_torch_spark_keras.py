"""``horovod_tpu_torch.spark.KerasEstimator`` (keras's torch backend)
against ``horovod_tpu.spark.KerasEstimator`` (keras's jax backend, as this
suite's ``conftest.py`` pins it), both training on the CPU from the same
numpy-seeded data and a model whose initial weights come from a seeded
numpy stream (``torch_port_keras.py``).

A process has one keras backend, fixed at keras's first import, so the
port's cases run in one module-scoped subprocess with
``KERAS_BACKEND=torch`` and ``CUDA_VISIBLE_DEVICES=`` (its keras import
paid once, its fits placed at once from threads), while this process fits
the JAX package's side, also from threads; the case that needs a
JAX-written Store waits for it.  The checks:

- one task and two gloo tasks: the history and the final weights within
  rtol 1e-5 of the JAX package's (float32; the JAX package's keras tests'
  tolerance, ``tests/test_keras.py``), and the driver's predictions;
- ``tests/test_spark_ray.py``'s callbacks that freeze the weights after
  epoch 0, and its early stop, on the port;
- a Store the JAX estimator wrote for 2 epochs resumes in the port's
  ``fit_on_parquet`` to 4, within rtol 1e-5 of the JAX package's own
  continuation, the first 2 epochs' history bitwise;
- under another backend the port's task and its driver-side loader raise,
  naming it;
- ``examples/torch_port/keras_spark_mnist.py --cpu --epochs 2`` reaches
  its own accuracy check.

Every process of the port runs one thread; each placement has a time
limit, and the subprocesses are killed at theirs."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import json  # noqa: E402
import pickle  # noqa: E402
import shutil  # noqa: E402
import signal  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import horovod_tpu.spark as JSP  # noqa: E402
from horovod_tpu.spark import estimator as JE  # noqa: E402

import torch_port_keras as TK  # noqa: E402
from torch_port_deadline import deadline  # noqa: E402
from torch_port_ports import hold_ports  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
HERE = os.path.dirname(os.path.abspath(__file__))
RTOL = 1e-5
COMMON = dict(feature_cols=["features"], label_cols=["label"],
              batch_size=16, lr=0.1, validation=0.25, metrics=["mse"])

# The port's cases, in a process whose keras runs on torch.  Each prints
# one "CASE <name> <json>" line; a case that raises prints its error.
_PORT_CASES = """
import json, os, sys, time, traceback
import numpy as np
sys.path[:0] = [{repo!r}, {here!r}]
import torch
torch.set_num_threads(1)
from horovod_tpu_torch.utils import platform
platform.force_cpu()
import keras
from horovod_tpu_torch import spark
from horovod_tpu_torch.spark import estimator as E
import torch_port_keras as TK
root = {root!r}
ports = {ports!r}
common = {common!r}


def est(name, epochs, fn=TK.mlp_model_fn, tasks=1, **kw):
    return spark.KerasEstimator(
        spark.FilesystemStore(os.path.join(root, name)), fn,
        num_proc=tasks, epochs=epochs,
        executor=spark.LocalTaskExecutor(tasks),
        coordinator_port=ports.pop(), **dict(common, **kw))


data = TK.make_data()
x = data["features"][:8]
lin = {{"features": data["features"],
        "label": data["features"] @ np.ones((3, 1))}}
lin64 = {{k: v[:64] for k, v in lin.items()}}
fits = {{
    "parity1": (est("port1", 3), data),
    "parity2": (est("port2", 3, tasks=2), data),
    "freeze": (est("freeze", 4, fn=TK.dense_model_fn, lr=0.05,
                   validation=None, metrics=[], batch_size=32, callbacks=[
                       keras.callbacks.LearningRateScheduler(
                           TK.freeze_after_first_epoch)]), lin),
    "early_stop": (est("stop", 10, fn=TK.dense_model_fn, lr=0.0,
                       validation=None, metrics=[], batch_size=32,
                       callbacks=[keras.callbacks.EarlyStopping(
                           monitor="loss", patience=1, min_delta=1e-9)]),
                   lin64),
    "resume": (est("jax_resume", 4), None),
}}
# every dataset written here first, as fit writes it (a pyarrow write in
# one thread beside a spawn in another crashed a process); the JAX-written
# Store's dataset is read as fit_on_parquet reads it
paths = {{}}
for name, (e, df) in fits.items():
    paths[name] = ((e.store.get_train_data_path(e.run_id),
                    e.store.get_val_data_path(e.run_id)) if df is None
                   else spark.prepare_data(
                       e.store, df, e.feature_cols, e.label_cols,
                       validation=e.validation, seed=e.seed,
                       run_id=e.run_id))
errors = {{}}


def place(name):
    e = fits[name][0]
    try:
        if name == "resume":
            ready = os.path.join(root, "jax_store_ready")
            t = time.time()
            while not os.path.exists(ready):
                if time.time() - t > 240:
                    raise TimeoutError("the JAX-written Store never came")
                time.sleep(0.2)
        spark.run(e._make_train_task(), args=paths[name],
                  num_proc=e.num_proc, executor=e.executor,
                  env=e._task_env(), coordinator_port=e.coordinator_port)
    except BaseException:
        errors[name] = traceback.format_exc()


# the placements at once, each fit's tasks processes of their own (one-task
# fits bring up no native controller, so they share no port)
import threading
threads = [threading.Thread(target=place, args=(n,)) for n in fits]
for t in threads:
    t.start()
for t in threads:
    t.join()


def model(name):
    e = fits[name][0]
    env = E._load_epoch_checkpoint(e.store, e.run_id)
    return E.EstimatorModel(e._load_model(env["model"]), e.feature_cols,
                            history=env.get("history"))


def parity(name):
    return {{"predict": model(name).transform({{"features": x}})["predict"]
             .tolist(), "backend": keras.backend.backend()}}


for name in fits:
    if name in errors:
        out = {{"error": errors[name]}}
    else:
        try:
            out = (parity(name) if name.startswith("parity")
                   else model(name).history)
        except BaseException:
            out = {{"error": traceback.format_exc()}}
    print("CASE " + name + " " + json.dumps(out), flush=True)
print("CASES-DONE", flush=True)
"""

# keras on jax in a process of its own: the port's task and loader raise
_OTHER_BACKEND = """
import os, sys
sys.path[:0] = [{repo!r}, {here!r}]
import keras
assert keras.backend.backend() == "jax"
import numpy as np
import torch
torch.set_num_threads(1)
from horovod_tpu_torch.utils import platform
platform.force_cpu()
from horovod_tpu_torch import spark
import torch_port_keras as TK
store = spark.FilesystemStore({root!r})
train, _ = spark.prepare_data(store, TK.make_data(16), ["features"],
                              ["label"])
est = spark.KerasEstimator(store, TK.dense_model_fn)
for what, call in (("task", lambda: est._make_train_task()(train)),
                   ("loader", lambda: est._load_model(b""))):
    try:
        call()
        print(what, "did not raise")
    except RuntimeError as e:
        print(what, "RAISED", e)
"""


def _ctrl_port() -> dict:
    """A native controller's port of its own for one job's tasks."""
    return {"HOROVOD_CONTROLLER_PORT": str(hold_ports(1).release()[0])}


def _spawn(prog: str, env: dict, *args) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable] + (["-c", prog] if prog else list(args)),
        cwd=REPO, env=dict(env, **_ctrl_port()), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, start_new_session=True)


def _finish(p: subprocess.Popen, what: str, limit: float) -> str:
    try:
        out, err = p.communicate(timeout=limit)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        out, err = p.communicate()
        pytest.fail(f"{what} did not end in {limit} s: "
                    f"{out.decode()[-3000:]} {err.decode()[-3000:]}")
    out, err = out.decode(), err.decode()
    assert p.returncode == 0, (what, out[-3000:], err[-3000:])
    return out


def _jax_est(root, name, epochs, tasks=1):
    return JSP.KerasEstimator(JSP.FilesystemStore(os.path.join(root, name)),
                              TK.mlp_model_fn, num_proc=tasks,
                              epochs=epochs, **COMMON)


def _jax_place(est, paths):
    """The JAX package's tasks of ``est`` on ``paths``, placed as its fit
    places them, on a held coordinator port."""
    JSP.run(est._make_train_task(), args=paths, num_proc=est.num_proc,
            executor=JSP.LocalTaskExecutor(est.num_proc),
            coordinator_port=hold_ports(1).release()[0])
    return JE._load_epoch_checkpoint(est.store, est.run_id)


def _jax_side(root: str) -> dict:
    """The JAX package's fits: one and two tasks, and the 2-epoch Store the
    port resumes (the marker file says it is there) with, from a copy, the
    JAX package's own continuation to 4.  The datasets are written and the
    models loaded in this thread; only the placements run at once, from
    threads (a pyarrow write in one thread beside a spawn in another
    crashed a process)."""
    data = TK.make_data()
    ests = {"parity1": _jax_est(root, "jax1", 3),
            "parity2": _jax_est(root, "jax2", 3, tasks=2),
            "resume2": _jax_est(root, "jax_resume", 2)}
    paths = {k: JSP.prepare.prepare_data(
        e.store, data, e.feature_cols, e.label_cols, validation=e.validation,
        seed=e.seed, run_id=e.run_id) for k, e in ests.items()}
    out, errors = {}, []

    def resume():
        out["resume2"] = _jax_place(ests["resume2"], paths["resume2"])
        shutil.copytree(os.path.join(root, "jax_resume"),
                        os.path.join(root, "jax_own"))
        open(os.path.join(root, "jax_store_ready"), "w").close()
        own = _jax_est(root, "jax_own", 4)
        out["own"] = _jax_place(own, (
            own.store.get_train_data_path(own.run_id),
            own.store.get_val_data_path(own.run_id)))

    def parity(name):
        out[name] = _jax_place(ests[name], paths[name])

    def guarded(fn, *args):
        try:
            fn(*args)
        except BaseException as e:  # reported by the main thread
            errors.append(e)

    threads = [threading.Thread(target=guarded, args=a, daemon=True)
               for a in ((resume,), (parity, "parity1"),
                         (parity, "parity2"))]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CUDA_VISIBLE_DEVICES", "")
        mp.setenv("OMP_NUM_THREADS", "1")
        mp.setenv("HOROVOD_CONTROLLER_PORT",
                  _ctrl_port()["HOROVOD_CONTROLLER_PORT"])
        # the JAX sync's float64 epoch loss stays float64, as the port's
        mp.setenv("JAX_ENABLE_X64", "1")
        with deadline(300, "the JAX package's fits"):
            for t in threads:
                t.start()
            for t in threads:
                t.join()
    if errors:
        raise errors[0]
    for name in ("parity1", "parity2"):
        predict = ests[name]._load_model(out[name]["model"])
        out[name.replace("parity", "predict")] = predict(data["features"][:8])
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("keras"))
    base = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    base["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in base.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    fmt = dict(repo=REPO, here=HERE, root=root, common=COMMON)
    port = _spawn(_PORT_CASES.format(ports=hold_ports(6).release(), **fmt),
                  dict(base, KERAS_BACKEND="torch"))
    other = _spawn(_OTHER_BACKEND.format(**dict(fmt, root=os.path.join(
        root, "other"))), dict(base, KERAS_BACKEND="jax"))
    example = _spawn(None, base, os.path.join(
        REPO, "examples", "torch_port", "keras_spark_mnist.py"), "--np", "1",
        "--cpu", "--epochs", "2", "--coordinator-port",
        str(hold_ports(1).release()[0]))
    try:
        jax = _jax_side(root)
        out = _finish(port, "the port's keras cases", 300)
        cases = {}
        for line in out.splitlines():
            if line.startswith("CASE "):
                _, name, rest = line.split(" ", 2)
                cases[name] = json.loads(rest)
        assert "CASES-DONE" in out, out[-3000:]
        return {"root": root, "jax": jax, "port": cases,
                "other": _finish(other, "the jax-backend process", 300),
                "example": _finish(example, "keras_spark_mnist.py", 300)}
    finally:
        for p in (port, other, example):
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.communicate()


def _port_case(runs, name):
    out = runs["port"][name]
    assert "error" not in out, out.get("error")
    return out


def _port_env(runs, name):
    return JE._load_epoch_checkpoint(
        JSP.FilesystemStore(os.path.join(runs["root"], name)), "run0")


def _close(got_env, want_env):
    """History and final weights within ``RTOL``."""
    got, want = got_env["history"], want_env["history"]
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=0,
                                   err_msg=k)
    gw, ww = pickle.loads(got_env["model"]), pickle.loads(want_env["model"])
    assert [w.shape for w in gw] == [w.shape for w in ww]
    for a, b in zip(gw, ww):
        assert isinstance(a, np.ndarray) and a.dtype == np.float32
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=1e-7)


@pytest.mark.parametrize("tasks", [1, 2])
def test_keras_matches_jax(runs, tasks):
    out = _port_case(runs, f"parity{tasks}")
    assert out["backend"] == "torch"
    env = _port_env(runs, f"port{tasks}")
    _close(env, runs["jax"][f"parity{tasks}"])
    assert len(env["history"]["val_mse"]) == 3
    assert env["history"]["train_loss"][-1] < env["history"]["train_loss"][0]
    np.testing.assert_allclose(out["predict"], runs["jax"][f"predict{tasks}"],
                               rtol=RTOL, atol=1e-6)


def test_keras_estimator_runs_callbacks(runs):
    """tests/test_spark_ray.py's: an LR schedule that zeroes the rate after
    epoch 0 freezes the weights, so the train loss is the same from epoch 1
    on."""
    tl = _port_case(runs, "freeze")["train_loss"]
    assert len(tl) == 4
    assert tl[1] < tl[0]                 # epoch 0 trained
    assert abs(tl[2] - tl[3]) < 1e-12    # frozen: lr=0 from epoch 1


def test_keras_estimator_early_stopping(runs):
    """tests/test_spark_ray.py's: ``model.stop_training`` (EarlyStopping)
    ends the fit before its epochs."""
    assert len(_port_case(runs, "early_stop")["train_loss"]) < 10


def test_keras_resumes_a_jax_store(runs):
    hist = _port_case(runs, "resume")
    env = _port_env(runs, "jax_resume")
    assert env["epoch"] == 3 and hist == env["history"]
    first = runs["jax"]["resume2"]["history"]
    assert {k: v[:2] for k, v in hist.items()} == first  # bitwise
    _close(env, runs["jax"]["own"])


def test_keras_refuses_another_backend(runs):
    out = runs["other"]
    for what in ("task", "loader"):
        assert f"{what} RAISED" in out and "'jax'" in out, out


def test_keras_example_learns(runs):
    out = runs["example"]
    assert "holdout accuracy" in out and "OK" in out, out[-2000:]
