"""``examples/torch_port/mlp_mnist.py``, the counterpart of
``examples/jax/mlp_mnist.py``: its workers, placed by ``hvd.run`` on two
gloo tasks from the JAX ``mlp.init`` weights (``params_from_jax``),
against the JAX example's loop on two CPU devices over the same generated
data, each step's loss within rtol 5e-5 and atol 1e-6; and the script run
as a user runs it, learning.

The bound: the first step's losses are equal, the second's 4e-6 apart
(relative), and the gap reaches 2.8e-5 within the epoch.  Adam's first updates are near +-lr for every
weight whatever its gradient's size, so a gradient element that rounds
to another sign near zero moves a whole update; the XLA and the PyTorch
products round differently.  The atol covers the tail, where the loss
falls below 1e-6 and a relative bound reads rounding."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import signal  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import horovod_tpu_torch as hvd  # noqa: E402

from torch_port_deadline import deadline  # noqa: E402
from torch_port_ports import hold_ports  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
EXAMPLES = os.path.join(REPO, "examples", "torch_port")
if EXAMPLES not in sys.path:
    sys.path.insert(0, EXAMPLES)
import mlp_mnist as M  # noqa: E402

EPOCHS, BATCH, LR = 1, 128, 1e-3


def _jax_losses(params):
    """The JAX example's loop (examples/jax/mlp_mnist.py) on two CPU
    devices."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import Mesh
    from horovod_tpu.models import mlp
    from horovod_tpu.parallel.data_parallel import (make_train_step,
                                                    replicate, shard_batch)
    mesh = Mesh(np.array(jax.devices()[:2]), ("hvd",))
    opt = optax.adam(LR)

    def loss_fn(p, batch):
        x, y = batch[:, :-1], batch[:, -1].astype(jnp.int32)
        return optax.softmax_cross_entropy_with_integer_labels(
            mlp.apply(p, x), y).mean()

    step = make_train_step(loss_fn, opt, mesh, donate=False)
    p, s = replicate(params, mesh), replicate(opt.init(params), mesh)
    x, y = M.make_data()
    data = np.concatenate([x, y[:, None].astype("float32")], axis=1)
    n_batches = len(data) // BATCH
    out = []
    for _ in range(EPOCHS):
        for b in range(n_batches):
            batch = shard_batch(jnp.asarray(data[b * BATCH:(b + 1) * BATCH]),
                                mesh)
            p, s, loss = step(p, s, batch)
            out.append(float(loss))
    return out


def test_workers_train_like_the_jax_example():
    import jax
    from horovod_tpu.models import mlp
    params = mlp.init(jax.random.PRNGKey(0), in_dim=784, hidden=256,
                      classes=10)
    tree = jax.tree_util.tree_map(np.asarray, params)
    with deadline(180, "mlp_mnist.train on two tasks"):
        got = hvd.run(M.train, args=(EPOCHS, BATCH, LR, True, tree), np=2,
                      coordinator_port=hold_ports(1).release()[0])
    assert got[0] == got[1]
    want = _jax_losses(params)
    np.testing.assert_allclose(got[0], want, rtol=5e-5, atol=1e-6)


def test_the_script_learns():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    p = subprocess.Popen(
        [sys.executable, os.path.join(EXAMPLES, "mlp_mnist.py"), "--np", "2",
         "--cpu", "--epochs", "2"], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        start_new_session=True)
    try:
        out, err = p.communicate(timeout=180)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        p.communicate()
        pytest.fail("mlp_mnist.py did not end in 180 s")
    out, err = out.decode(), err.decode()
    assert p.returncode == 0, (out[-2000:], err[-3000:])
    assert "workers=2 device=cpu" in out
    assert "epoch 1: loss=" in out and "done" in out, out
