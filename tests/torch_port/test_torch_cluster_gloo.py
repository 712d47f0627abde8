"""The ``tiny`` Llama trained data-parallel on two gloo tasks placed by the
port's cluster layer, ``spark.run`` (``LocalTaskExecutor``) and
``RayExecutor`` (``LocalWorkerPool``), from the JAX weights
(``params_from_jax``) and batches: each task's losses against the JAX
data-parallel step on two CPU devices at the tolerance
``test_torch_runner_gloo.py`` holds the launched step to (rtol and atol
1e-5), and the parameters bitwise equal across the tasks and between the
two placements.  The tasks run ``torch_port_cluster_worker.train_tiny``;
each placement has a time limit of its own."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from horovod_tpu_torch import spark  # noqa: E402
from horovod_tpu_torch.ray import LocalWorkerPool, RayExecutor  # noqa: E402

import torch_port_cluster_worker as W  # noqa: E402
from torch_port_deadline import deadline  # noqa: E402
from torch_port_ports import hold_ports  # noqa: E402

OPT_KW = dict(lr=1e-3, betas=(0.9, 0.999), eps=1e-3, weight_decay=0.01)
TOL = dict(rtol=1e-5, atol=1e-5)
STEPS = 3


@pytest.fixture(scope="module")
def placed(tmp_path_factory):
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import Mesh
    from horovod_tpu.models import llama as JL
    from horovod_tpu.parallel.data_parallel import (make_train_step,
                                                    replicate, shard_batch)
    cfg = JL.CONFIGS["tiny"]
    params = JL.init(jax.random.PRNGKey(0), cfg)
    rng = np.random.RandomState(0)
    batches = [rng.randint(0, cfg.vocab, (4, 33)).astype(np.int32)
               for _ in range(STEPS)]
    path = str(tmp_path_factory.mktemp("cluster") / "inputs.npy")
    np.save(path, np.array(
        {"tree": jax.tree_util.tree_map(np.asarray, params),
         "batches": batches, "opt_kw": OPT_KW}, dtype=object),
        allow_pickle=True)
    with deadline(120, "spark.run of the tiny Llama on two tasks"):
        by_spark = spark.run(W.train_tiny, args=(path,), num_proc=2,
                             executor=spark.LocalTaskExecutor(2),
                             coordinator_port=hold_ports(1).release()[0])
    ex = RayExecutor(num_workers=2, pool=LocalWorkerPool(),
                     coordinator_port=hold_ports(1).release()[0])
    try:
        with deadline(120, "RayExecutor of the tiny Llama on two workers"):
            ex.start()
            by_ray = ex.run(W.train_tiny, args=(path,))
    finally:
        ex.shutdown()
    mesh = Mesh(np.array(jax.devices()[:2]), ("hvd",))
    opt = optax.adamw(OPT_KW["lr"], b1=0.9, b2=0.999, eps=OPT_KW["eps"],
                      weight_decay=OPT_KW["weight_decay"])
    step = make_train_step(lambda p, ids: JL.loss_fn(p, ids, cfg), opt, mesh,
                           donate=False)
    jp, js = replicate(params, mesh), replicate(opt.init(params), mesh)
    losses = []
    for b in batches:
        jp, js, loss = step(jp, js, shard_batch(jnp.asarray(b), mesh))
        losses.append(float(loss))
    return {"spark": by_spark, "ray": by_ray, "jax_losses": losses,
            "jax_params": jax.tree_util.tree_map(np.asarray, jp)}


@pytest.mark.parametrize("placement", ["spark", "ray"])
def test_tasks_train_like_jax(placed, placement):
    from test_torch_llama import _jax_grads_as_torch  # same name mapping
    ref = _jax_grads_as_torch(placed["jax_params"])
    tasks = placed[placement]
    assert [(t["rank"], t["size"]) for t in tasks] == [(0, 2), (1, 2)]
    for t in tasks:
        np.testing.assert_allclose(t["losses"], placed["jax_losses"], **TOL)
        for name, p in t["params"].items():
            np.testing.assert_allclose(p.numpy(), ref[name], err_msg=name,
                                       **TOL)


@pytest.mark.parametrize("placement", ["spark", "ray"])
def test_parameters_bitwise_equal_across_tasks(placed, placement):
    first, second = placed[placement]
    assert first["losses"] == second["losses"]
    for name, p in first["params"].items():
        assert p.device.type == "cpu"
        assert torch.equal(p, second["params"][name]), name


def test_both_placements_train_alike(placed):
    for a, b in zip(placed["spark"], placed["ray"]):
        assert a["losses"] == b["losses"]
        for name, p in a["params"].items():
            assert torch.equal(p, b["params"][name]), name
