"""Training the zoo on the port against the JAX package.

* Three SGD-momentum steps of ResNet-50 (32 px, batch 2, lr 1e-2; with
  the running statistics nothing normalizes the activations, so each
  block's last BN scale is cut to a fifth, which keeps the logits near
  1, as the last-BN init of real ResNet recipes does) through the port's
  ``make_train_step`` and
  ``DistributedOptimizer`` at one rank against the JAX loop of
  ``bench.py`` ``resnet_bench`` (value_and_grad, ``optax.sgd``,
  ``apply_updates`` on the new parameters, the running statistics' eval-mode
  gradients zeroed as training mode leaves them), BN in eval mode
  (training mode: ``torch_port_zoo``): losses within 1e-5, parameters and
  statistics within 1e-5 of each tensor's largest magnitude.  In training mode the recipe's step
  (``zoo.make_cnn_train_step``) at one rank is the plain SGD loop on the
  model bitwise, BN statistics included.
* The MLP of tests/test_models.py (Adam 1e-2, 30 steps of 64 rows)
  data-parallel on two gloo ranks against the JAX ``make_train_step`` on
  two CPU devices: losses within 1e-4 relative, parameters within 1e-4.
* Sync-BN on two gloo ranks, each with half of a batch whose halves have
  different means: the statistics are the global batch's (the float64
  mean and biased variance within 1e-5 relative), output and gradients
  equal one process's BN over the whole batch (1e-5); the JAX formula
  (``pmean`` of each rank's variance, under ``vmap`` with an axis name)
  falls short of the global variance by the variance of the ranks'
  means."""

import os
import time

import numpy as np
import optax
import pytest
import torch
import torch.multiprocessing as tmp

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from horovod_tpu.models import layers as JL
from horovod_tpu.models import mlp as JM
from horovod_tpu.models import resnet as JR
from horovod_tpu.parallel.data_parallel import (make_train_step, replicate,
                                                shard_batch)
import horovod_tpu_torch as hvd
from horovod_tpu_torch.models import layers as TL
from horovod_tpu_torch.models import resnet as TR
from horovod_tpu_torch.models import zoo

import torch_port_zoo_worker
from torch_port_ports import hold_ports
from torch_port_zoo import nhwc, numpy_params, numpy_tree, scaled_close


@pytest.fixture
def one_rank():
    hvd.init(device="cpu")
    yield
    hvd.shutdown()


def test_resnet50_three_sgd_steps_match_the_jax_loop(one_rank):
    params = numpy_params(lambda k: JR.init(k, depth=50, classes=10))
    for block in params.values():
        for bn in ("bn3", "bn_proj"):
            if isinstance(block, dict) and bn in block:
                block[bn]["scale"] = block[bn]["scale"] * 0.2
    rng = np.random.RandomState(0)
    batches = [nhwc(rng, 2, 32, 10) for _ in range(3)]
    lr = 1e-2
    opt = optax.sgd(lr, momentum=0.9)

    @jax.jit
    def one_step(p, s, x, y):
        (loss, new_p), g = jax.value_and_grad(
            lambda p, a, b: JR.loss_fn(p, a, b, depth=50, training=False),
            has_aux=True)(p, x, y)
        # in eval mode the running statistics get gradients, which the
        # bench loop (training mode) never gives them: they stay buffers
        g = jax.tree_util.tree_map_with_path(
            lambda path, a: jnp.zeros_like(a)
            if path[-1].key in ("mean", "var") else a, g)
        updates, s = opt.update(g, s)
        return optax.apply_updates(new_p, updates), s, loss

    p, s, ref = params, opt.init(params), []
    for x, y in batches:
        p, s, loss = one_step(p, s, jnp.asarray(x), jnp.asarray(y))
        ref.append(float(loss))

    model = TR.params_from_jax(params, 50, device="cpu")
    dopt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=lr, momentum=0.9),
        named_parameters=model.named_parameters())
    step = hvd.make_train_step(
        model, lambda m, x, y: TR.loss_fn(m, x, y, training=False), dopt)
    got = [float(step(torch.from_numpy(x), torch.from_numpy(y)))
           for x, y in batches]
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    assert np.all(np.isfinite(ref)) and max(ref) < 10, ref
    want = TL.state_from_jax(numpy_tree(p))
    for name, t in model.state_dict().items():
        scaled_close(t.numpy(), want[name], 1e-5, name)


def test_cnn_recipe_step_is_the_plain_sgd_loop_at_one_rank(one_rank):
    """Training mode at one rank: the recipe's step (DistributedOptimizer,
    no sync group) against SGD on the model directly, bitwise: losses,
    weights and BN statistics."""
    assert zoo.sync_group() is None
    gen = lambda: torch.Generator().manual_seed(3)
    a = zoo.cnn_init("resnet50", 10, torch.float32, gen(), "cpu")
    b = zoo.cnn_init("resnet50", 10, torch.float32, gen(), "cpu")
    fam = zoo.CNN_FAMILIES["resnet50"]
    step = zoo.make_cnn_train_step("resnet50", a, hvd.DistributedOptimizer(
        torch.optim.SGD(a.parameters(), lr=fam.lr, momentum=0.9),
        named_parameters=a.named_parameters()))
    plain = torch.optim.SGD(b.parameters(), lr=fam.lr, momentum=0.9)
    rng = np.random.RandomState(1)
    for _ in range(3):
        x, y = (torch.from_numpy(t) for t in nhwc(rng, 4, 32, 10))
        la = step(x, y)
        plain.zero_grad()
        lb = TR.loss_fn(b, x, y, training=True)
        lb.backward()
        plain.step()
        assert la.item() == lb.item()
    for (name, ta), tb in zip(a.state_dict().items(),
                              b.state_dict().values()):
        assert torch.equal(ta, tb), name
    assert not torch.equal(a.bn_stem.mean, torch.zeros(64))


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    rng = np.random.RandomState(0)
    mlp_tree = numpy_tree(JM.init(jax.random.PRNGKey(0), in_dim=64,
                                  hidden=32, classes=10))
    x = rng.randn(64, 64).astype(np.float32)
    y = rng.randint(0, 10, 64).astype(np.int32)
    mlp_batches = [(x, y)] * 30
    # halves of different means, so the ranks' means differ
    bx = rng.randn(8, 5, 4, 4).astype(np.float32)
    bx[4:] = bx[4:] * 2.0 + 3.0
    bn = {"x": bx, "w": rng.randn(*bx.shape).astype(np.float32),
          "params": {"scale": rng.rand(5).astype(np.float32) + 0.5,
                     "bias": rng.randn(5).astype(np.float32),
                     "mean": np.zeros(5, np.float32),
                     "var": np.ones(5, np.float32)}}
    out_dir = str(tmp_path_factory.mktemp("zoo"))
    port = hold_ports(1).release()[0]
    ctx = tmp.spawn(torch_port_zoo_worker.run,
                    args=(2, port, out_dir, mlp_tree, mlp_batches, bn),
                    nprocs=2, join=False)
    deadline = time.monotonic() + 180
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.terminate()
            pytest.fail("gloo ranks did not finish in 180 s")
    ranks = [np.load(os.path.join(out_dir, f"rank{r}.npy"),
                     allow_pickle=True).item() for r in range(2)]

    mesh = Mesh(np.array(jax.devices()[:2]), ("hvd",))
    step = make_train_step(JM.loss_fn, optax.adam(1e-2), mesh, donate=False)
    jp = replicate(mlp_tree, mesh)
    js = replicate(optax.adam(1e-2).init(mlp_tree), mesh)
    losses = []
    for bx_, by_ in mlp_batches:
        jp, js, loss = step(jp, js, shard_batch(jnp.asarray(bx_), mesh),
                            shard_batch(jnp.asarray(by_), mesh))
        losses.append(float(loss))
    return {"ranks": ranks, "bn": bn, "jax_losses": losses,
            "jax_params": numpy_tree(jp)}


def test_mlp_trains_data_parallel_on_two_ranks(two_ranks):
    ref = two_ranks["jax_losses"]
    for r in two_ranks["ranks"]:
        np.testing.assert_allclose(r["mlp_losses"], ref, rtol=1e-4,
                                   atol=1e-6)
        want = TL.state_from_jax(two_ranks["jax_params"])
        for name, a in r["mlp_params"].items():
            np.testing.assert_allclose(a, want[name], rtol=1e-4, atol=1e-4,
                                       err_msg=name)
    assert ref[-1] < ref[0] * 0.5, ref[::10]
    a, b = (r["mlp_params"] for r in two_ranks["ranks"])
    assert all(np.array_equal(a[k], b[k]) for k in a)


def test_sync_bn_statistics_are_the_global_batch(two_ranks):
    bn, ranks = two_ranks["bn"], two_ranks["ranks"]
    x64 = bn["x"].astype(np.float64)
    mean = x64.mean((0, 2, 3))
    var = x64.var((0, 2, 3))
    for r in ranks:
        np.testing.assert_allclose(r["bn"]["mean"], 0.1 * mean, rtol=1e-5)
        np.testing.assert_allclose(r["bn"]["var"], 0.9 + 0.1 * var,
                                   rtol=1e-5)
    # one process over the whole batch: the same output and gradients
    x = torch.from_numpy(bn["x"]).requires_grad_()
    layer = TL.BatchNorm(5, "cpu")
    TL.load_state(layer, bn["params"])
    y = layer(x, training=True)
    (y * torch.from_numpy(bn["w"])).sum().backward()
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        np.concatenate([r["bn"]["y"] for r in ranks]), y.detach().numpy(),
        **tol)
    np.testing.assert_allclose(
        np.concatenate([r["bn"]["dx"] for r in ranks]), x.grad.numpy(),
        **tol)
    # every rank's parameter gradient is its share; their sum the whole's
    np.testing.assert_allclose(sum(r["bn"]["dscale"] for r in ranks),
                               layer.scale.grad.numpy(), **tol)
    np.testing.assert_allclose(sum(r["bn"]["dbias"] for r in ranks),
                               layer.bias.grad.numpy(), **tol)


def test_jax_sync_bn_variance_falls_short_by_the_ranks_means(two_ranks):
    """The reference's pmean of local variances: global variance less the
    variance of the ranks' means (a fault the port does not copy)."""
    bn = two_ranks["bn"]
    halves = bn["x"].transpose(0, 2, 3, 1).reshape(2, 4, 4, 4, 5)
    p = {k: jnp.asarray(v) for k, v in bn["params"].items()}
    _, new = jax.vmap(lambda xs: JL.batchnorm(p, xs, True, axis_name="r"),
                      axis_name="r")(jnp.asarray(halves))
    x64 = bn["x"].astype(np.float64)
    local_means = x64.reshape(2, 4, 5, 4, 4).mean((1, 3, 4))
    short = x64.var((0, 2, 3)) - local_means.var(0)
    np.testing.assert_allclose(np.asarray(new["var"][0]), 0.9 + 0.1 * short,
                               rtol=1e-5)
    port_var = two_ranks["ranks"][0]["bn"]["var"]
    gap = (port_var - np.asarray(new["var"][0])) / 0.1
    np.testing.assert_allclose(gap, local_means.var(0), rtol=1e-4)
    assert local_means.var(0).min() > 1.0
