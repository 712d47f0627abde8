"""The eager API against the JAX package's torch frontend on the same
numpy-seeded inputs, in one process: the hook-driven DistributedOptimizer,
SyncBatchNorm, the eager ops' single-rank semantics, and the data-parallel
steps ``make_microbatched_train_step`` with ``cast_params`` (fp32 master
weights, bf16 compute) and ``make_scanned_train_step`` against theirs.

The port runs with ``HOROVOD_CONTROLLER=tcp`` on a free port, so every op
goes through its native controller.  The JAX frontend works per chip
(eight CPU chips here, each holding the process's tensor); with ``Average``
that is the per-process value, which is what these tests compare."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

import horovod_tpu
import horovod_tpu.torch as JT
from horovod_tpu.models import llama as JL
from horovod_tpu.optimizer import distributed_optimizer
from horovod_tpu.parallel import data_parallel as JDP

import horovod_tpu_torch as hvd
import horovod_tpu_torch.torch as TT
from horovod_tpu_torch.models import llama as TL
from horovod_tpu_torch.torch import mpi_ops
from torch_port_ports import hold_ports

# AdamW's eps 1e-3 keeps updates of near-zero gradient entries well
# conditioned (see test_torch_data_parallel.py); the reference's own
# tolerance for one- and two-rank steps is 1e-5.
OPT_KW = dict(lr=1e-2, betas=(0.9, 0.999), eps=1e-3, weight_decay=0.01)
RTOL = ATOL = 1e-5


def _free_port() -> int:
    """A port below the ephemeral range, free when taken (``hold_ports``)."""
    return hold_ports(1).release()[0]


@pytest.fixture(scope="module")
def runtimes():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    horovod_tpu.init()
    old = {k: os.environ.get(k) for k in ("HOROVOD_CONTROLLER",
                                          "HOROVOD_CONTROLLER_PORT")}
    os.environ["HOROVOD_CONTROLLER"] = "tcp"
    os.environ["HOROVOD_CONTROLLER_PORT"] = str(_free_port())
    try:
        rt = hvd.init(device="cpu")
        assert rt.ensure_core() is not None
        yield rt
    finally:
        hvd.shutdown()
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        # later files in this process (one xdist worker runs many) keep
        # their thread count
        torch.set_num_threads(threads)


# --------------------------------------------------- hook-driven optimizer
def _mlp():
    torch.manual_seed(0)
    return torch.nn.Sequential(
        torch.nn.Linear(6, 16), torch.nn.Tanh(), torch.nn.Linear(16, 16),
        torch.nn.Tanh(), torch.nn.Linear(16, 3))


def _train(api, kw, passes, compression=None):
    model = _mlp()
    params = list(model.parameters())
    if kw.get("groups") == "partial":
        kw = dict(kw, groups=[[params[0], params[1]], [params[4]]])
    extra = {} if compression is None else {
        "compression": getattr(api.Compression, compression)}
    opt = api.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), **OPT_KW),
        named_parameters=model.named_parameters(),
        backward_passes_per_step=passes, **kw, **extra)
    rng = np.random.RandomState(4)
    for _ in range(3):
        opt.zero_grad()
        for _ in range(passes):
            x = torch.from_numpy(rng.randn(8, 6).astype(np.float32))
            y = torch.from_numpy(rng.randn(8, 3).astype(np.float32))
            ((model(x) - y) ** 2).mean().backward()
        opt.step()
    return [p.detach().clone() for p in model.parameters()]


@pytest.mark.parametrize("kw,passes", [
    ({}, 1), ({}, 2), ({"bucket_bytes": 0}, 1), ({"bucket_bytes": 0}, 2),
    ({"groups": "partial"}, 1), ({"num_groups": 2}, 2),
    ({"bucket_bytes": 300}, 1)],
    ids=["buckets", "buckets-passes2", "per-param", "per-param-passes2",
         "groups", "num_groups-passes2", "bucket_bytes=300"])
def test_hook_optimizer_matches_jax_torch_frontend(runtimes, kw, passes):
    before = mpi_ops.stats()["responses"]
    got = _train(TT, dict(kw), passes)
    ref = _train(JT, dict(kw), passes)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=RTOL,
                                   atol=ATOL)
    assert mpi_ops.stats()["responses"] > before  # negotiated


def test_hook_optimizer_with_fp16_compression(runtimes):
    got = _train(TT, {}, 1, compression="fp16")
    ref = _train(JT, {}, 1, compression="fp16")
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=1e-3,
                                   atol=1e-4)


def test_dropped_hook_optimizer_frees_its_model(runtimes):
    """The gradient hooks live on the parameters, out of the collector's
    sight, so a cycle through them is never collected: a dropped
    optimizer's parameters must go."""
    import gc
    import weakref
    model = _mlp()
    opt = TT.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), **OPT_KW),
        named_parameters=model.named_parameters())
    ((model(torch.ones(2, 6)) - 1) ** 2).mean().backward()
    opt.step()
    refs = [weakref.ref(p) for p in model.parameters()]
    del model, opt
    gc.collect()
    assert all(r() is None for r in refs)


def test_hook_optimizer_refusals(runtimes):
    model = _mlp()
    named = list(model.named_parameters())
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    # Adasum is no refusal: it gives the delta optimizer, with no hooks
    delta = TT.DistributedOptimizer(opt, op=hvd.Adasum)
    assert isinstance(delta, torch.optim.SGD)
    assert not hasattr(delta, "_hook_handles")
    with pytest.raises(ValueError, match="duplicate"):
        TT.DistributedOptimizer(opt, named_parameters=named[:1] + named)
    with pytest.raises(ValueError, match="not named"):
        TT.DistributedOptimizer(opt, named_parameters=named[:2])
    with pytest.raises(ValueError, match="op=Average"):
        TT.DistributedOptimizer(opt, op=hvd.Sum, gradient_predivide_factor=2)
    dopt = TT.DistributedOptimizer(opt, named_parameters=named,
                                   bucket_bytes=0)
    model(torch.ones(2, 6)).sum().backward()
    with pytest.raises(AssertionError, match="in flight"):
        dopt.zero_grad()
    dopt.step()
    dopt.zero_grad()
    assert isinstance(dopt, torch.optim.SGD)


# ------------------------------------------------------------ eager ops
def test_eager_ops_single_rank(runtimes):
    x = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    for op in (hvd.Average, hvd.Sum, hvd.Min, hvd.Max, hvd.Product):
        torch.testing.assert_close(TT.allreduce(x, op=op), x)
    torch.testing.assert_close(
        TT.allreduce(x, op=hvd.Sum, prescale_factor=2.0,
                     postscale_factor=0.25), x * 0.5)
    y = x.clone()
    h = TT.allreduce_async_(y, op=hvd.Sum, prescale_factor=3.0)
    assert TT.synchronize(h) is y
    torch.testing.assert_close(y, 3 * x)
    outs = TT.grouped_allreduce([x, x.to(torch.bfloat16)])
    assert outs[1].dtype == torch.bfloat16
    torch.testing.assert_close(TT.allgather(x), x)
    torch.testing.assert_close(TT.broadcast(x, 0), x)
    out, recv = TT.alltoall(x, torch.tensor([3]))
    torch.testing.assert_close(out, x)
    assert recv.tolist() == [3]
    torch.testing.assert_close(TT.reducescatter(x), x)
    assert TT.broadcast_object({"k": [1]}) == {"k": [1]}
    assert TT.allgather_object("me") == ["me"]
    TT.barrier()
    assert TT.join() == 0
    h = TT.allreduce_async(x)
    assert TT.poll(h) in (True, False)
    TT.synchronize(h)
    with pytest.raises(ValueError, match="unknown handle"):
        TT.synchronize(h)


def test_fused_response_packs_one_collective_per_dtype_and_op(runtimes):
    """Async submissions of one kind fuse into one response; its tensors
    are packed into one collective per (reduce op, dtype)."""
    s0 = mpi_ops.stats()
    hs = [TT.allreduce_async(torch.full((4,), float(i)), name=f"fuse.{i}")
          for i in range(6)]
    hs.append(TT.allreduce_async(torch.ones(3, dtype=torch.float64),
                                 name="fuse.f64"))
    outs = [TT.synchronize(h) for h in hs]
    s1 = mpi_ops.stats()
    assert [float(o[0]) for o in outs] == [0, 1, 2, 3, 4, 5, 1]
    names = s1["names"] - s0["names"]
    assert names == 7
    assert s1["responses"] - s0["responses"] < names
    assert s1["collectives"] - s0["collectives"] < names


def test_autograd_functions_single_rank(runtimes):
    w = torch.ones(3, requires_grad=True)
    (TT.allreduce(w * 2, op=hvd.Sum) * torch.arange(3.0)).sum().backward()
    torch.testing.assert_close(w.grad, 2 * torch.arange(3.0))
    w = torch.ones(2, requires_grad=True)
    TT.broadcast(w * 3, 0).sum().backward()
    torch.testing.assert_close(w.grad, torch.full((2,), 3.0))
    w = torch.ones(4, 1, requires_grad=True)
    out, _ = TT.alltoall(w * 5, torch.tensor([4]))
    out.sum().backward()
    torch.testing.assert_close(w.grad, torch.full((4, 1), 5.0))


# ------------------------------------------------------------ SyncBatchNorm
def test_sync_batch_norm_matches_jax(runtimes):
    rng = np.random.RandomState(5)
    x = rng.randn(6, 3, 4).astype(np.float32)
    w = rng.randn(6, 3, 4).astype(np.float32)
    res = {}
    for label, api in (("port", TT), ("jax", JT)):
        bn = api.SyncBatchNorm(3)
        xt = torch.from_numpy(x.copy()).requires_grad_()
        out = bn(xt)
        (out * torch.from_numpy(w)).sum().backward()
        res[label] = (out.detach(), xt.grad, bn.weight.grad, bn.bias.grad,
                      bn.running_mean.clone(), bn.running_var.clone())
    for g, r in zip(res["port"][:5], res["jax"][:5]):
        torch.testing.assert_close(g, r, rtol=RTOL, atol=ATOL)
    # running_var's unbiased factor n/(n-1) counts the global batch: one
    # process's 24 samples here, while the JAX frontend counts each of its
    # chips as a worker holding the same 24
    n, chips = 6 * 4, JT.size()
    factor = (n / (n - 1)) / (chips * n / (chips * n - 1))
    var_p, var_j = res["port"][5], res["jax"][5]
    torch.testing.assert_close(var_p - 0.9, (var_j - 0.9) * factor,
                               rtol=RTOL, atol=ATOL)


# --------------------------------------------- data-parallel step builders
def test_cast_params_matches_jax():
    tree = {"a": np.ones((2, 2), np.float32), "n": np.arange(3),
            "sub": [np.full(2, 0.5, np.float32)]}
    ref = JDP.cast_params(jax.tree_util.tree_map(jnp.asarray, tree),
                          jnp.bfloat16)
    got = hvd.cast_params({"a": torch.ones(2, 2), "n": torch.arange(3),
                           "sub": [torch.full((2,), 0.5)]}, torch.bfloat16)
    assert got["a"].dtype == torch.bfloat16 and ref["a"].dtype == jnp.bfloat16
    assert got["n"].dtype == torch.int64 and ref["n"].dtype != jnp.bfloat16
    assert got["sub"][0].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["sub"][0].float().numpy(),
                                  np.asarray(ref["sub"][0], np.float32))


def _jax_to_torch_model(params, name):
    """The port's model of config ``name`` on JAX ``params`` whose values
    the config's dtype holds exactly, with fp32 parameters (master
    weights; the config keeps the activations' dtype)."""
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), params)
    return TL.params_from_jax(tree, TL.CONFIGS[name], device="cpu").float()


def _torch_names(jparams, name):
    """JAX fp32 parameters under the port's names and layout."""
    cfg = dataclasses.replace(TL.CONFIGS[name], dtype=torch.float32)
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                  jparams)
    return {n: p.detach() for n, p in
            TL.params_from_jax(tree, cfg, device="cpu").named_parameters()}


def test_microbatched_step_with_bf16_compute_matches_jax(runtimes):
    """One update over k=2 microbatches, fp32 master weights, bf16 compute,
    against the JAX package's scanned step on a one-device mesh.  SGD, so
    the update is the mean gradient.  Measured on this input: the JAX
    step's own bf16 update is 2.2% (norm, worst parameter) from its fp32
    one, and the two frameworks' fp32 updates 0.8% apart, so each
    parameter's update is held to 5e-2 and the loss to 1e-3 relative."""
    cfg = JL.CONFIGS["mini"]
    key_params = JDP.cast_params(JL.init(jax.random.PRNGKey(0), cfg),
                                 jnp.float32)
    k, lr = 2, 0.5
    rng = np.random.RandomState(6)
    batch = rng.randint(0, cfg.vocab, (k, 2, 33)).astype(np.int32)

    mesh = Mesh(np.array(jax.devices()[:1]), ("hvd",))
    jstep = JDP.make_microbatched_train_step(
        lambda p, ids: JL.loss_fn(p, ids, cfg), optax.sgd(lr), mesh,
        backward_passes_per_step=k, compute_dtype=jnp.bfloat16, donate=False)
    jopt = distributed_optimizer(optax.sgd(lr), axis_name="hvd",
                                 backward_passes_per_step=k)
    jp, _, jloss = jstep(key_params, jopt.init(key_params), jnp.asarray(batch))

    model = _jax_to_torch_model(key_params, "mini")
    p0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt = hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(), lr=lr),
                                   backward_passes_per_step=k)
    seen = []

    def loss_fn(m, ids):
        seen.append(m.embed.table.dtype)
        return TL.loss_fn(m, ids)
    step = hvd.make_microbatched_train_step(
        model, loss_fn, opt, k, compute_dtype=torch.bfloat16)
    loss = step(torch.from_numpy(batch))
    assert seen == [torch.bfloat16] * k  # the forward ran on a bf16 copy
    assert all(p.dtype == torch.float32 for p in model.parameters())
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-3)

    ref = _torch_names(jp, "mini")
    for name, p in model.named_parameters():
        d_got, d_ref = p.detach() - p0[name], ref[name] - p0[name]
        rel = float((d_got - d_ref).norm() / d_ref.norm().clamp_min(1e-12))
        assert rel < 5e-2, (name, rel)


def test_scanned_step_matches_jax(runtimes):
    cfg = JL.CONFIGS["tiny"]
    params = JL.init(jax.random.PRNGKey(1), cfg)
    rng = np.random.RandomState(7)
    batches = rng.randint(0, cfg.vocab, (2, 4, 17)).astype(np.int32)
    mesh = Mesh(np.array(jax.devices()[:1]), ("hvd",))
    jopt = optax.adamw(OPT_KW["lr"], b1=0.9, b2=0.999, eps=OPT_KW["eps"],
                       weight_decay=OPT_KW["weight_decay"])
    run = JDP.make_scanned_train_step(lambda p, ids: JL.loss_fn(p, ids, cfg),
                                      jopt, mesh, donate=False)
    jp, _, jlosses = run(params, jopt.init(params), jnp.asarray(batches))

    model = _jax_to_torch_model(params, "tiny")
    opt = hvd.DistributedOptimizer(torch.optim.AdamW(model.parameters(),
                                                     **OPT_KW))
    losses = hvd.make_scanned_train_step(model, TL.loss_fn, opt)(
        torch.from_numpy(batches))
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses),
                               rtol=RTOL, atol=ATOL)
    ref = _torch_names(jp, "tiny")
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(),
                                   rtol=RTOL,
                                   atol=ATOL, err_msg=name)


def test_surface_has_the_jax_frontends_names():
    """Every name of ``horovod_tpu.torch.__all__``, ``elastic`` included,
    is on the port's eager API."""
    missing = set(JT.__all__) - set(TT.__all__)
    assert not missing, sorted(missing)
    assert all(hasattr(TT, n) for n in TT.__all__)
