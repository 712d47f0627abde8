"""Expert parallelism (``horovod_tpu_torch/parallel/expert.py``) and the MoE
Llama (``models/moe_llama.py``) against the JAX package.

In this process: ``_route_topk`` at k = 1 and 2 (dispatch, combine and
aux; capacity drops; ties) against the JAX router, the dense MoE Llama
(``tiny`` and ``mixtral-tiny``: logits, loss and every gradient) against
``moe_llama.apply``/``loss_fn`` and ``jax.grad``, and ``param_count``.

One spawned run of four gloo ranks (``torch_port_expert_worker.py``)
against ``make_moe_fn`` under ``shard_map`` on four CPU devices:
tests/test_expert.py's Switch, capacity-drop and top-2 cases (outputs,
aux, and the gradients of each rank's share of ``mean((y - tgt)^2) +
0.01 aux``, the router's summed over the ranks), the MoE Llama's
expert-parallel path against the JAX expert-parallel path and the dense
one (logits, the ranks' summed loss, and every gradient), and the
rejection of experts that do not divide over the ranks.

Tolerances are tests/test_expert.py's: the MoE layer rtol 2e-4, atol
2e-5, its aux rtol 1e-5; the Llama's logits, losses and every gradient
rtol 5e-4, atol 5e-5; the router's tensors atol 1e-6."""

import dataclasses
import os
import socket
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as tmp
from jax.sharding import Mesh

from horovod_tpu.models import moe_llama as JM
from horovod_tpu.parallel import expert as JX
from horovod_tpu_torch.models import moe_llama as M
from horovod_tpu_torch.parallel import expert as X

import torch_port_expert_worker as W

MOE = dict(rtol=2e-4, atol=2e-5)
LLAMA = dict(rtol=5e-4, atol=5e-5)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _moe_params(name):
    _, E, D, H, _, _, _, seed = next(c for c in W.MOE_CASES if c[0] == name)
    return JX.init_moe_params(jax.random.PRNGKey(seed), D, H, E)


def _llama_params(cfg_name, seed):
    return JM.init(jax.random.PRNGKey(seed), JM.CONFIGS[cfg_name])


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out_dir = str(tmp_path_factory.mktemp("expert"))
    trees = {c[0]: _np_tree(_moe_params(c[0])) for c in W.MOE_CASES}
    for n, s in (("tiny", 1), ("mixtral-tiny", 2)):
        trees[f"llama {n}"] = _np_tree(_llama_params(n, s))
    np.save(os.path.join(out_dir, "trees.npy"), trees, allow_pickle=True)
    ctx = tmp.spawn(W.run, args=(_free_port(), out_dir), nprocs=W.SIZE,
                    join=False)
    deadline = time.monotonic() + 120
    while not ctx.join(timeout=2):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.terminate()
            pytest.fail("gloo ranks did not finish in 120 s")
    return [np.load(os.path.join(out_dir, f"rank{r}.npy"),
                    allow_pickle=True).item() for r in range(W.SIZE)]


def _mesh():
    return Mesh(np.array(jax.devices()[:W.SIZE]), ("ep",))


# --------------------------------------------------------------- router
ROUTES = [(1, 16, 8, 4, 3.0), (2, 16, 8, 4, 3.0), (1, 32, 4, 0, 0.5),
          (2, 32, 4, 0, 0.5)]


@pytest.mark.parametrize("k,T,E,ties,cf", ROUTES)
def test_route_topk_matches_jax(k, T, E, ties, cf):
    """Dispatch, combine and aux; with ``ties`` rows whose logits are all
    equal (lax.top_k takes the lowest index), and with cf 0.5 capacity
    drops."""
    logits = np.random.RandomState(T + k).randn(T, E).astype(np.float32)
    logits[:ties] = 0.25
    capacity = int(np.ceil(T * k * cf / E))
    want = JX._route_topk(jnp.asarray(logits), capacity, k=k)
    got = X._route_topk(torch.from_numpy(logits), capacity, k=k)
    for name, a, b in zip(("dispatch", "combine", "aux"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6,
                                   err_msg=name)
    if cf < 1:
        assert got[0].sum() < T * k  # some choices were dropped


# ------------------------------------------------------------ MoE Llama
def _torch_name(path):
    """A JAX tree path of moe_llama as the port's parameter name."""
    keys = [getattr(p, "key", getattr(p, "idx", None)) for p in path]
    if keys[0] == "layers":
        i, *rest = keys[1:]
        if rest[0] == "moe":
            return f"layers.{i}.moe.{rest[1]}", False
        return f"layers.{i}.{rest[0]}." + (
            "weight" if rest[1] == "kernel" else rest[1]), rest[1] == "kernel"
    if keys[0] == "lm_head":
        return "lm_head.weight", True
    return ".".join(str(k) for k in keys), False


def _check_grads(got, jax_grads, experts=None, **tol):
    """``got``: the port's gradients by name; ``experts``: the rank's slice
    of the expert dim when the port holds a share."""
    for path, want in jax.tree_util.tree_flatten_with_path(jax_grads)[0]:
        name, transpose = _torch_name(path)
        want = np.asarray(want)
        if transpose:
            want = want.T
        if experts is not None and name.endswith(("moe.wi", "moe.wo")):
            want = want[experts]
        np.testing.assert_allclose(got[name], want, err_msg=name, **tol)


@pytest.mark.parametrize("cfg_name,seed", [("tiny", 1), ("mixtral-tiny", 2)])
def test_moe_llama_dense_matches_jax(cfg_name, seed):
    cfg = JM.CONFIGS[cfg_name]
    params = _llama_params(cfg_name, seed)
    ids = W.llama_ids(cfg.vocab, seed)
    model = M.moe_llama_params_from_jax(_np_tree(params),
                                        M.CONFIGS[cfg_name], "cpu")
    tids = torch.from_numpy(ids)
    logits, aux = model(tids[:, :-1])
    jl, jaux = jax.jit(lambda p: JM.apply(
        p, jnp.asarray(ids[:, :-1], jnp.int32), cfg))(params)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jl),
                               **LLAMA)
    np.testing.assert_allclose(aux.item(), float(jaux), **LLAMA)
    loss = M.loss_fn(model, tids)
    loss.backward()
    jloss, g = jax.jit(jax.value_and_grad(lambda p: JM.loss_fn(
        p, jnp.asarray(ids, jnp.int32), cfg)))(params)
    np.testing.assert_allclose(loss.item(), float(jloss), **LLAMA)
    _check_grads({n: p.grad.numpy() for n, p in model.named_parameters()},
                 g, **LLAMA)


@pytest.mark.parametrize("cfg_name", ["tiny", "mini", "mixtral-tiny"])
def test_moe_llama_param_count(cfg_name):
    cfg = M.CONFIGS[cfg_name]
    model = M.MoeLlama(cfg, "meta")
    n = sum(p.numel() for p in model.parameters())
    assert n == M.param_count(cfg) == JM.param_count(JM.CONFIGS[cfg_name])
    assert M.CONFIGS[cfg_name].experts_per_token == \
        JM.CONFIGS[cfg_name].experts_per_token


# --------------------------------------------------------- four ranks
def test_no_case_raised(ranks):
    for r in ranks:
        crashed = {n: v for n, v in r.items() if n.startswith("_")}
        assert not crashed, crashed


@pytest.mark.parametrize("case", W.MOE_CASES, ids=[c[0] for c in W.MOE_CASES])
def test_moe_fn_matches_jax(ranks, case):
    name, E, _, _, T, cf, k, _ = case
    params = _moe_params(name)
    x, tgt = map(jnp.asarray, W.moe_inputs(name))
    fn = JX.make_moe_fn(_mesh(), n_experts=E, capacity_factor=cf,
                        experts_per_token=k)
    y, aux = jax.jit(fn)(params, x)
    got = np.concatenate([r[name]["y"] for r in ranks])
    np.testing.assert_allclose(got, np.asarray(y), **MOE)
    for r in ranks:
        np.testing.assert_allclose(r[name]["aux"], float(aux), rtol=1e-5)
    if name == "drops":  # dropped tokens are exactly zero, never misrouted
        dropped = np.all(got == 0.0, axis=-1)
        assert dropped.any() and not dropped.all()

    def loss(p):
        y, aux = fn(p, x)
        return jnp.mean((y - tgt) ** 2) + W.AUX_COEF * aux
    g = jax.jit(jax.grad(loss))(params)
    e_local = E // W.SIZE
    for i, r in enumerate(ranks):
        grads = r[name]["grads"]
        np.testing.assert_allclose(grads["router"], np.asarray(g["router"]),
                                   err_msg=f"router rank {i}", **LLAMA)
        for leaf in ("wi", "wo"):
            np.testing.assert_allclose(
                grads[leaf], np.asarray(g[leaf])[i * e_local:
                                                 (i + 1) * e_local],
                err_msg=f"{leaf} rank {i}", **LLAMA)


@pytest.mark.parametrize("cfg_name,seed", [("tiny", 1), ("mixtral-tiny", 2)])
def test_moe_llama_ep_matches_jax_ep_and_dense(ranks, cfg_name, seed):
    cfg = dataclasses.replace(JM.CONFIGS[cfg_name],
                              capacity_factor=W.LLAMA_CF)
    params = _llama_params(cfg_name, seed)
    ids = jnp.asarray(W.llama_ids(cfg.vocab, seed), jnp.int32)
    fn = JX.make_moe_fn(_mesh(), n_experts=cfg.n_experts,
                        capacity_factor=W.LLAMA_CF,
                        experts_per_token=cfg.experts_per_token)
    name = f"llama {cfg_name}"
    got = np.concatenate([r[name]["logits"] for r in ranks])
    for moe_fn in (fn, None):
        want, _ = jax.jit(lambda p: JM.apply(p, ids[:, :-1], cfg,
                                             moe_fn=moe_fn))(params)
        np.testing.assert_allclose(got, np.asarray(want), **LLAMA)
    jloss, g = jax.jit(jax.value_and_grad(lambda p: JM.loss_fn(
        p, ids, cfg, moe_fn=fn)))(params)
    np.testing.assert_allclose(sum(r[name]["loss"] for r in ranks),
                               float(jloss), **LLAMA)
    e_local = cfg.n_experts // W.SIZE
    for i, r in enumerate(ranks):
        _check_grads(r[name]["grads"], g,
                     experts=slice(i * e_local, (i + 1) * e_local), **LLAMA)


def test_moe_rejects_indivisible_experts(ranks):
    for r in ranks:
        assert "not divisible" in r["indivisible"]
