"""The GPipe schedule (``horovod_tpu_torch/parallel/pipeline.py``) on gloo
ranks against the JAX package's ``make_pipeline_fn`` and
``make_pipelined_llama`` on as many CPU devices.

One spawned run of four ranks (``torch_port_pipeline_worker.py``) drives
four stages over the world and two stages over each of the groups [0, 1]
and [2, 3]: tests/test_pipeline.py's tanh stages (forward and gradients at
``n_micro=4``, the forward at 1, 2, 3, 4, 6 and 12 microbatches, and the
indivisible batch), and the ``tiny`` Llama with 4 and 2 layers through
``make_pipelined_llama`` (logits and every stage's gradients of a squared
error, the JAX weights carried over with ``params_from_jax``).  Each
rank's stage gradients meet the JAX gradients' slice of that stage.

Tolerances are tests/test_pipeline.py's: forward rtol 2e-5, atol 2e-6;
gradients rtol 5e-5, atol 1e-5; the Llama's logits rtol 2e-4, atol 2e-5
and its gradients rtol 5e-4, atol 1e-5."""

import dataclasses
import os
import socket
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch.multiprocessing as tmp
from jax.sharding import Mesh

from horovod_tpu.models import llama as JL
from horovod_tpu.parallel import pipeline as JP
from horovod_tpu_torch.parallel.pipeline import pipeline_bubble_fraction

import torch_port_pipeline_worker as W

FWD = dict(rtol=2e-5, atol=2e-6)
GRAD = dict(rtol=5e-5, atol=1e-5)
LLAMA_FWD = dict(rtol=2e-4, atol=2e-5)
LLAMA_GRAD = dict(rtol=5e-4, atol=1e-5)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _llama_cfg(n_layers):
    return dataclasses.replace(JL.CONFIGS["tiny"], n_layers=n_layers)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out_dir = str(tmp_path_factory.mktemp("pipeline"))
    for n in (2, 4):
        tree = jax.tree_util.tree_map(
            np.asarray, JL.init(jax.random.PRNGKey(0), _llama_cfg(n)))
        np.save(os.path.join(out_dir, f"llama{n}.npy"), tree,
                allow_pickle=True)
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


def _mesh(S):
    return Mesh(np.array(jax.devices()[:S]), ("pp",))


def _stage_fn(p, x):
    return jnp.tanh(x @ p["w"] + p["b"])


def _stage_ranks(S):
    """(rank, stage) pairs of the S-stage pipelines of the run."""
    return [(r, r % S) for r in range(W.SIZE)]


def test_no_case_raised(ranks):
    for r in ranks:
        crashed = {n: v for n, v in r.items() if n.startswith("_")}
        assert not crashed, crashed


@pytest.mark.parametrize("S", [4, 2])
def test_pipeline_forward_and_gradients_match_jax(ranks, S):
    stages, x, y, x12 = W.stage_inputs(S)
    stacked = JP.stack_stage_params(
        [{k: jnp.asarray(v) for k, v in s.items()} for s in stages])
    fn = JP.make_pipeline_fn(_stage_fn, _mesh(S), n_micro=4)
    out = np.asarray(jax.jit(fn)(stacked, jnp.asarray(x)))
    grads = jax.jit(jax.grad(lambda p: jnp.mean(
        (fn(p, jnp.asarray(x)) - jnp.asarray(y)) ** 2)))(stacked)
    micro = [np.asarray(jax.jit(JP.make_pipeline_fn(
        _stage_fn, _mesh(S), n_micro=m))(stacked, jnp.asarray(x12)))
        for m in W.MICRO]
    for r, stage in _stage_ranks(S):
        got = ranks[r][f"tanh S={S}"]
        assert got["n_stages"] == S
        np.testing.assert_allclose(got["out"], out, err_msg=f"rank {r}",
                                   **FWD)
        for k in ("w", "b"):
            np.testing.assert_allclose(got["grads"][k],
                                       np.asarray(grads[k][stage]),
                                       err_msg=f"rank {r} grad {k}", **GRAD)
        for m, a, b in zip(W.MICRO, got["micro"], micro):
            np.testing.assert_allclose(a, b, err_msg=f"rank {r} n_micro={m}",
                                       **FWD)


@pytest.mark.parametrize("S", [4, 2])
def test_pipeline_rejects_indivisible_batch(ranks, S):
    for r, _ in _stage_ranks(S):
        assert "not divisible" in ranks[r][f"tanh S={S}"]["indivisible"]


@pytest.mark.parametrize("S", [4, 2])
def test_pipelined_llama_matches_jax(ranks, S):
    cfg = _llama_cfg(S)
    params = JL.init(jax.random.PRNGKey(0), cfg)
    ids, tgt = W.llama_inputs(cfg.vocab, cfg.n_layers)
    apply_fn, restack = JP.make_pipelined_llama(cfg, _mesh(S), n_micro=2)
    pp = restack(params)
    ids32 = jnp.asarray(ids.astype(np.int32))
    logits = np.asarray(jax.jit(apply_fn)(pp, ids32))
    g = jax.jit(jax.grad(lambda q: jnp.mean(
        (apply_fn({**pp, "stages": q}, ids32) - jnp.asarray(tgt)) ** 2)))(
        pp["stages"])
    per = cfg.n_layers // S
    for r, stage in _stage_ranks(S):
        got = ranks[r][f"llama S={S}"]
        np.testing.assert_allclose(got["logits"], logits,
                                   err_msg=f"rank {r}", **LLAMA_FWD)
        assert got["first_layer"] == stage * per
        for n, a in got["grads"].items():
            _, layer, name, leaf = n.split(".")
            key = "kernel" if leaf == "weight" else leaf
            want = np.asarray(g[name][key][stage, int(layer)])
            if key == "kernel":
                want = want.T
            np.testing.assert_allclose(a, want, err_msg=f"rank {r} {n}",
                                       **LLAMA_GRAD)
        assert "not divisible" in got["bad_layering"]


def test_bubble_fraction():
    for S, M in ((4, 1), (4, 13), (1, 8), (2, 4)):
        assert pipeline_bubble_fraction(S, M) == pytest.approx(
            JP.pipeline_bubble_fraction(S, M))
    assert pipeline_bubble_fraction(4, 1) == pytest.approx(3 / 4)
    assert pipeline_bubble_fraction(1, 8) == 0.0
