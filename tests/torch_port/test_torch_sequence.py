"""Sequence parallelism (``horovod_tpu_torch/parallel/sequence.py``) on four
gloo ranks against the JAX package's ring and Ulysses attention on four
CPU devices, and against full attention.

One spawned run (``torch_port_sequence_worker.py``): the plain ring
(causal and not, GQA, and tests/test_sequence_parallel.py's 64-position
case), the flash ring through the flash-attention passes (on the CPU their
plain versions; forward and the gradients of ``sum(out ** 2)`` with Hkv 8
and 4, over the world and over the pairs {0, 1} and {2, 3}, against JAX's
``kernel="flash"`` ring under ``shard_map`` in interpret mode; rank r
calls each pass for r + 1 blocks), the rejection of a non-causal flash
ring, Ulysses (causal and not, and its gradients), and the ``tiny`` Llama
sequence-sharded through the flash ring with RoPE at each shard's offset
against the unsharded JAX forward, plus each rank's share of the loss and
its gradients summed over the ranks against ``jax.grad`` of the JAX
long-context example's global loss.

Tolerances are tests/test_sequence_parallel.py's: outputs atol 2e-4, rtol
1e-3; gradients atol 5e-4, rtol 2e-3."""

import dataclasses
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch.multiprocessing as tmp
from jax.sharding import Mesh, PartitionSpec as P

from horovod_tpu.models import layers as JL
from horovod_tpu.models import llama as JLL
from horovod_tpu.ops._compat import shard_map
from horovod_tpu.parallel.sequence import ring_attention, ulysses_attention

import torch_port_sequence_worker as W
from torch_port_ports import hold_ports

OUT = dict(atol=2e-4, rtol=1e-3)
GRAD = dict(atol=5e-4, rtol=2e-3)


def _free_port() -> int:
    """A port below the ephemeral range, free when taken (``hold_ports``)."""
    return hold_ports(1).release()[0]


def _llama_cfg():
    return dataclasses.replace(JLL.CONFIGS["tiny"], max_seq=128)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out_dir = str(tmp_path_factory.mktemp("sequence"))
    tree = jax.tree_util.tree_map(
        np.asarray, JLL.init(jax.random.PRNGKey(0), _llama_cfg()))
    np.save(os.path.join(out_dir, "llama.npy"), tree, allow_pickle=True)
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


def _mesh(n):
    return Mesh(np.array(jax.devices()[:n]), ("sp",))


def _sharded(fn, n):
    return shard_map(fn, mesh=_mesh(n), in_specs=(P(None, "sp"),) * 3,
                     out_specs=P(None, "sp"), check_vma=False)


def _gathered(ranks, name, key="out", n=W.SIZE, members=None):
    """The ranks' shards of ``out[name][key]`` concatenated along the
    sequence (``members``: the ranks of one group, in its order)."""
    members = members or list(range(n))
    return np.concatenate([ranks[r][name][key] for r in members], axis=1)


def _gathered_grads(ranks, name, members):
    return [np.concatenate([ranks[r][name]["grads"][i] for r in members],
                           axis=1) for i in range(3)]


def _jax_grads(fn, q, k, v):
    return jax.grad(lambda q, k, v: jnp.sum(fn(q, k, v) ** 2),
                    argnums=(0, 1, 2))(q, k, v)


def test_no_case_raised(ranks):
    for r in ranks:
        crashed = {n: v for n, v in r.items() if n.startswith("_")}
        assert not crashed, crashed


@pytest.mark.parametrize("name,causal,hkv,seed,shape", [
    ("ring causal", True, None, 0, {}),
    ("ring non-causal", False, None, 0, {}),
    ("ring gqa", True, 4, 0, {}),
    ("ring long", True, None, 3, dict(B=1, S=64, H=4, D=8)),
])
def test_plain_ring_matches_jax_and_full(ranks, name, causal, hkv, seed,
                                         shape):
    q, k, v = map(jnp.asarray, W.qkv(Hkv=hkv, seed=seed, **shape))
    ref = JL.causal_attention(q, k, v, causal=causal)
    ring = jax.jit(_sharded(lambda q, k, v: ring_attention(
        q, k, v, axis_name="sp", causal=causal), W.SIZE))
    got = _gathered(ranks, name)
    np.testing.assert_allclose(got, np.asarray(ring(q, k, v)), **OUT)
    np.testing.assert_allclose(got, np.asarray(ref), **OUT)


def test_plain_ring_gradients_match_full(ranks):
    q, k, v = map(jnp.asarray, W.qkv())
    want = _jax_grads(lambda q, k, v: JL.causal_attention(q, k, v), q, k, v)
    got = _gathered_grads(ranks, "ring causal", range(W.SIZE))
    for n, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a, np.asarray(b), err_msg=f"d{n}", **GRAD)


@pytest.mark.parametrize("hkv", [8, 4])
def test_flash_ring_forward(ranks, hkv):
    q, k, v = map(jnp.asarray, W.qkv(Hkv=hkv, seed=3))
    ring = jax.jit(_sharded(lambda q, k, v: ring_attention(
        q, k, v, axis_name="sp", causal=True, kernel="flash"), W.SIZE))
    got = _gathered(ranks, f"flash fwd Hkv={hkv}")
    np.testing.assert_allclose(got, np.asarray(ring(q, k, v)), **OUT)
    np.testing.assert_allclose(
        got, np.asarray(JL.causal_attention(q, k, v)), **OUT)
    for r in range(W.SIZE):
        assert ranks[r][f"flash fwd Hkv={hkv}"]["calls"] == {
            "forward": r + 1, "dq": 0, "dkv": 0}


@pytest.mark.parametrize("hkv", [8, 4])
@pytest.mark.parametrize("n", [4, 2])
def test_flash_ring_gradients(ranks, hkv, n):
    """The world's ring, and each pair's ring over its half of the ranks
    (a pair holds the whole sequence, sharded two ways)."""
    q, k, v = map(jnp.asarray, W.qkv(Hkv=hkv, seed=5))
    ring = _sharded(lambda q, k, v: ring_attention(
        q, k, v, axis_name="sp", causal=True, kernel="flash"), n)
    jr = _jax_grads(ring, q, k, v)
    full = _jax_grads(lambda q, k, v: JL.causal_attention(q, k, v), q, k, v)
    name = (f"flash grads Hkv={hkv}" if n == W.SIZE
            else f"pair flash grads Hkv={hkv}")
    for members in ([list(range(W.SIZE))] if n == W.SIZE
                    else [[0, 1], [2, 3]]):
        got = _gathered_grads(ranks, name, members)
        for g, a, b, c in zip("qkv", got, jr, full):
            np.testing.assert_allclose(a, np.asarray(b), err_msg=f"d{g}",
                                       **GRAD)
            np.testing.assert_allclose(a, np.asarray(c), err_msg=f"d{g}",
                                       **GRAD)
        for i, r in enumerate(members):
            assert ranks[r][name]["calls"] == {"forward": i + 1,
                                               "dq": i + 1, "dkv": i + 1}


def test_flash_ring_rejects_noncausal(ranks):
    for r in ranks:
        assert "causal-only" in r["flash non-causal"]


@pytest.mark.parametrize("causal", [True, False])
def test_ulysses_matches_jax_and_full(ranks, causal):
    q, k, v = map(jnp.asarray, W.qkv())
    name = "ulysses causal" if causal else "ulysses non-causal"
    uly = jax.jit(_sharded(lambda q, k, v: ulysses_attention(
        q, k, v, axis_name="sp", causal=causal), W.SIZE))
    got = _gathered(ranks, name)
    np.testing.assert_allclose(got, np.asarray(uly(q, k, v)), **OUT)
    np.testing.assert_allclose(
        got, np.asarray(JL.causal_attention(q, k, v, causal=causal)), **OUT)
    if causal:
        want = _jax_grads(lambda q, k, v: JL.causal_attention(q, k, v),
                          q, k, v)
        for g, a, b in zip("qkv", _gathered_grads(ranks, name,
                                                  range(W.SIZE)), want):
            np.testing.assert_allclose(a, np.asarray(b), err_msg=f"d{g}",
                                       **GRAD)
    for r in ranks:
        assert "not divisible by sp axis size 4" in r["ulysses heads"]


def test_llama_sharded_matches_unsharded(ranks):
    """Logits of the sequence-sharded forward (flash ring, RoPE at each
    shard's offset) against the unsharded JAX forward; the ranks' loss
    shares and summed gradients against the global loss (the JAX
    long-context example's ``psum(sum(nll)) / count``) and its
    ``jax.grad``."""
    cfg = _llama_cfg()
    params = JLL.init(jax.random.PRNGKey(0), cfg)
    ids = jnp.asarray(W.llama_ids(cfg.vocab), jnp.int32)
    inp, tgt = ids[:, :-1], ids[:, 1:]
    ref = np.asarray(JLL.apply(params, inp, cfg))
    np.testing.assert_allclose(_gathered(ranks, "llama", "logits"), ref,
                               **OUT)

    def loss(p):
        h = JLL.apply(p, inp, cfg, return_hidden=True)
        return jnp.mean(JL.softmax_cross_entropy(
            JL.dense(p["lm_head"], h), tgt))
    want_loss, g = jax.value_and_grad(loss)(params)
    got_loss = sum(r["llama"]["loss"] for r in ranks)
    np.testing.assert_allclose(got_loss, float(want_loss), **OUT)
    for r in ranks:
        grads = r["llama"]["grads"]
        np.testing.assert_allclose(grads["embed.table"],
                                   np.asarray(g["embed"]["table"]), **GRAD)
        np.testing.assert_allclose(grads["lm_head.weight"],
                                   np.asarray(g["lm_head"]["kernel"]).T,
                                   **GRAD)
        for i, layer in enumerate(g["layers"]):
            for name, leaf in layer.items():
                for key, want in leaf.items():
                    torch_name = (f"layers.{i}.{name}."
                                  + ("weight" if key == "kernel" else key))
                    want = np.asarray(want)
                    np.testing.assert_allclose(
                        grads[torch_name],
                        want.T if key == "kernel" else want,
                        err_msg=torch_name, **GRAD)
