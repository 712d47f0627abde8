"""Adasum (``horovod_tpu_torch/parallel/adasum.py`` and the paths that take
``op=Adasum``) on four gloo ranks against the numpy model of
tests/test_adasum.py and the JAX package on four CPU devices.

One spawned run (``torch_port_adasum_worker.py``) of four ranks laid out
as two hosts of two: the recursion over the world against the numpy model
and ``adasum_allreduce`` under ``shard_map``; identical vectors (their
mean) and orthogonal ones (their sum); a one-rank group (the identity) and
a three-rank group (the power-of-two error, JAX's message);
``dot_group`` against JAX's ``dot_axis`` on a 2 x 2 mesh; the two-level
``adasum_hierarchical`` against JAX's; ``spmd.allreduce(op=Adasum)``, flat
and under HOROVOD_HIERARCHICAL_ALLREDUCE; ``sync_gradients(op=Adasum)``
against the JAX ``sync_gradients`` over the same buckets.  Then, on a
two-rank job negotiated by the native controller, the eager
``allreduce(op=Adasum)`` (and its gradient, Average's), a grouped Adasum
allreduce (one recursion per tensor) and the delta optimizer.

Tolerance: tests/test_adasum.py's rtol 1e-4 throughout, and every rank
bitwise equal to rank 0 (the pair combine is symmetric, so both partners
hold the same vector after every round)."""

import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch.multiprocessing as tmp
from jax.sharding import Mesh, PartitionSpec as P

from horovod_tpu.common.reduce_op import ReduceOp
from horovod_tpu.ops._compat import shard_map
from horovod_tpu.optimizer import sync_gradients
from horovod_tpu.parallel.adasum import adasum_allreduce, adasum_hierarchical

import torch_port_adasum_worker as W
from torch_port_ports import hold_ports

RTOL = 1e-4


def _free_port() -> int:
    """A port below the ephemeral range, free when taken (``hold_ports``)."""
    return hold_ports(1).release()[0]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out_dir = str(tmp_path_factory.mktemp("adasum"))
    ctx = tmp.spawn(W.run, args=((_free_port(), _free_port(), _free_port()),
                                 out_dir), nprocs=W.SIZE, join=False)
    deadline = time.monotonic() + 120
    while not ctx.join(timeout=2):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.terminate()
            pytest.fail("gloo ranks did not finish in 120 s")
    return [np.load(os.path.join(out_dir, f"rank{r}.npy"),
                    allow_pickle=True).item() for r in range(W.SIZE)]


def _adasum_pair_np(a, b):
    dot = float(np.sum(a * b))
    na = float(np.sum(a * a))
    nb = float(np.sum(b * b))
    ca = 1.0 - dot / (2 * na) if na > 0 else 1.0
    cb = 1.0 - dot / (2 * nb) if nb > 0 else 1.0
    return ca * a + cb * b


def _adasum_np(vectors):
    """tests/test_adasum.py's model of the XOR recursion, in float64."""
    vs = [v.astype(np.float64) for v in vectors]
    k = 1
    while k < len(vs):
        vs = [_adasum_pair_np(vs[i], vs[i ^ k]) for i in range(len(vs))]
        k *= 2
    return vs[0]


def _grid():
    return Mesh(np.array(jax.devices()[:W.SIZE]).reshape(2, 2), ("a", "b"))


def _flat():
    return Mesh(np.array(jax.devices()[:W.SIZE]), ("hvd",))


def _leaves(x):
    return x if isinstance(x, list) else [x]


def _same_on_every_rank(ranks, name, n=W.SIZE):
    for r in range(1, n):
        for a, b in zip(_leaves(ranks[r][name]), _leaves(ranks[0][name])):
            np.testing.assert_array_equal(a, b, err_msg=f"{name} rank {r}")


def test_no_case_raised(ranks):
    for r in ranks:
        crashed = {n: v for n, v in r.items() if n.startswith("_")}
        assert not crashed, crashed


def test_matches_numpy_model_and_jax(ranks):
    xs = W.vectors(0)
    want = _adasum_np(list(xs))
    f = jax.jit(shard_map(lambda x: adasum_allreduce(x, "hvd"), mesh=_flat(),
                          in_specs=(P("hvd"),), out_specs=P("hvd")))
    jx = np.asarray(f(jnp.asarray(xs)))
    for r in range(W.SIZE):
        np.testing.assert_allclose(ranks[r]["model"], want, rtol=RTOL)
        np.testing.assert_allclose(ranks[r]["model"], jx[r], rtol=RTOL)
    _same_on_every_rank(ranks, "model")


def test_identical_vectors_average_and_orthogonal_sum(ranks):
    v = W.vectors(1, 1, 8)[0]
    for r in range(W.SIZE):
        np.testing.assert_allclose(ranks[r]["identical"], v, rtol=RTOL)
        np.testing.assert_allclose(ranks[r]["orthogonal"], np.ones(W.SIZE),
                                   rtol=RTOL)
        assert ranks[r]["one rank"] is True


def test_non_power_of_two_raises(ranks):
    for r in range(3):
        assert "power-of-two axis size, got 3" in ranks[r][
            "non power of two"]


def test_dot_group_matches_jax_dot_axis(ranks):
    xs = W.vectors(2, W.SIZE, 8)
    f = jax.jit(shard_map(lambda x: adasum_allreduce(x, "a", dot_axis="b"),
                          mesh=_grid(), in_specs=(P("a", "b"),),
                          out_specs=P("a", "b")))
    jx = np.asarray(f(jnp.asarray(xs.reshape(2, 16))))
    # rank (i, j) holds shard j of row i; the model combines whole rows
    want = _adasum_np([xs[0:2].reshape(-1), xs[2:4].reshape(-1)])
    for r in range(W.SIZE):
        i, j = divmod(r, 2)
        np.testing.assert_allclose(ranks[r]["dot_group"],
                                   jx[i, j * 8:(j + 1) * 8], rtol=RTOL)
        np.testing.assert_allclose(ranks[r]["dot_group"],
                                   want[j * 8:(j + 1) * 8], rtol=RTOL)


def test_hierarchical_matches_jax(ranks):
    xs = W.vectors(3)
    f = jax.jit(shard_map(
        lambda x: adasum_hierarchical(x, ici_axis="b", dcn_axis="a"),
        mesh=_grid(), in_specs=(P(("a", "b")),), out_specs=P(("a", "b"))))
    jx = np.asarray(f(jnp.asarray(xs)))
    want = _adasum_np([xs[0:2].mean(0), xs[2:4].mean(0)])
    for r in range(W.SIZE):
        np.testing.assert_allclose(ranks[r]["hierarchical"], jx[r],
                                   rtol=RTOL)
        np.testing.assert_allclose(ranks[r]["hierarchical"], want,
                                   rtol=RTOL)
    _same_on_every_rank(ranks, "hierarchical")


def test_spmd_allreduce_flat_and_two_level(ranks):
    """The flat path with scale factors, and the two-level path's fallback
    (JAX: Adasum over the combined (dcn, ici) axes, host-major)."""
    xs = W.vectors(4)
    want = _adasum_np(list(xs))
    for r in range(W.SIZE):
        np.testing.assert_allclose(ranks[r]["spmd"],
                                   _adasum_np(list(2.0 * xs)) * 0.25,
                                   rtol=RTOL)
        np.testing.assert_allclose(ranks[r]["spmd two-level"], want,
                                   rtol=RTOL)
    _same_on_every_rank(ranks, "spmd")
    _same_on_every_rank(ranks, "spmd two-level")


def test_sync_gradients_matches_jax(ranks):
    inputs = W.sync_inputs()
    stacked = [jnp.asarray(np.stack([inputs[r][i] for r in range(W.SIZE)]))
               for i in range(len(W.SYNC_SHAPES))]

    def body(*xs):
        out = sync_gradients([x[0] for x in xs], "hvd", op=ReduceOp.ADASUM,
                             fusion_threshold_bytes=W.THRESHOLD)
        return [o[None] for o in out]
    f = jax.jit(shard_map(body, mesh=_flat(),
                          in_specs=(P("hvd"),) * len(stacked),
                          out_specs=P("hvd"), check_vma=False))
    jx = [np.asarray(o) for o in f(*stacked)]
    for r in range(W.SIZE):
        for i, got in enumerate(ranks[r]["sync_gradients"]):
            np.testing.assert_allclose(got, jx[i][r], rtol=RTOL,
                                       err_msg=f"leaf {i} rank {r}")
    _same_on_every_rank(ranks, "sync_gradients")


def test_eager_allreduce_and_grouped(ranks):
    xs = W.vectors(5, 2, 16)
    for r in range(2):
        np.testing.assert_allclose(ranks[r]["eager"], _adasum_np(list(xs)),
                                   rtol=RTOL)
        np.testing.assert_allclose(ranks[r]["eager grad"], np.ones(16),
                                   rtol=RTOL)
        for got, seed, dim in zip(ranks[r]["eager grouped"], (6, 7), (8, 3)):
            np.testing.assert_allclose(
                got, _adasum_np(list(W.vectors(seed, 2, dim))), rtol=RTOL)
        assert ranks[r]["negotiated"]
    for name in ("eager", "eager grouped"):
        _same_on_every_rank(ranks, name, n=2)


def test_delta_optimizer(ranks):
    """One SGD step per rank on its own gradients; the parameters become
    ``before + adasum(-lr * grad)`` on both ranks, under the names
    ``adasum.delta.{group}.{index}``."""
    w, grads = W.delta_inputs()
    for r in range(2):
        assert ranks[r]["delta class"] == ("SGD", True)
        assert ranks[r]["delta names"] == ["adasum.delta.0.0",
                                           "adasum.delta.0.1"]
        for i, got in enumerate(ranks[r]["delta"]):
            deltas = [-W.LR * grads[q][i] for q in range(2)]
            np.testing.assert_allclose(got, w[i] + _adasum_np(deltas),
                                       rtol=RTOL, err_msg=f"param {i}")
            np.testing.assert_array_equal(got, ranks[0]["delta"][i])
