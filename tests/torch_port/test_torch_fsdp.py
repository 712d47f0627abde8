"""FSDP with tensor parallelism (``horovod_tpu_torch/parallel/fsdp.py``,
DTensor sharding propagation) against the JAX package's
``parallel/fsdp.py`` (GSPMD): the spec rules on the same trees, and one
FSDP + TP step of the ``tiny`` Llama on four gloo ranks (device mesh
``("dp", "fsdp", "tp")`` of shape (1, 2, 2), one spawned run of
``torch_port_fsdp_worker.py``) against ``make_fsdp_train_step`` on the same
mesh of four CPU devices and against the plain unsharded step.

Tolerances are tests/test_fsdp.py's: the loss rtol 1e-5, parameters atol
1e-5; each rank holds a quarter of a 2-D kernel."""

import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch.multiprocessing as tmp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from horovod_tpu.models import llama as JL
from horovod_tpu.parallel import fsdp as JF
from horovod_tpu_torch.models import llama as TL
from horovod_tpu_torch.parallel import fsdp as F

import torch_port_fsdp_worker as W
from torch_port_ports import hold_ports


def _free_port() -> int:
    """A port below the ephemeral range, free when taken (``hold_ports``)."""
    return hold_ports(1).release()[0]


def _tiny():
    return JL.init(jax.random.PRNGKey(0), JL.CONFIGS["tiny"])


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out_dir = str(tmp_path_factory.mktemp("fsdp"))
    tree = jax.tree_util.tree_map(np.asarray, _tiny())
    np.save(os.path.join(out_dir, "tiny.npy"), tree, allow_pickle=True)
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


def _port_name(path):
    """A JAX llama tree path -> (port parameter name, is a dense kernel)."""
    keys = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
    kernel = keys[-1] == "kernel"
    keys[-1] = "weight" if kernel else keys[-1]
    return ".".join(str(k) for k in keys), kernel


def test_auto_shard_spec():
    for shape in ((16, 4), (3, 5), (), (8, 64), (64, 8, 8), (7,)):
        for size in (2, 8):
            assert F.auto_shard_spec(shape, "fsdp", size) == tuple(
                JF.auto_shard_spec(shape, "fsdp", size))
    assert F.auto_shard_spec((8, 64), "fsdp", 8) == (None, "fsdp")


def test_llama_param_specs_equal_jax():
    """Per parameter: the JAX spec, reversed for a dense kernel (the port's
    ``[out, in]``), the same for the embedding and the norms."""
    params = _tiny()
    model = TL.Llama(TL.CONFIGS["tiny"], "meta")
    for kw in ({}, {"tp_axis": None}, {"fsdp_axis": None}):
        got = F.llama_param_specs(model, **kw)
        want = JF.llama_param_specs(params, **kw)
        flat = jax.tree_util.tree_flatten_with_path(
            want, is_leaf=lambda x: isinstance(x, P))[0]
        assert len(flat) == len(got)
        for path, spec in flat:
            name, kernel = _port_name(path)
            spec = tuple(spec)
            assert got[name] == (spec[::-1] if kernel else spec), name
    specs = F.llama_param_specs(model)
    assert specs["layers.0.wq.weight"] == ("tp", "fsdp")
    assert specs["layers.0.wo.weight"] == ("fsdp", "tp")
    assert specs["embed.table"] == (("fsdp", "tp"), None)
    assert specs["layers.0.attn_norm.scale"] == ()


class _Mesh8:
    """The axis names and sizes of a (1, 8, 1) device mesh."""
    mesh_dim_names = ("dp", "fsdp", "tp")

    @staticmethod
    def size(i):
        return (1, 8, 1)[i]


def test_fsdp_shardings_equal_jax():
    """Per parameter: the JAX spec of the same leaf (reversed for a
    non-square dense kernel; a square one shards the first dim of its own
    layout in both)."""
    jmesh = Mesh(np.array(jax.devices()[:8]).reshape(1, 8, 1),
                 ("dp", "fsdp", "tp"))
    params = _tiny()
    want = jax.tree_util.tree_flatten_with_path(
        JF.fsdp_shardings(params, jmesh))[0]
    shapes = dict((_port_name(path)[0], np.shape(a)) for path, a in
                  jax.tree_util.tree_flatten_with_path(params)[0])
    got = F.fsdp_shardings(TL.Llama(TL.CONFIGS["tiny"], "meta"), _Mesh8)
    assert len(got) == len(want)
    for path, sh in want:
        name, kernel = _port_name(path)
        spec = tuple(sh.spec)
        square = kernel and len(set(shapes[name])) == 1
        assert got[name] == (spec if square or not kernel
                             else spec[::-1]), name


def test_no_rank_raised(ranks):
    for r in ranks:
        assert "_error" not in r, r.get("_error")


def test_fsdp_step_matches_jax_and_the_plain_step(ranks):
    cfg = JL.CONFIGS["tiny"]
    params0 = _tiny()
    opt = optax.sgd(W.LR)
    ids = jnp.asarray(W.batch(), jnp.int32)
    mesh = Mesh(np.array(jax.devices()[:W.SIZE]).reshape(W.MESH),
                ("dp", "fsdp", "tp"))
    specs = JF.llama_param_specs(params0, mesh=mesh)
    with mesh:
        p_sh = JF.shard_params(params0, mesh, specs)
        s_sh = jax.jit(opt.init)(p_sh)
        step = JF.make_fsdp_train_step(
            lambda p, b: JL.loss_fn(p, b, cfg), opt, mesh, specs,
            batch_spec=P(("dp", "fsdp")), donate=False)
        batch = jax.device_put(ids, NamedSharding(mesh, P(("dp", "fsdp"))))
        p_new, _, loss = step(p_sh, s_sh, batch)
    want = {}
    for path, a in jax.tree_util.tree_flatten_with_path(p_new)[0]:
        name, kernel = _port_name(path)
        want[name] = np.asarray(a).T if kernel else np.asarray(a)
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got["loss"], float(loss), rtol=1e-5)
        np.testing.assert_allclose(got["loss"], got["plain_loss"],
                                   rtol=1e-5)
        for name, a in got["params"].items():
            np.testing.assert_allclose(a, want[name], atol=1e-5,
                                       err_msg=f"rank {r} {name} vs JAX")
            np.testing.assert_allclose(a, got["plain"][name], atol=1e-5,
                                       err_msg=f"rank {r} {name} vs plain")


def test_fsdp_param_memory_is_sharded(ranks):
    for got in ranks:
        assert int(np.prod(got["wq_local"])) * 4 == int(
            np.prod(got["wq_global"]))
        assert "Shard(dim=0)" in got["placements"]["embed.table"]
