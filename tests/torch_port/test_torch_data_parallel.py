"""The port's data-parallel path against the JAX package's: fusion plans,
the plan cache, gradient sync and two training steps on two gloo ranks
against JAX's make_train_step on a two-device CPU mesh, the optimizer's
accumulation, the runtime's refusals, and that the port imports no JAX."""

import ast
import os
import subprocess
import sys
import time

import numpy as np
import optax
import pytest
import torch
import torch.multiprocessing as tmp

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from horovod_tpu.models import llama as JL
from horovod_tpu.ops import fusion as JFU
from horovod_tpu.optimizer import distributed_optimizer
from horovod_tpu.parallel.data_parallel import (make_train_step, replicate,
                                                shard_batch)

import horovod_tpu_torch as hvd
from horovod_tpu_torch.ops import fusion as TFU

import torch_port_dp_worker
from torch_port_ports import hold_ports

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# eps 1e-3 keeps Adam's m / (sqrt(v) + eps) well-conditioned where a gradient
# entry is near zero: at eps 1e-8 the two frameworks' fp32 summation orders
# alone move such an entry's update by a few percent.
OPT_KW = dict(lr=1e-3, betas=(0.9, 0.999), eps=1e-3, weight_decay=0.01)

_T2J = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
        torch.float16: jnp.float16, torch.int32: jnp.int32}


# ------------------------------------------------------------- fusion plans
_PLAN_CASES = {
    "mixed": ([(4, 4), (8,), (2, 3, 5), (16, 16), (), (7,)],
              [torch.float32, torch.bfloat16, torch.float32, torch.float32,
               torch.float32, torch.bfloat16], 256),
    "oversize": ([(8,), (1024,), (8,), (4, 4)],
                 [torch.float32] * 4, 512),       # 4 KiB tensor, 512 B cap
    "exact-fill": ([(32,), (32,), (32,)], [torch.float32] * 3, 128),
    "one-bucket": ([(3,), (5,), (7,)], [torch.float16] * 3, 1 << 20),
}


@pytest.mark.parametrize("case", sorted(_PLAN_CASES))
def test_make_plan_matches_jax(case):
    shapes, dtypes, threshold = _PLAN_CASES[case]
    got = TFU.make_plan(shapes, dtypes, threshold)
    ref = JFU.make_plan(shapes, [_T2J[d] for d in dtypes], threshold)
    assert [b.indices for b in got.buckets] == \
        [b.indices for b in ref.buckets]
    assert [b.nbytes for b in got.buckets] == [b.nbytes for b in ref.buckets]
    assert [b.shapes for b in got.buckets] == [b.shapes for b in ref.buckets]


def test_plan_cache_hits_and_lru_eviction():
    cache = TFU.BucketPlanCache(capacity=2)
    a = cache.get([(4,)], [torch.float32], 64)
    assert cache.get([(4,)], [torch.float32], 64) is a
    cache.get([(8,)], [torch.float32], 64)
    cache.get([(4,)], [torch.float32], 64)        # a is most recent again
    cache.get([(16,)], [torch.float32], 64)       # evicts (8,)
    assert (cache.hits, cache.misses) == (2, 3)
    cache.get([(4,)], [torch.float32], 64)
    cache.get([(8,)], [torch.float32], 64)
    assert (cache.hits, cache.misses) == (3, 4)
    off = TFU.BucketPlanCache(capacity=0)
    off.get([(4,)], [torch.float32], 64)
    off.get([(4,)], [torch.float32], 64)
    assert (off.hits, off.misses) == (0, 2)


def test_pack_unpack_round_trip():
    leaves = [torch.arange(6.).reshape(2, 3), torch.arange(4.), torch.ones(())]
    plan = TFU.make_plan([tuple(t.shape) for t in leaves],
                         [t.dtype for t in leaves], 1 << 20)
    out = TFU.fused_apply(leaves, plan, lambda b: b * 2)
    for a, b in zip(out, leaves):
        torch.testing.assert_close(a, b * 2)


# -------------------------------------------------------- two gloo ranks
def _free_port() -> int:
    """A port below the ephemeral range, free when taken (``hold_ports``)."""
    return hold_ports(1).release()[0]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Both ranks of the port and the JAX reference on the same inputs."""
    rng = np.random.RandomState(0)
    grads = [rng.randn(2, *s).astype(np.float32)
             for s in ((16,), (4, 8), (512,), (3, 5), (40,))]
    cfg = JL.CONFIGS["tiny"]
    params = JL.init(jax.random.PRNGKey(0), cfg)
    tree = jax.tree_util.tree_map(np.asarray, params)
    batches = [rng.randint(0, cfg.vocab, (4, 33)).astype(np.int32)
               for _ in range(2)]
    out_dir = str(tmp_path_factory.mktemp("dp"))
    ctx = tmp.spawn(torch_port_dp_worker.run,
                    args=(2, _free_port(), out_dir, grads, tree, batches,
                          OPT_KW),
                    nprocs=2, join=False)
    deadline = time.monotonic() + 180
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.terminate()
            pytest.fail("gloo ranks did not finish in 180 s")
    ranks = [np.load(os.path.join(out_dir, f"rank{r}.npy"),
                     allow_pickle=True).item() for r in range(2)]

    # the JAX package's data-parallel step on a two-device CPU mesh
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
    return {"grads": grads, "ranks": ranks, "jax_losses": losses,
            "jax_params": jax.tree_util.tree_map(np.asarray, jp)}


def test_two_ranks_sync_gradients_to_the_mean(two_ranks):
    for r in two_ranks["ranks"]:
        assert (r["rank"], r["size"]) in ((0, 2), (1, 2))
        for got, g in zip(r["synced"], two_ranks["grads"]):
            np.testing.assert_allclose(got, g.mean(0), rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(r["max"], [2.0] * 3)
        np.testing.assert_array_equal(r["sum_scaled"], [3.0] * 3)


def test_two_ranks_train_like_jax_make_train_step(two_ranks):
    from test_torch_llama import _jax_grads_as_torch  # same name mapping
    ref = _jax_grads_as_torch(two_ranks["jax_params"])
    for r in two_ranks["ranks"]:
        np.testing.assert_allclose(r["losses"], two_ranks["jax_losses"],
                                   rtol=1e-5, atol=1e-5)
        for name, p in r["params"].items():
            np.testing.assert_allclose(p, ref[name], rtol=1e-5, atol=1e-5,
                                       err_msg=name)


# ------------------------------------------------------ one-rank runtime
@pytest.fixture
def one_rank():
    rt = hvd.init(device="cpu")
    yield rt
    hvd.shutdown()


def test_topology_of_one_rank(one_rank):
    assert (hvd.rank(), hvd.size(), hvd.local_rank(), hvd.local_size(),
            hvd.cross_rank(), hvd.cross_size()) == (0, 1, 0, 1, 0, 1)
    assert hvd.is_homogeneous()
    assert one_rank.device.type == "cpu"
    assert one_rank.fusion_threshold() == 128 * 1024 * 1024


def test_backward_passes_accumulate_like_jax(one_rank):
    """backward_passes_per_step=2: every second step applies the mean of
    the two gradients, as the JAX wrapper's accumulation does."""
    rng = np.random.RandomState(3)
    w0 = rng.randn(5).astype(np.float32)
    gs = [rng.randn(5).astype(np.float32) for _ in range(4)]
    w = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    opt = hvd.DistributedOptimizer(torch.optim.SGD([w], lr=0.1),
                                   backward_passes_per_step=2)
    jopt = distributed_optimizer(optax.sgd(0.1), axis_name=None,
                                 backward_passes_per_step=2)
    jw, js = jnp.asarray(w0), None
    js = jopt.init(jw)
    for g in gs:
        w.grad = torch.from_numpy(g.copy())
        opt.step()
        updates, js = jopt.update(jnp.asarray(g), js, jw)
        jw = optax.apply_updates(jw, updates)
        np.testing.assert_allclose(w.detach().numpy(), np.asarray(jw),
                                   rtol=1e-6, atol=1e-6)


def test_unported_options_raise():
    """The wire and overlap planes and Adasum are ported
    (test_torch_wire*.py, test_torch_adasum.py); what raises is bad
    values of their options, and Adasum where a process-group reduction
    is asked for."""
    opt = torch.optim.SGD([torch.nn.Parameter(torch.zeros(2))], lr=0.1)
    for kw in ({"wire_policy": "int9"}, {"overlap_depth": 9},
               {"quantized_wire": True, "op": hvd.Max}):
        with pytest.raises(ValueError):
            hvd.DistributedOptimizer(opt, **kw)
    with pytest.raises(ValueError):
        hvd.DistributedOptimizer(opt, backward_passes_per_step=0)
    with pytest.raises(ValueError, match="named_parameters"):
        hvd.DistributedOptimizer(opt, named_parameters=[])
    with pytest.raises(ValueError, match="ADASUM is not a process-group"):
        hvd.spmd.torch_op(hvd.Adasum)


def test_init_refusals(monkeypatch):
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            hvd.init()
    monkeypatch.setenv("HOROVOD_WIRE_POLICY", "int9")
    with pytest.raises(ValueError, match="unknown wire policy"):
        hvd.init(device="cpu")
    monkeypatch.setenv("HOROVOD_WIRE_POLICY", "none")
    monkeypatch.setenv("HOROVOD_OVERLAP_DEPTH", "0")
    with pytest.raises(ValueError, match="HOROVOD_OVERLAP_DEPTH"):
        hvd.init(device="cpu")
    monkeypatch.setenv("HOROVOD_OVERLAP_DEPTH", "1")
    monkeypatch.setenv("HOROVOD_SIZE", "3")
    monkeypatch.setenv("HOROVOD_LOCAL_SIZE", "2")
    with pytest.raises(ValueError, match="HOROVOD_LOCAL_SIZE"):
        hvd.init(device="cpu")
    monkeypatch.setenv("HOROVOD_LOCAL_SIZE", "-1")
    monkeypatch.setenv("HOROVOD_SIZE", "2")
    monkeypatch.setenv("HOROVOD_RANK", "1")
    with pytest.raises(RuntimeError, match="HOROVOD_COORDINATOR_ADDR"):
        hvd.init(device="cpu")
    assert not hvd.is_initialized()


# ------------------------------------------------------------------ imports
_FORBIDDEN = {"jax", "jaxlib", "optax", "flax", "horovod_tpu"}


def _port_files():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for dirpath, _, names in os.walk(os.path.join(REPO, "horovod_tpu_torch")):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return sorted(files)


def test_port_imports_no_jax_and_nothing_of_horovod_tpu():
    files = _port_files()
    assert len(files) > 10
    bad = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{os.path.relpath(path, REPO)}:{node.lineno} {n}"
                    for n in names if n.split(".")[0] in _FORBIDDEN]
    assert not bad, bad


def test_spark_estimators_load_no_jax():
    """A fresh process loads ``horovod_tpu_torch.spark`` with the Store,
    ``prepare_data`` and the estimators, writes a dataset and builds both
    estimators: neither ``jax`` nor ``horovod_tpu`` lands in
    ``sys.modules``."""
    prog = (
        "import sys, tempfile\n"
        "import numpy as np\n"
        "from horovod_tpu_torch import spark\n"
        "from horovod_tpu_torch.spark import estimator, prepare, store\n"
        "s = spark.Store.create(tempfile.mkdtemp())\n"
        "spark.prepare_data(s, {'features': np.ones((4, 2)), "
        "'label': np.zeros((4, 1))}, ['features'], ['label'])\n"
        "spark.LinearEstimator(s)._make_train_task()\n"
        "spark.TorchEstimator(s, lambda: None)._make_train_task()\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in " + repr(sorted(_FORBIDDEN))
        + ")\nprint('LOADED-NONE' if not bad else bad)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", prog], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "LOADED-NONE" in out.stdout, (
        out.stdout[-2000:], out.stderr[-2000:])
