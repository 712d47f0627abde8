"""The port's ZeRO chain (``horovod_tpu_torch/parallel/zero.py``) in one
process: the knobs and their resolution order, the plan and pad geometry
against the JAX package's, the level-3 shard/gather round trip, the
state-layout guard, the builders' argument checks, the level-3 gather
window, one-rank equivalences, and the cost model
(``perf/costmodel.py``) and ``pack_bucket_padded`` equal to the JAX
package's.  Four ranks against the JAX chain: test_torch_zero_gloo.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops import fusion as JF
from horovod_tpu.parallel import zero as JZ
from horovod_tpu.perf import costmodel as JC

import horovod_tpu_torch as hvd
from horovod_tpu_torch.models import llama
from horovod_tpu_torch.ops import fusion as TF
from horovod_tpu_torch.parallel import zero as Z
from horovod_tpu_torch.perf import costmodel as TC

THRESH = 64


@pytest.fixture
def rt():
    hvd.shutdown()
    rt = hvd.init(device="cpu")
    yield rt
    hvd.shutdown()


def _toy():
    rng = np.random.RandomState(0)
    w1 = rng.randn(7, 5).astype(np.float32)
    b1 = rng.randn(5).astype(np.float32)
    w2 = rng.randn(5, 1).astype(np.float32)
    arrays = {"b1": b1, "w1": w1, "w2": w2}

    class Toy(torch.nn.Module):
        def __init__(self):
            super().__init__()
            for name, a in arrays.items():
                setattr(self, name, torch.nn.Parameter(torch.from_numpy(a)))

    def loss_fn(m, x, y):
        h = torch.tanh(x @ m.w1 + m.b1)
        return torch.mean((h @ m.w2 - y) ** 2)
    return Toy(), loss_fn, arrays


def _batch(seed=1):
    rng = np.random.RandomState(seed)
    return (torch.from_numpy(rng.randn(8, 7).astype(np.float32)),
            torch.from_numpy(rng.randn(8, 1).astype(np.float32)))


# ------------------------------------------------------------------ knobs
@pytest.mark.parametrize("knob,bad", [
    ("HOROVOD_ZERO_LEVEL", "5"), ("HOROVOD_ZERO_LEVEL", "-1"),
    ("HOROVOD_ZERO_AG_PREFETCH", "0"), ("HOROVOD_ZERO_AG_PREFETCH", "99"),
    ("HOROVOD_PREFETCH_DEPTH", "0")])
def test_knobs_fail_at_init(monkeypatch, knob, bad):
    hvd.shutdown()
    monkeypatch.setenv(knob, bad)
    with pytest.raises(ValueError, match=knob):
        hvd.init(device="cpu")
    assert not hvd.is_initialized()


def test_resolution_order(monkeypatch):
    for knob in ("HOROVOD_ZERO_LEVEL", "HOROVOD_ZERO_AG_PREFETCH"):
        monkeypatch.delenv(knob, raising=False)
    assert Z.resolve_zero_level() == 1          # the knob's default
    assert Z.resolve_zero_level(3) == 3         # the argument wins
    monkeypatch.setenv("HOROVOD_ZERO_LEVEL", "2")
    assert Z.resolve_zero_level() == 2          # read live
    assert Z.resolve_zero_level(1) == 1
    assert Z.resolve_ag_prefetch() == 2
    monkeypatch.setenv("HOROVOD_ZERO_AG_PREFETCH", "4")
    assert Z.resolve_ag_prefetch() == 4
    assert Z.resolve_ag_prefetch(1) == 1
    with pytest.raises(ValueError, match="zero level"):
        Z.resolve_zero_level(7)
    with pytest.raises(ValueError, match="prefetch depth"):
        Z.resolve_ag_prefetch(9)


# --------------------------------------------------------------- geometry
@pytest.mark.parametrize("thresh", [64, 100, 1 << 20])
def test_plan_is_the_jax_plan(thresh):
    _, _, arrays = _toy()
    jplan = JZ._bucket_plan({k: jnp.asarray(v) for k, v in arrays.items()},
                            thresh)
    tplan = Z._bucket_plan([torch.from_numpy(v) for v in arrays.values()],
                           thresh)
    assert [b.indices for b in tplan.buckets] == \
        [b.indices for b in jplan.buckets]
    assert [b.sizes for b in tplan.buckets] == [b.sizes for b in jplan.buckets]


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
def test_pack_and_shard_geometry(n):
    _, _, arrays = _toy()
    leaves = [torch.from_numpy(v) for v in arrays.values()]
    jleaves = [jnp.asarray(v) for v in arrays.values()]
    plan = Z._bucket_plan(leaves, THRESH)
    jplan = JZ._bucket_plan(dict(zip(arrays, jleaves)), THRESH)
    for b, jb in zip(plan.buckets, jplan.buckets):
        flat = Z._pack_padded(leaves, b, n)
        want = np.asarray(JZ._pack_padded(jleaves, jb, n))
        np.testing.assert_array_equal(flat.numpy(), want)
        assert flat.numel() == Z._padded_len(sum(b.sizes), n) == \
            JZ._padded_len(sum(jb.sizes), n)
        shards = [Z._pack_shard(leaves, b, n, r) for r in range(n)]
        np.testing.assert_array_equal(torch.cat(shards).numpy(), want)


@pytest.mark.parametrize("multiple", [1, 3, 4, 7])
def test_pack_bucket_padded_is_the_jax_one(multiple):
    rng = np.random.RandomState(3)
    arrays = [rng.randn(*s).astype(np.float32) for s in ((5,), (2, 3), (4,))]
    shapes = [a.shape for a in arrays]
    tplan = TF.make_plan(shapes, [torch.float32] * 3, 1 << 20)
    jplan = JF.make_plan(shapes, [jnp.float32] * 3, 1 << 20)
    got = TF.pack_bucket_padded([torch.from_numpy(a) for a in arrays],
                                tplan.buckets[0], multiple)
    want = JF.pack_bucket_padded([jnp.asarray(a) for a in arrays],
                                 jplan.buckets[0], multiple)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    as_f32 = TF.pack_bucket_padded([torch.from_numpy(a).bfloat16()
                                    for a in arrays], tplan.buckets[0],
                                   multiple, dtype=torch.float32)
    assert as_f32.dtype == torch.float32
    np.testing.assert_array_equal(
        as_f32.numpy(), got.bfloat16().float().numpy())


# ------------------------------------------------------------ cost model
GRID = [(nelems, world, level, k, fmt)
        for nelems in (1, 1000, 8030261248) for world in (1, 2, 4, 8)
        for level in (0, 1, 2, 3) for k in (1, 2, 4)
        for fmt in ("none", "bf16", "int8_ring", "dcn_int8")]


def test_zero_comm_bytes_is_the_jax_model():
    for nelems, world, level, k, fmt in GRID:
        assert TC.zero_comm_bytes(nelems, world, level, k=k,
                                  wire_format=fmt) == JC.zero_comm_bytes(
            nelems, world, level, k=k, wire_format=fmt)
    with pytest.raises(ValueError, match="zero level"):
        TC.zero_comm_bytes(10, 4, 5)


def test_zero_memory_bytes_is_the_jax_model():
    for n_params in (1, 12345, 8030261248):
        for world in (1, 2, 4, 8):
            for level in (0, 1, 2, 3):
                for slots in (1, 2):
                    for ef in (False, True):
                        assert TC.zero_memory_bytes(
                            level, n_params, world, opt_slots=slots,
                            ef=ef) == JC.zero_memory_bytes(
                            level, n_params, world, opt_slots=slots, ef=ef)
    n8b = llama.param_count(llama.CONFIGS["8b"])
    assert n8b == 8030261248
    assert TC.zero_memory_bytes(0, n8b, 1)["total_bytes"] == 16 * n8b
    assert TC.zero_memory_bytes(3, n8b, 4)["total_bytes"] == 4 * n8b


# ------------------------------------------------------ level-3 shards
def test_zero3_shard_gather_round_trip(rt):
    model, _, arrays = _toy()
    shards = Z.shard_zero3_params(model, fusion_threshold_bytes=THRESH)
    plan = Z._bucket_plan(list(model.parameters()), THRESH)
    assert [s.numel() for s in shards] == [sum(b.sizes)
                                           for b in plan.buckets]
    assert all(s.dtype == torch.float32 for s in shards)
    back = Z.gather_zero3_params(shards, model, fusion_threshold_bytes=THRESH)
    for got, want in zip(back, arrays.values()):
        np.testing.assert_array_equal(got.numpy(), want)


def test_zero3_gather_takes_the_templates_dtypes(rt):
    cfg = llama.CONFIGS["tiny"]
    model = llama.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    half = [p.detach().bfloat16() for p in model.parameters()]
    shards = Z.shard_zero3_params(half, fusion_threshold_bytes=4096)
    back = Z.gather_zero3_params(shards, half, fusion_threshold_bytes=4096)
    for got, want in zip(back, half):
        assert got.dtype == torch.bfloat16
        assert torch.equal(got, want)


def test_level3_step_frees_the_parameters_between_steps(rt):
    model, loss_fn, arrays = _toy()
    state = Z.init_zero_state(torch.optim.SGD, model, zero_level=3,
                              fusion_threshold_bytes=THRESH, lr=0.1)
    step = Z.make_zero_train_step(model, loss_fn, state, zero_level=3,
                                  fusion_threshold_bytes=THRESH)
    assert all(p.untyped_storage().size() == 0 for p in model.parameters())
    step(*_batch())
    assert all(p.untyped_storage().size() == 0 for p in model.parameters())
    assert all(p.grad is None for p in model.parameters())
    assert all(s.grad is None for s in state.shards)
    full = Z.gather_zero3_params(state.shards, model,
                                 fusion_threshold_bytes=THRESH)
    assert [tuple(p.shape) for p in full] == [a.shape for a in
                                              arrays.values()]


def test_a_dropped_step_frees_its_model(rt):
    """The gradient hooks live on the parameters, out of the collector's
    sight, so a cycle through them is never collected: a dropped step's
    parameters and shards must go."""
    import gc
    import weakref
    model, loss_fn, _ = _toy()
    state = Z.init_zero_state(torch.optim.SGD, model, zero_level=2,
                              fusion_threshold_bytes=THRESH, lr=0.1)
    step = Z.make_zero_train_step(model, loss_fn, state, zero_level=2,
                                  fusion_threshold_bytes=THRESH)
    step(*_batch())
    refs = [weakref.ref(t) for t in [*model.parameters(), *state.shards]]
    del model, state, step
    gc.collect()
    assert all(r() is None for r in refs)


# -------------------------------------------------- layout and arguments
def test_mismatched_state_layout_raises(rt):
    model, loss_fn, _ = _toy()
    inter = Z.init_sharded_opt_state(torch.optim.Adam, model,
                                     interleaved=True,
                                     fusion_threshold_bytes=THRESH)
    mono_step = Z.make_zero1_train_step(model, loss_fn, inter)
    with pytest.raises(ValueError, match="interleaved"):
        mono_step(*_batch())
    mono = Z.init_sharded_opt_state(torch.optim.Adam, model)
    inter_step = Z.make_zero_train_step(model, loss_fn, mono, zero_level=1,
                                        fusion_threshold_bytes=THRESH)
    with pytest.raises(ValueError, match="layout mismatch"):
        inter_step(*_batch())


def test_builder_argument_validation(rt):
    model, loss_fn, _ = _toy()
    state = Z.init_zero_state(torch.optim.SGD, model, zero_level=1,
                              fusion_threshold_bytes=THRESH, lr=0.1)
    with pytest.raises(ValueError, match="zero_level=0"):
        Z.make_zero_train_step(model, loss_fn, state, zero_level=0)
    with pytest.raises(ValueError, match="plain data parallelism"):
        Z.init_zero_state(torch.optim.SGD, model, zero_level=0, lr=0.1)
    with pytest.raises(ValueError, match="bucket-interleaved"):
        Z.make_zero_train_step(model, loss_fn, state, zero_level=2,
                               interleaved=False)
    with pytest.raises(ValueError, match="interleaved"):
        Z.init_sharded_opt_state(torch.optim.SGD, model, zero_level=3,
                                 interleaved=False, lr=0.1)
    with pytest.raises(ValueError, match="monolithic"):
        Z.make_zero_train_step(model, loss_fn, state, zero_level=1,
                               interleaved=False, backward_passes_per_step=2)
    with pytest.raises(ValueError, match="wire"):
        Z.make_zero_train_step(model, loss_fn, state, zero_level=1,
                               interleaved=False, wire_policy="int8_ring")
    with pytest.raises(ValueError, match="error feedback"):
        Z.make_zero_train_step(model, loss_fn, state, zero_level=1,
                               interleaved=False, error_feedback=True)
    with pytest.raises(ValueError, match="zero level"):
        Z.make_zero_train_step(model, loss_fn, state, zero_level=7)
    with pytest.raises(ValueError, match="Average"):
        Z.make_zero_train_step(model, loss_fn, state, op=hvd.Sum)
    with pytest.raises(ValueError, match="backward_passes_per_step"):
        Z.make_zero_train_step(model, loss_fn, state,
                               backward_passes_per_step=0)
    step = Z.make_zero_train_step(model, loss_fn, state, zero_level=1,
                                  backward_passes_per_step=2,
                                  fusion_threshold_bytes=THRESH)
    x, y = _batch()
    with pytest.raises(ValueError, match="microbatches"):
        step(x.view(1, 8, 7), y.view(1, 8, 1))


def test_zero_chain_needs_a_process_group():
    hvd.shutdown()
    model, _, _ = _toy()
    with pytest.raises(RuntimeError, match="hvd.init"):
        Z.shard_zero3_params(model)


# ------------------------------------------------------ level-3 gathers
class _Handle:
    def __init__(self, log, j):
        self.log, self.j = log, j

    def wait(self):
        self.log.append(("wait", self.j))


@pytest.mark.parametrize("nb", [1, 3, 6])
@pytest.mark.parametrize("depth", [1, 2, 4, 8])
def test_gather_window_order(nb, depth):
    """Gathers are issued in plan order with ``depth`` ahead of the bucket
    being unpacked; a bucket is unpacked only after its handle's wait, and
    its buffer is dropped before the next wait."""
    log = []
    live = set()

    def ag(j):
        log.append(("issue", j))
        live.add(j)
        return _Handle(log, j), torch.full((4,), float(j))

    def unpack(j, buf):
        log.append(("unpack", j))
        assert buf[0].item() == j
        live.discard(j)

    Z._gather_buckets(nb, depth, ag, unpack)
    issues = [j for kind, j in log if kind == "issue"]
    assert issues == list(range(nb))
    for j in range(nb):
        assert log.index(("wait", j)) < log.index(("unpack", j))
        assert log.index(("issue", j)) < log.index(("wait", j))
        if j + 1 < nb:
            assert log.index(("unpack", j)) < log.index(("wait", j + 1))
        # at most depth + 1 gathers issued and not yet unpacked
        before = log[:log.index(("unpack", j))]
        in_flight = ({i for k, i in before if k == "issue"}
                     - {i for k, i in before if k == "unpack"})
        assert len(in_flight) <= depth + 1
    assert not live


# ---------------------------------------------------- one-rank equivalence
def _tiny_run(level, k, opt_kw):
    cfg = llama.CONFIGS["tiny"]
    model = llama.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    state = Z.init_zero_state(torch.optim.AdamW, model, zero_level=level,
                              fusion_threshold_bytes=4096, **opt_kw)
    step = Z.make_zero_train_step(
        model, lambda m, ids: llama.loss_fn(m, ids), state, zero_level=level,
        backward_passes_per_step=k, fusion_threshold_bytes=4096)
    rng = np.random.RandomState(0)
    losses = []
    for _ in range(3):
        ids = torch.from_numpy(rng.randint(0, cfg.vocab, (4, 17)))
        losses.append(float(step(ids if k == 1 else ids.view(k, 4 // k, 17))))
    params = (Z.gather_zero3_params(state.shards, model,
                                    fusion_threshold_bytes=4096)
              if level == 3 else [p.detach() for p in model.parameters()])
    return losses, params


@pytest.mark.parametrize("k", [1, 2])
def test_one_rank_levels_bitwise_equal(rt, k):
    kw = dict(lr=1e-2, weight_decay=0.01)
    ref_l, ref_p = _tiny_run(1, k, kw)
    for level in (2, 3):
        losses, params = _tiny_run(level, k, kw)
        assert losses == ref_l
        assert all(torch.equal(a, b) for a, b in zip(params, ref_p))


def test_one_rank_matches_distributed_optimizer(rt):
    """At one rank the chain's reduce-scatter is a copy: level 1 lands the
    data-parallel step's parameters."""
    kw = dict(lr=1e-2, weight_decay=0.01)
    z_l, z_p = _tiny_run(1, 1, kw)
    cfg = llama.CONFIGS["tiny"]
    model = llama.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    opt = hvd.DistributedOptimizer(torch.optim.AdamW(model.parameters(), **kw),
                                   named_parameters=model.named_parameters())
    step = hvd.make_train_step(model, lambda m, ids: llama.loss_fn(m, ids), opt)
    rng = np.random.RandomState(0)
    losses = [float(step(torch.from_numpy(rng.randint(0, cfg.vocab, (4, 17)))))
              for _ in range(3)]
    np.testing.assert_allclose(z_l, losses, rtol=1e-6)
    for a, b in zip(z_p, model.parameters()):
        np.testing.assert_allclose(a.numpy(), b.detach().numpy(), rtol=1e-6,
                                   atol=1e-7)
