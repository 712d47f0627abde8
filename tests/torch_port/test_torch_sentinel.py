"""The port's training sentinel against the JAX package's: ``sentinel_stats``
on seeded numpy gradients with NaN and inf at chosen positions
(``grad_norm`` within 1e-6 relative, ``nonfinite`` exact), ``record``'s
rows, EMA and divergence over the same losses, the nonfinite chain (the
counter, the step gauge, one ``.nan`` flight dump a step), ``wrap`` as a
drop-in with its kill switch, the reduction over a process group, and the
deferred delivery's ordering (each step recorded against its own number,
the oldest waited on only past ``MAX_PENDING``)."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import math  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from horovod_tpu.utils import metrics as JM  # noqa: E402
from horovod_tpu.watch import sentinel as JS  # noqa: E402
import horovod_tpu_torch as hvd  # noqa: E402
from horovod_tpu_torch import postmortem as TPM  # noqa: E402
from horovod_tpu_torch.common import basics as TB  # noqa: E402
from horovod_tpu_torch.utils import metrics as TM  # noqa: E402
from horovod_tpu_torch.watch import sentinel as TS  # noqa: E402

SHAPES = [(7,), (3, 5), (2, 2, 4), (1,), (16, 8)]


@pytest.fixture
def fresh():
    TS.reset()
    JS.reset()
    yield
    TS.reset()
    JS.reset()


def _grads(seed, bad):
    """Seeded float32 leaves; ``bad`` is [(leaf, flat index, value)]."""
    rng = np.random.RandomState(seed)
    leaves = [rng.randn(*s).astype(np.float32) * 10 ** rng.uniform(-3, 2)
              for s in SHAPES]
    for leaf, idx, val in bad:
        leaves[leaf].reshape(-1)[idx] = val
    return leaves


_CASES = {
    "finite": [],
    "one-nan": [(1, 4, np.nan)],
    "inf-and-nan": [(0, 0, np.inf), (4, 77, -np.inf), (2, 3, np.nan)],
    "all-bad-leaf": [(3, 0, np.nan)],
    "many": [(4, i, np.nan) for i in range(0, 128, 9)],
}


@pytest.mark.parametrize("case", sorted(_CASES))
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("loss", [1.25, float("nan")])
def test_sentinel_stats_match_jax(fresh, case, seed, loss):
    import jax.numpy as jnp
    leaves = _grads(seed, _CASES[case])
    want = JS.sentinel_stats(jnp.float32(loss),
                             [jnp.asarray(g) for g in leaves])
    got = TS.sentinel_stats(torch.tensor(loss),
                            [torch.from_numpy(g) for g in leaves])
    assert float(got["nonfinite"]) == float(want["nonfinite"])
    g, w = float(got["grad_norm"]), float(want["grad_norm"])
    assert math.isclose(g, w, rel_tol=1e-6), (g, w)
    lg, lw = float(got["loss"]), float(want["loss"])
    assert lg == lw or (math.isnan(lg) and math.isnan(lw))


@pytest.mark.parametrize("run", [1, 20, 1 << 28])
def test_sentinel_stats_in_runs_of_mixed_dtypes_match_jax(fresh, monkeypatch,
                                                          run):
    """Leaves of three dtypes, cut into runs of at most ``run`` elements
    (a larger leaf alone): the same scalars as the JAX sentinel on the
    same values."""
    import jax.numpy as jnp
    monkeypatch.setattr(TS, "RUN_ELEMENTS", run)
    leaves = _grads(4, _CASES["inf-and-nan"])
    dtypes = [torch.float32, torch.bfloat16, torch.float64, torch.float32,
              torch.bfloat16]
    tleaves = [torch.from_numpy(g).to(d) for g, d in zip(leaves, dtypes)]
    assert sum(1 for _ in TS._runs(tleaves)) == {1: 5, 20: 4}.get(run, 3)
    want = JS.sentinel_stats(jnp.float32(0.5), [
        jnp.asarray(t.float().numpy()) for t in tleaves])
    got = TS.sentinel_stats(torch.tensor(0.5), tleaves)
    assert float(got["nonfinite"]) == float(want["nonfinite"]) == 3.0
    assert math.isclose(float(got["grad_norm"]), float(want["grad_norm"]),
                        rel_tol=1e-6)


@pytest.mark.parametrize("grads", ["none", "dict", "nested"])
def test_sentinel_stats_take_any_gradient_tree(fresh, grads):
    import jax.numpy as jnp
    leaves = _grads(5, _CASES["one-nan"])
    tree = {"none": None,
            "dict": {f"p{i}": g for i, g in enumerate(leaves)},
            "nested": [leaves[:2], (leaves[2], {"x": leaves[3]}),
                       leaves[4]]}[grads]

    def conv(t, f):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: conv(v, f) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(conv(v, f) for v in t)
        return f(t)
    got = TS.sentinel_stats(torch.tensor(2.0), conv(tree, torch.from_numpy))
    want = JS.sentinel_stats(jnp.float32(2.0), conv(tree, jnp.asarray))
    assert float(got["nonfinite"]) == float(want["nonfinite"])
    assert math.isclose(float(got["grad_norm"]), float(want["grad_norm"]),
                        rel_tol=1e-6)


def _losses():
    rng = np.random.RandomState(7)
    out = list(3.0 - 0.05 * np.arange(20) + 0.1 * rng.randn(20))
    out[12] = float("nan")
    out[15] = 9.0  # a spike the EMA lags
    return [float(x) for x in out]


@pytest.mark.parametrize("interval", ["1", "3"])
def test_record_rows_match_jax(fresh, monkeypatch, interval):
    monkeypatch.setenv("HOROVOD_SENTINEL_INTERVAL", interval)
    for i, loss in enumerate(_losses()):
        stats = {"loss": loss, "grad_norm": 1.5 + i,
                 "nonfinite": float(i == 12)}
        got, want = TS.record(dict(stats)), JS.record(dict(stats))
        assert set(got) == set(want)
        for k in got:
            a, b = got[k], want[k]
            assert a == b or (math.isnan(a) and math.isnan(b)), (i, k, a, b)
    assert TS._state.ema == JS._state.ema
    assert TM.SENTINEL_LOSS_EMA.value() == JM.SENTINEL_LOSS_EMA.value()
    assert TM.SENTINEL_LAST_NONFINITE_STEP.value() == 12


def test_nonfinite_chain_counts_once_and_dumps(fresh, monkeypatch,
                                               tmp_path):
    path = tmp_path / "flight.rank.0"
    monkeypatch.setenv("HOROVOD_FLIGHT_RECORD", str(path))
    hub = TB.LoopbackHub(1)
    core = TB.CoordinationCore.loopback(hub, rank=0)
    try:
        before = TM.SENTINEL_NONFINITE.value()
        for _ in range(2):  # one verdict per step
            row = TS.record({"loss": float("nan"), "grad_norm": 1.0,
                             "nonfinite": 3.0}, step=7, core=core)
        assert row["step"] == 7
        assert TM.SENTINEL_NONFINITE.value() == before + 1
        assert TM.SENTINEL_LAST_NONFINITE_STEP.value() == 7
        assert TS._state.dump_paths == [f"{path}.nan"]
        fr = TPM.parse_flight_record(f"{path}.nan")
        assert fr["reason"] == "explicit:nan step=7" and fr["complete"]
        # without a path or a core there is nothing to dump
        monkeypatch.setenv("HOROVOD_FLIGHT_RECORD", "")
        assert TS._flight_dump(8, core=core) is None
    finally:
        core.shutdown()
        core.close()
        hub.close()
    assert TS._flight_dump(9) is None


def test_wrap_is_a_drop_in_with_a_kill_switch(fresh, monkeypatch):
    def step(x):
        x = x.clone().requires_grad_(True)
        loss = (x ** 2).sum()
        loss.backward()
        return loss.detach(), x.grad

    monkeypatch.setenv("HOROVOD_SENTINEL", "0")
    assert TS.wrap(step) is step
    monkeypatch.setenv("HOROVOD_SENTINEL", "1")
    wrapped = TS.wrap(step)
    before = TM.SENTINEL_NONFINITE.value()
    for i in range(4):
        x = torch.full((4,), float("nan") if i == 2 else 1.0)
        loss, grads = wrapped(x)
        ref = step(x)
        assert torch.equal(loss, ref[0]) or (torch.isnan(loss) and
                                             torch.isnan(ref[0]))
    assert TM.SENTINEL_NONFINITE.value() == before + 1
    assert TM.SENTINEL_LAST_NONFINITE_STEP.value() == 2
    assert TM.SENTINEL_GRAD_NORM.value() == 4.0  # |2 * ones(4)|
    assert TS._state.step == 4
    # a bare loss, a custom extract
    TS.wrap(lambda x: (x ** 2).sum())(torch.ones(3))
    TS.wrap(lambda x: {"l": x.sum(), "g": [x]},
            extract=lambda o: (o["l"], o["g"]))(torch.ones(3))
    assert TS._state.step == 6


def test_wrap_reduces_over_the_group(fresh):
    """With a group (here the one-rank world of a CPU runtime) the packed
    scalars take one all_reduce, the loss averaged over the group."""
    hvd.init(device="cpu")
    try:
        g = [torch.full((4,), 2.0), torch.tensor([float("inf")])]
        for axis in ("hvd", torch.distributed.group.WORLD):
            packed = TS.packed_stats(torch.tensor(3.0), g, axis_name=axis)
            assert packed.tolist() == [16.0, 1.0, 3.0]
        wrapped = TS.wrap(lambda: (torch.tensor(3.0), g), axis_name="hvd")
        wrapped()
        assert TM.SENTINEL_LOSS.value() == 3.0
    finally:
        hvd.shutdown()


class _Engine:
    """Stands in for the negotiated engine: records what is submitted and
    hands back the op's input as its sum (one rank)."""
    core = object()

    def __init__(self):
        self.ops = []

    def submit(self, op):
        self.ops.append((op.name, op.kind, op.sig))
        return op

    def wait(self, op):
        return op.tensors[0].clone()


def test_reduction_is_negotiated_while_the_engine_is_up(fresh):
    """Once the eager engine exists its collectives run when each rank
    pumps: the sentinel's sum is then submitted to it under one name, and
    a group of its own is refused."""
    rt = hvd.init(device="cpu")
    try:
        g = [torch.full((4,), 2.0), torch.tensor([float("nan")])]
        rt.eager = eng = _Engine()
        for _ in range(2):
            packed = TS.packed_stats(torch.tensor(3.0), g, axis_name="hvd")
            assert packed.tolist() == [16.0, 1.0, 3.0]
        assert eng.ops == [(TS.REDUCE_NAME, "allreduce",
                            "f32:3:allreduce:1")] * 2
        own = torch.distributed.new_group([0])
        with pytest.raises(ValueError, match="axis_name='hvd'"):
            TS.packed_stats(torch.tensor(3.0), g, axis_name=own)
        rt.eager = None
        assert TS.packed_stats(torch.tensor(3.0), g,
                               axis_name=own).tolist() == [16.0, 1.0, 3.0]
    finally:
        rt.eager = None
        hvd.shutdown()


class _Event:
    def __init__(self, log, done):
        self.log, self.done = log, done

    def query(self):
        return self.done

    def synchronize(self):
        self.log.append("sync")
        self.done = True


def test_deferred_delivery_keeps_step_order(fresh):
    """Pending steps are recorded oldest first once their events
    complete; past MAX_PENDING the oldest is waited on; drain records the
    rest; every step keeps its own number."""
    log = []
    events = []
    for i in range(TS.MAX_PENDING + 2):
        ev = _Event(log, done=False)
        events.append(ev)
        TS._state.pending.append(
            (torch.tensor([4.0, float(i == 1), 2.0 + i]), ev))
        TS._drain(block=False)
    # one beyond MAX_PENDING each time: the two oldest were waited on
    assert log == ["sync", "sync"] and TS._state.step == 2
    assert TM.SENTINEL_LAST_NONFINITE_STEP.value() == 1
    events[2].done = True
    TS._drain(block=False)
    assert TS._state.step == 3
    events[4].done = True  # not the oldest: waits behind step 3
    TS._drain(block=False)
    assert TS._state.step == 3
    TS.drain()
    assert TS._state.step == TS.MAX_PENDING + 2 and not TS._state.pending
    assert TM.SENTINEL_LOSS.value() == 2.0 + TS.MAX_PENDING + 1


def test_runtime_shutdown_drains_the_sentinel(fresh):
    hvd.init(device="cpu")
    TS._state.pending.append((torch.tensor([1.0, 0.0, 5.0]),
                              _Event([], done=False)))
    hvd.shutdown()
    assert not TS._state.pending and TS._state.step == 1
