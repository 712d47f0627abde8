"""The port's fast commit store (``horovod_tpu_torch/elastic/fastcommit.py``)
and ``TreeState``'s durable commits: the cases of the JAX package's
tests/test_elastic.py:68-400 on tensors, and the same numpy trees
committed by the JAX ``FastCommitStore`` and by the port's restoring the
same values.  One process; the world size and the devices a commit
records are the port's layout checks."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from horovod_tpu_torch.elastic import TreeState  # noqa: E402
from horovod_tpu_torch.elastic.fastcommit import (  # noqa: E402
    FastCommitStore, flatten)


def _leaves(tree):
    return flatten(tree)[0]


def test_fastcommit_roundtrip_keeps_values_dtypes_and_meta(tmp_path):
    store = FastCommitStore(str(tmp_path / "fc"))
    tree = {"x": torch.arange(32.0), "w": torch.ones(4, 4) * 2,
            "s": torch.tensor(3.5), "groups": [{"lr": 0.1, "betas":
                                                (0.9, 0.999)}]}
    nbytes = store.save(0, {"params": tree, "opt_state": None},
                        meta={"epoch": 4})
    assert nbytes == 32 * 4 + 16 * 4 + 4
    data = tmp_path / "fc" / "step_0" / "rank_0.bin"
    assert data.stat().st_size == nbytes  # one copy of each tensor
    tmpl = {"x": torch.zeros(32), "w": torch.zeros(4, 4),
            "s": torch.tensor(0.0), "groups": [{"lr": 0.0, "betas":
                                                (0.0, 0.0)}]}
    out = store.restore(0, {"params": tmpl, "opt_state": None})
    assert out is not None and out["opt_state"] is None
    assert torch.equal(out["params"]["x"], torch.arange(32.0))
    assert torch.equal(out["params"]["w"], torch.ones(4, 4) * 2)
    assert float(out["params"]["s"]) == 3.5
    assert out["params"]["groups"] == [{"lr": 0.1, "betas": (0.9, 0.999)}]
    assert out["meta"]["epoch"] == 4
    # new tensors: the templates are untouched until the caller applies
    assert not tmpl["x"].any()


def test_fastcommit_mismatch_marker_and_gc(tmp_path):
    store = FastCommitStore(str(tmp_path / "fc"), max_to_keep=2)
    for step in (0, 1, 2):
        store.save(step, {"params": {"x": torch.arange(32.0)}}, meta={})
    assert sorted(store.steps()) == [1, 2]  # step_0 collected
    assert store.restore(2, {"params": {"x": torch.zeros(16)}}) is None
    assert store.restore(2, {"params": {"x": torch.zeros(32, 1)}}) is None
    assert store.restore(2, {"params": {"y": torch.zeros(32)}}) is None
    assert store.restore(2, {"params": {"x": torch.zeros(32)}}) is not None
    # a crash between data and marker leaves the step invisible
    os.remove(str(tmp_path / "fc" / "step_2" / "COMMIT_0"))
    assert store.latest_step() == 1
    assert store.restore(2, {"params": {"x": torch.zeros(32)}}) is None


def test_fastcommit_step_reuse_invalidates_old_marker(tmp_path):
    store = FastCommitStore(str(tmp_path / "fc"))
    store.save(0, {"params": {"x": torch.zeros(8)}}, meta={"epoch": 1})
    store.save(0, {"params": {"x": torch.ones(8) * 5}}, meta={"epoch": 2})
    out = store.restore(0, {"params": {"x": torch.zeros(8)}})
    assert out is not None
    assert torch.equal(out["params"]["x"], torch.full((8,), 5.0))
    assert out["meta"]["epoch"] == 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.int64,
                                   torch.bfloat16])
def test_fastcommit_0d_leaf_keeps_its_rank(tmp_path, dtype):
    """0-d leaves (AdamW's step counts, loss scales) restore as 0-d, not
    as the one-element row the blob stores them as."""
    store = FastCommitStore(str(tmp_path / "fc"))
    store.save(0, {"opt_state": {"step": torch.tensor(7, dtype=dtype)}},
               meta={})
    out = store.restore(0, {"opt_state": {"step": torch.tensor(
        0, dtype=dtype)}})
    assert out is not None
    got = out["opt_state"]["step"]
    assert got.shape == () and got.dtype == dtype and float(got) == 7


def test_fastcommit_adamw_state_keeps_step_rank_and_device(tmp_path):
    model = torch.nn.Linear(3, 2)
    opt = torch.optim.AdamW(model.parameters(), lr=0.1)
    model(torch.ones(1, 3)).sum().backward()
    opt.step()
    store = FastCommitStore(str(tmp_path / "fc"))
    store.save(0, {"opt_state": opt.state_dict()}, meta={})
    fresh = torch.optim.AdamW(torch.nn.Linear(3, 2).parameters(), lr=0.1)
    from horovod_tpu_torch.functions import create_optimizer_state
    create_optimizer_state(fresh)
    out = store.restore(0, {"opt_state": fresh.state_dict()})
    assert out is not None
    for k, st in out["opt_state"]["state"].items():
        want = opt.state_dict()["state"][k]
        assert st["step"].shape == want["step"].shape == ()
        assert st["step"].device == want["step"].device
        assert torch.equal(st["exp_avg"], want["exp_avg"])


def test_fastcommit_counter_reset_purges_stale_timeline(tmp_path):
    store = FastCommitStore(str(tmp_path / "fc"), max_to_keep=2)
    store.save(5, {"params": {"x": torch.zeros(4)}}, meta={"epoch": 5})
    store.save(6, {"params": {"x": torch.zeros(4)}}, meta={"epoch": 6})
    store.save(0, {"params": {"x": torch.ones(4) * 9}}, meta={"epoch": 0})
    assert store.steps() == [0]  # stale 5/6 purged, 0 survives its GC
    out = store.restore(0, {"params": {"x": torch.zeros(4)}})
    assert torch.equal(out["params"]["x"], torch.full((4,), 9.0))


def test_fastcommit_bf16_roundtrip_is_bytewise(tmp_path):
    x = torch.randn(257, generator=torch.Generator().manual_seed(0)) \
        .to(torch.bfloat16)
    store = FastCommitStore(str(tmp_path / "fc"))
    store.save(0, {"params": {"x": x, "s": torch.tensor(2.5,
                                                       dtype=torch.bfloat16)}})
    out = store.restore(0, {"params": {
        "x": torch.zeros(257, dtype=torch.bfloat16),
        "s": torch.tensor(0.0, dtype=torch.bfloat16)}})
    assert out["params"]["x"].dtype == torch.bfloat16
    assert torch.equal(out["params"]["x"].view(torch.int16),
                       x.view(torch.int16))
    assert float(out["params"]["s"]) == 2.5


def _random_tree(rng, depth=2):
    dtypes = [torch.float32, torch.bfloat16, torch.int32]
    if depth == 0 or rng.rand() < 0.3:
        dt = dtypes[rng.randint(len(dtypes))]
        rank = rng.randint(4)
        shape = () if rank == 0 else tuple(
            [8 * rng.randint(1, 3)] + [rng.randint(0, 4)
                                       for _ in range(rank - 1)])
        vals = np.asarray(rng.randn(*shape)) * 100
        return torch.from_numpy(np.array(vals, dtype=np.float64)).to(dt)
    n = rng.randint(1, 4)
    if rng.rand() < 0.5:
        return {f"k{i}": _random_tree(rng, depth - 1) for i in range(n)}
    return [_random_tree(rng, depth - 1) for _ in range(n)]


@pytest.mark.parametrize("seed", range(8))
def test_fastcommit_random_trees_roundtrip_exact(tmp_path, seed):
    """Random nests of f32/bf16/i32 leaves of rank 0-3, zero-length axes
    included, round-trip bit for bit."""
    tree = _random_tree(np.random.RandomState(seed))
    store = FastCommitStore(str(tmp_path / "fc"))
    store.save(0, {"params": tree}, meta={"seed": seed})
    out = store.restore(0, {"params": _zeros_like_tree(tree)})
    assert out is not None
    for a, b in zip(_leaves(tree), _leaves(out["params"])):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


def _zeros_like_tree(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_zeros_like_tree(v) for v in tree]
    return torch.zeros_like(tree)


def test_fastcommit_dtype_device_and_world_size_changes_are_mismatches(
        tmp_path):
    store = FastCommitStore(str(tmp_path / "fc"))
    store.save(0, {"params": {"x": torch.ones(8)}}, meta={})
    assert store.restore(0, {"params": {"x": torch.ones(
        8, dtype=torch.bfloat16)}}) is None
    # another device kind: the meta device stands in for a card here
    assert store.restore(0, {"params": {"x": torch.ones(
        8, device="meta")}}) is None
    assert store.restore(0, {"params": {"x": torch.zeros(8)}}) is not None
    # a commit written by a two-rank world does not map onto one rank
    two = FastCommitStore(str(tmp_path / "fc2"))
    two._size = 2
    two.save(0, {"params": {"x": torch.ones(8)}}, meta={})
    one = FastCommitStore(str(tmp_path / "fc2"))
    assert one.steps() == [0]
    assert one.restore(0, {"params": {"x": torch.zeros(8)}}) is None


def test_fastcommit_reaps_markerless_crash_leftovers(tmp_path):
    store = FastCommitStore(str(tmp_path / "fc"))
    store.save(7, {"params": {"x": torch.zeros(4)}}, meta={})
    os.remove(str(tmp_path / "fc" / "step_7" / "COMMIT_0"))  # the crash
    assert store.steps() == []
    store.save(0, {"params": {"x": torch.ones(4)}}, meta={})
    assert store.steps() == [0]
    assert not (tmp_path / "fc" / "step_7").exists()  # blob reclaimed


def test_fastcommit_unreadable_blob_is_none_not_an_exception(tmp_path):
    store = FastCommitStore(str(tmp_path / "fc"))
    store.save(0, {"params": {"x": torch.ones(64)}}, meta={})
    with open(tmp_path / "fc" / "step_0" / "rank_0.bin", "r+b") as f:
        f.truncate(16)
    assert store.restore(0, {"params": {"x": torch.zeros(64)}}) is None


# -------------------------------------------------------- TreeState on disk
@pytest.mark.parametrize("fmt", ["fast", "portable"])
def test_tree_state_commit_formats_restore_the_latest(tmp_path, fmt):
    d = str(tmp_path / fmt)
    s = TreeState(params={"w": torch.arange(4.0)}, opt_state=None,
                  sharded_commit_dir=d, commit_format=fmt, epoch=1)
    s.commit()
    s.epoch = 9
    s.commit()  # the latest step must win
    live = torch.zeros(4)
    s2 = TreeState(params={"w": live}, opt_state=None, sharded_commit_dir=d,
                   commit_format=fmt, epoch=0)
    assert s2.load_from_disk()
    assert torch.equal(live, torch.arange(4.0))  # copied into the template
    assert s2.epoch == 9
    assert s2.last_restore["format"] == fmt


def test_tree_state_portable_format_ignores_stale_fast_commits(tmp_path):
    d = str(tmp_path / "mixed")
    TreeState(params={"w": torch.zeros(4)}, sharded_commit_dir=d,
              commit_format="fast", epoch=4).commit()
    TreeState(params={"w": torch.ones(4)}, sharded_commit_dir=d,
              commit_format="portable", epoch=9).commit()
    s3 = TreeState(params={"w": torch.zeros(4)}, sharded_commit_dir=d,
                   commit_format="portable", epoch=0)
    assert s3.load_from_disk()
    assert s3.epoch == 9
    assert torch.equal(s3.params["w"], torch.ones(4))


def test_fast_format_never_falls_back_to_a_stale_portable_commit(tmp_path):
    d = str(tmp_path / "mixed2")
    TreeState(params={"w": torch.zeros(4)}, sharded_commit_dir=d,
              commit_format="portable", epoch=3).commit()
    TreeState(params={"w": torch.ones(4)}, sharded_commit_dir=d,
              commit_format="fast", epoch=50).commit()
    # a template the newest (fast) commit cannot map onto
    s3 = TreeState(params={"w": torch.zeros(8)}, sharded_commit_dir=d,
                   commit_format="fast", epoch=0)
    assert not s3.load_from_disk()
    assert s3.epoch == 0 and s3.last_restore is None


def test_pickle_commit_respects_the_template(tmp_path):
    path = str(tmp_path / "state.pkl")
    TreeState(params={"w": torch.arange(4.0)}, commit_path=path,
              epoch=2).commit()
    s2 = TreeState(params={"w": torch.zeros(8)}, commit_path=path, epoch=0)
    assert not s2.load_from_disk() and s2.epoch == 0
    s3 = TreeState(params={"w": torch.zeros(4, dtype=torch.bfloat16)},
                   commit_path=path, epoch=0)
    assert not s3.load_from_disk()
    s4 = TreeState(params={"w": torch.zeros(4)}, commit_path=path, epoch=0)
    assert s4.load_from_disk() and s4.epoch == 2
    assert torch.equal(s4.params["w"], torch.arange(4.0))
    # no template accepts anything
    s5 = TreeState(params=None, commit_path=path, epoch=0)
    assert s5.load_from_disk() and torch.equal(s5.params["w"],
                                               torch.arange(4.0))


def test_tree_state_module_and_stateless_optimizer(tmp_path):
    """A model and an AdamW that has stepped commit; a fresh model and a
    fresh AdamW (no state yet) restore it in place, the optimizer's state
    created first without moving the parameters; with nothing on disk the
    fresh optimizer stays stateless."""
    torch.manual_seed(0)
    model = torch.nn.Linear(4, 2)
    opt = torch.optim.AdamW(model.parameters(), lr=0.1, weight_decay=0.1)
    model(torch.ones(3, 4)).sum().backward()
    opt.step()
    d = str(tmp_path / "c")
    TreeState(params=model, opt_state=opt, sharded_commit_dir=d,
              epoch=5).commit()
    fresh = torch.nn.Linear(4, 2)
    before = fresh.weight.detach().clone()
    fopt = torch.optim.AdamW(fresh.parameters(), lr=0.1, weight_decay=0.1)
    empty = TreeState(params=fresh, opt_state=fopt,
                      sharded_commit_dir=str(tmp_path / "none"), epoch=0)
    assert not empty.load_from_disk()
    assert not fopt.state and torch.equal(fresh.weight, before)
    s = TreeState(params=fresh, opt_state=fopt, sharded_commit_dir=d,
                  epoch=0)
    assert s.load_from_disk() and s.epoch == 5
    assert torch.equal(fresh.weight, model.weight)
    want, got = opt.state_dict(), fopt.state_dict()
    assert got["param_groups"] == want["param_groups"]
    for k in want["state"]:
        for key, v in want["state"][k].items():
            assert torch.equal(got["state"][k][key], v), key
    assert got["state"][0]["step"].shape == ()


# ------------------------------------------------ against the JAX store
def _numpy_trees(seed):
    rng = np.random.RandomState(seed)
    return {"a": rng.randn(8, 3).astype(np.float32),
            "b": [rng.randint(-5, 5, (4,)).astype(np.int32),
                  np.float32(rng.randn())],
            "c": {"h": rng.randn(2, 2, 2).astype(np.float16),
                  "z": np.zeros((0, 3), np.float32)}}


@pytest.mark.parametrize("seed", [0, 1])
def test_jax_and_port_stores_restore_the_same_values(tmp_path, seed):
    from horovod_tpu.elastic.fastcommit import FastCommitStore as JStore
    tree = _numpy_trees(seed)
    jstore = JStore(str(tmp_path / "jax"))
    jstore.save(0, {"params": tree}, meta={"seed": seed})
    jtmpl = {"a": np.zeros((8, 3), np.float32),
             "b": [np.zeros(4, np.int32), np.float32(0)],
             "c": {"h": np.zeros((2, 2, 2), np.float16),
                   "z": np.zeros((0, 3), np.float32)}}
    jout = jstore.restore(0, {"params": jtmpl})
    ttree = {"a": torch.from_numpy(tree["a"]),
             "b": [torch.from_numpy(tree["b"][0]),
                   torch.tensor(tree["b"][1])],
             "c": {"h": torch.from_numpy(tree["c"]["h"]),
                   "z": torch.from_numpy(tree["c"]["z"])}}
    tstore = FastCommitStore(str(tmp_path / "port"))
    tstore.save(0, {"params": ttree}, meta={"seed": seed})
    tout = tstore.restore(0, {"params": _zeros_like_tree(ttree)})
    assert tout["meta"] == jout["meta"] == {"seed": seed}
    import jax
    jleaves = jax.tree_util.tree_leaves(jout["params"])
    tleaves = _leaves(tout["params"])
    assert len(jleaves) == len(tleaves)
    for j, t in zip(jleaves, tleaves):
        j = np.asarray(j)
        assert j.shape == tuple(t.shape) and j.dtype == t.numpy().dtype
        np.testing.assert_array_equal(j, t.numpy())
