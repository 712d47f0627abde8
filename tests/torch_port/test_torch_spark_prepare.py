"""``horovod_tpu_torch.spark.prepare`` against ``horovod_tpu.spark.prepare``:
for each of ``prepare_data``'s input shapes (a column dict, a pandas frame,
a stream of column-dict chunks, and a DataFrame with ``.rdd``, the
``pyspark_fake`` of ``tests/test_spark_prepare.py``, whose partitions each
write from a process of their own), the port's train and val datasets hold
the same rows in the same order as the JAX package's, with no validation,
a validation fraction and a validation column; the port keeps
``extra_cols`` and names a missing column in its error.  Host code only."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import sys  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from horovod_tpu.spark import prepare as JP  # noqa: E402
from horovod_tpu.spark import store as JS  # noqa: E402
from horovod_tpu_torch.spark import prepare as P  # noqa: E402
from horovod_tpu_torch.spark import FilesystemStore, prepare_data  # noqa: E402

FAKES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "fakes")


def _purge(prefix):
    for m in list(sys.modules):
        if m == prefix or m.startswith(prefix + "."):
            del sys.modules[m]


@pytest.fixture()
def pyspark_fake(monkeypatch):
    """``tests/fakes/pyspark`` on the path (its DataFrame has ``.rdd`` and
    no ``toPandas``), taken off again after the test."""
    monkeypatch.syspath_prepend(FAKES)
    _purge("pyspark")
    yield
    _purge("pyspark")


def _data(n=60, seed=0):
    rng = np.random.RandomState(seed)
    return {"features": rng.randn(n, 3),
            "label": rng.randn(n, 1),
            "wt": rng.rand(n),
            "is_val": (np.arange(n) % 4 == 0),
            "unused": np.arange(n, dtype=np.int64)}


def _both(tmp_path, make_input, validation, **kw):
    """prepare_data of each package on its own Store: (port, jax) pairs of
    (train columns, val columns or None)."""
    out = []
    for name, prep, store_cls in (("port", prepare_data, FilesystemStore),
                                  ("jax", JP.prepare_data,
                                   JS.FilesystemStore)):
        store = store_cls(str(tmp_path / name))
        train, val = prep(store, make_input(), ["features"], ["label"],
                          validation=validation, **kw)
        out.append((store.read_parquet(train),
                    None if val is None else store.read_parquet(val)))
    return out


def _assert_same(got, want):
    if want is None:
        assert got is None
        return
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _pandas():
    import pandas as pd
    d = _data()
    return pd.DataFrame({"features": list(d["features"]),
                         "label": list(d["label"]), "wt": d["wt"],
                         "is_val": d["is_val"], "unused": d["unused"]})


def _chunks():
    for i in range(3):
        yield _data(n=20, seed=10 + i)


def _rows():
    d = _data(n=48)
    return [{k: (v[i].tolist() if np.ndim(v[i]) else v[i].item())
             for k, v in d.items()} for i in range(48)]


INPUTS = {"dict": _data, "pandas": _pandas, "chunks": _chunks}
VALIDATIONS = [None, 0.25, "is_val"]


@pytest.mark.parametrize("validation", VALIDATIONS)
@pytest.mark.parametrize("shape", sorted(INPUTS))
def test_prepare_writes_the_jax_rows(tmp_path, shape, validation):
    (pt, pv), (jt, jv) = _both(tmp_path, INPUTS[shape], validation,
                               seed=7, extra_cols=("wt",))
    _assert_same(pt, jt)
    _assert_same(pv, jv)
    if validation:
        assert pv is not None and len(pv["label"]) > 0
    if validation == "is_val":  # the marking column leaves both splits
        assert "is_val" not in pt and "is_val" not in pv
    assert "wt" in pt  # extra_cols kept


def test_prepare_dataframe_partitions_write_the_jax_rows(tmp_path,
                                                        pyspark_fake):
    """Each of the fake's partitions writes from a process of its own (six
    processes over the two packages: about 12 s here)."""
    validation = 0.25
    import pyspark

    def df():
        return pyspark.DataFrame(_rows(), numSlices=3)
    assert not hasattr(df(), "toPandas")
    (pt, pv), (jt, jv) = _both(tmp_path, df, validation, seed=3,
                               chunk_rows=7, extra_cols=("wt",))
    _assert_same(pt, jt)
    _assert_same(pv, jv)
    parts = sorted(os.listdir(tmp_path / "port" /
                              "intermediate_train_data.run0"))
    # three partitions, each its own part namespace
    assert {int(p.split("-")[1].split(".")[0]) >> 20 for p in parts} == \
        {0, 1, 2}
    # the selected columns only, every row in one split or the other
    assert sorted(pt) == sorted(["features", "label", "wt"])
    assert len(pt["label"]) + len(pv["label"]) == 48


def test_split_validation_matches_jax():
    cols = _data(n=100)
    for validation, seed in ((0.3, 5), ("is_val", 0), (None, 0)):
        got = P._split_validation(cols, validation, seed=seed)
        want = JP._split_validation(cols, validation, seed=seed)
        for g, w in zip(got, want):
            _assert_same(g, w)
    with pytest.raises(ValueError, match="not in"):
        P._split_validation(cols, "nope")
    with pytest.raises(ValueError, match=r"in \(0,1\)"):
        P._split_validation(cols, 1.5)


def test_partition_writer_seeds_match_jax(tmp_path):
    """The partition task in process: its seed per (partition, chunk),
    reduced to 32 bits, draws the JAX task's masks."""
    rows = _rows()
    out = []
    for name, mod, cls in (("port", P, FilesystemStore),
                           ("jax", JP, JS.FilesystemStore)):
        store = cls(str(tmp_path / name))
        task = mod._PartitionWriter(store, str(tmp_path / name / "t"),
                                    str(tmp_path / name / "v"),
                                    ["features", "label"], 0.5,
                                    seed=2**32 - 3, chunk_rows=5)
        assert list(task(4500, iter(rows))) == list(task(4500, iter(rows)))
        out.append([store.read_parquet(str(tmp_path / name / s))
                    for s in "tv"])
    for g, w in zip(*out):
        _assert_same(g, w)


def test_missing_columns_are_named(tmp_path):
    store = FilesystemStore(str(tmp_path))
    d = _data()
    del d["wt"]
    with pytest.raises(ValueError, match=r"\['wt'\]"):
        prepare_data(store, d, ["features"], ["label"], extra_cols=("wt",))
    with pytest.raises(ValueError, match=r"\['wt'\]"):
        prepare_data(store, iter([d]), ["features"], ["label"],
                     extra_cols=("wt",))
    with pytest.raises(ValueError, match="0 train rows"):
        prepare_data(store, iter([]), ["features"], ["label"])


def test_chunk_stream_writes_one_part_a_chunk(tmp_path):
    store = FilesystemStore(str(tmp_path))
    train, val = prepare_data(store, _chunks(), ["features"], ["label"])
    assert val is None
    assert len([f for f in os.listdir(train) if f.endswith(".parquet")]) \
        == 3
    data = store.read_parquet(train)
    assert sorted(data) == ["features", "label"]
    assert data["features"].shape == (60, 3)
