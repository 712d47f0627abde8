"""The ZeRO chain (``horovod_tpu_torch/parallel/zero.py``) on four gloo
ranks against the JAX package's ``make_zero_train_step`` on a four-device
sub-mesh of the eight virtual CPU devices.

One spawned run (``torch_port_zero_worker.py``) records every rank's
results: tests/test_zero.py's toy model over levels {1, 2, 3} x wire
{none, bf16, int8_ring} (error feedback on for the lossy formats) x k {1,
2}, level 3 at ag-prefetch depths 1 and 2, the legacy monolithic level-1
chain, the ``tiny`` Llama at levels 1 and 3 (AdamW, the JAX weights
carried over with ``params_from_jax``), and a level-3 reshard from four
ranks to two.  Here the same inputs go through the JAX chain, called as
tests/test_zero.py calls it.

Tolerances are test_zero's ``_assert_levels_agree``: parameters rtol 1e-5,
atol 1e-6; optimizer state and EF residuals rtol 1e-4, atol 2e-6; the
monolithic anchor rtol 1e-6, atol 1e-7.  AdamW runs at ``eps=1e-3`` (at
1e-8 an entry whose gradient is near zero turns the two frameworks'
summation orders into updates a few percent apart).  Within the port the
levels, the prefetch depths and the ranks are held bitwise equal.  The
toy's leaf order is the JAX plan's, so its shards compare directly; the
Llama's plans differ (module order against sorted keys, ``[out, in]``
against ``[in, out]``), so its parameters and state compare per
parameter.  The JAX references are compiled without excess precision, so
the bf16 wire format rounds on both sides."""

import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch.multiprocessing as tmp
from jax.sharding import Mesh

from horovod_tpu.models import llama as JL
from horovod_tpu.ops import fusion as JF
from horovod_tpu.parallel import zero as JZ
from horovod_tpu.parallel.data_parallel import replicate, shard_batch
from horovod_tpu_torch.models import llama as TL
from horovod_tpu_torch.parallel import zero as TZ

import torch_port_zero_worker as W
from torch_port_ports import hold_ports

STRICT = {"xla_allow_excess_precision": False}
P_TOL = dict(rtol=1e-5, atol=1e-6)
S_TOL = dict(rtol=1e-4, atol=2e-6)
# an EF residual is x - C(x): the two frameworks' x differ by their
# gradients' last bits, which moves the residual by as much in absolute
# terms and can flip a rounding, so it also gets test_torch_wire_gloo.py's
# allowance, one wire ulp of the largest |x| encoded (1e-6 of it for int8)
WIRE_ULP = {"bf16": 2.0 ** -7, "int8_ring": 1e-6}


def _free_port() -> int:
    """A port below the ephemeral range, free when taken (``hold_ports``)."""
    return hold_ports(1).release()[0]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out_dir = str(tmp_path_factory.mktemp("zero"))
    tree = jax.tree_util.tree_map(np.asarray, _tiny_params())
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


def _tiny_params():
    return JL.init(jax.random.PRNGKey(0), JL.CONFIGS["tiny"])


def _mesh():
    return Mesh(np.array(jax.devices()[:W.SIZE]), ("hvd",))


class _Strict:
    """``jax.jit`` whose first call compiles without excess precision."""

    def __init__(self, fn, **kw):
        self.jitted, self.compiled = _REAL_JIT(fn, **kw), None

    def __call__(self, *args):
        if self.compiled is None:
            self.compiled = self.jitted.lower(*args).compile(STRICT)
        return self.compiled(*args)


_REAL_JIT = jax.jit


def _opt(lr=W.LR):
    return optax.adamw(lr, eps=W.EPS, weight_decay=W.WD)


def _jax_chain(monkeypatch, params, loss_fn, batches, level, wire, ef, k,
               thresh, ag_prefetch=None, interleaved=True, lr=W.LR):
    """``len(batches)`` steps of the JAX chain; (params, state, losses) as
    numpy (level 3's params gathered)."""
    mesh = _mesh()
    opt = _opt(lr)
    with monkeypatch.context() as m:
        m.setattr(jax, "jit", _Strict)
        if interleaved:
            step = JZ.make_zero_train_step(
                loss_fn, opt, mesh, zero_level=level, wire_policy=wire,
                error_feedback=ef, backward_passes_per_step=k,
                fusion_threshold_bytes=thresh, params_template=params,
                ag_prefetch=ag_prefetch, donate=False)
        else:
            step = JZ.make_zero1_train_step(loss_fn, opt, mesh, donate=False)
    if interleaved:
        s = JZ.init_zero_state(opt, replicate(params, mesh), mesh,
                               zero_level=level, wire_policy=wire,
                               error_feedback=ef,
                               fusion_threshold_bytes=thresh)
    else:
        s = JZ.init_sharded_opt_state(opt, replicate(params, mesh), mesh)
    p = (JZ.shard_zero3_params(replicate(params, mesh), mesh,
                               fusion_threshold_bytes=thresh)
         if level == 3 else replicate(params, mesh))
    losses = []
    for batch in batches:
        axis = 1 if k > 1 else 0
        sharded = jax.tree_util.tree_map(
            lambda a: shard_batch(jnp.asarray(a), mesh, axis=axis), batch)
        p, s, loss = step(p, s, sharded)
        losses.append(float(loss))
    if level == 3:
        p = JZ.gather_zero3_params(p, params, mesh,
                                   fusion_threshold_bytes=thresh)
    return (jax.tree_util.tree_map(np.asarray, p),
            jax.tree_util.tree_map(np.asarray, s), np.asarray(losses))


def _toy_jax(monkeypatch, level, wire, ef, k, **kw):
    params = {n: jnp.asarray(a) for n, a in W.toy_params().items()}

    def loss_fn(p, batch):
        x, y = batch
        h = jnp.tanh(x @ p["w1"] + p["b1"])
        return jnp.mean((h @ p["w2"] - y) ** 2)
    batches = [(xs if k > 1 else xs[0], ys if k > 1 else ys[0])
               for xs, ys in W.toy_batches(k)]
    return _jax_chain(monkeypatch, params, loss_fn, batches, level, wire, ef,
                      k, W.THRESH, **kw)


def _inner(block):
    """The optax adam state of one bucket's block (EF or not)."""
    inner = block.inner if isinstance(block, JZ._ZeroEFBlock) else block
    return inner[0]


def _assert_bitwise(a, b, tag):
    for key in ("params", "mu", "nu", "losses"):
        for x, y in zip(a[key] if key != "losses" else [a[key]],
                        b[key] if key != "losses" else [b[key]]):
            np.testing.assert_array_equal(x, y, err_msg=f"{tag} {key}")
    assert (a["res"] is None) == (b["res"] is None), tag
    for x, y in zip(a["res"] or [], b["res"] or []):
        np.testing.assert_array_equal(x, y, err_msg=f"{tag} residual")


def _assert_toy_matches_jax(ranks, name, ref, tag, wire="none"):
    ref_p, ref_s, ref_l = ref
    for r in range(W.SIZE):
        got = ranks[r][name]
        for i, key in enumerate(W.toy_params()):
            np.testing.assert_array_equal(got["params"][i],
                                          ranks[0][name]["params"][i])
            np.testing.assert_allclose(got["params"][i], ref_p[key],
                                       err_msg=f"{tag} params {key}",
                                       **P_TOL)
        for bi, block in enumerate(ref_s):
            adam = _inner(block)
            np.testing.assert_allclose(got["mu"][bi], adam.mu[r],
                                       err_msg=f"{tag} mu {bi}", **S_TOL)
            np.testing.assert_allclose(got["nu"][bi], adam.nu[r],
                                       err_msg=f"{tag} nu {bi}", **S_TOL)
            if isinstance(block, JZ._ZeroEFBlock):
                np.testing.assert_allclose(
                    got["res"][bi], block.residual[r], rtol=S_TOL["rtol"],
                    atol=S_TOL["atol"] + WIRE_ULP[wire] * got["xmax"],
                    err_msg=f"{tag} res {bi}")
            else:
                assert got["res"] is None, tag
        np.testing.assert_allclose(got["losses"], ref_l, rtol=1e-5,
                                   err_msg=f"{tag} losses")


def test_no_case_raised(ranks):
    for r in ranks:
        crashed = {n: v for n, v in r.items() if n.startswith("_")}
        assert not crashed, crashed


@pytest.mark.parametrize("level,wire,ef,k", W.TOY_CASES,
                         ids=[W.case_name(*c) for c in W.TOY_CASES])
def test_toy_chain_matches_jax(ranks, monkeypatch, level, wire, ef, k):
    name = W.case_name(level, wire, ef, k)
    ref = _toy_jax(monkeypatch, level, wire, ef, k)
    _assert_toy_matches_jax(ranks, name, ref, name, wire)
    if ef:  # the residual rides the bucket, full length, nonzero
        res = ranks[0][name]["res"]
        assert [len(x) for x in res] == [len(m) * W.SIZE
                                         for m in ranks[0][name]["mu"]]
        assert any(np.abs(x).sum() > 0 for x in res)


@pytest.mark.parametrize("wire,ef", W.WIRES, ids=[w for w, _ in W.WIRES])
@pytest.mark.parametrize("k", [1, 2])
def test_levels_bitwise_equal_within_the_port(ranks, wire, ef, k):
    for r in range(W.SIZE):
        ref = ranks[r][W.case_name(1, wire, ef, k)]
        for level in (2, 3):
            _assert_bitwise(ranks[r][W.case_name(level, wire, ef, k)], ref,
                            f"rank {r} level {level} {wire} k={k}")


def test_ag_prefetch_is_scheduling_only(ranks, monkeypatch):
    for r in range(W.SIZE):
        one, two = (ranks[r][f"toy L3 prefetch {d}"] for d in (1, 2))
        _assert_bitwise(two, one, f"rank {r} prefetch 2 vs 1")
        _assert_bitwise(one, ranks[r][W.case_name(3, "none", False, 2)],
                        f"rank {r} prefetch 1 vs the knob's depth")
    ref = _toy_jax(monkeypatch, 3, "none", False, 2, ag_prefetch=1)
    _assert_toy_matches_jax(ranks, "toy L3 prefetch 1", ref, "prefetch 1")


def test_monolithic_anchor(ranks, monkeypatch):
    """The bucketed level-1 chain lands the legacy monolithic chain's
    parameters (test_zero's anchor tolerance), and the monolithic chain
    matches the JAX one, its single shard directly."""
    for r in range(W.SIZE):
        mono = ranks[r]["toy monolithic"]
        inter = ranks[r][W.case_name(1, "none", False, 1)]
        for a, b in zip(inter["params"], mono["params"]):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
        assert len(mono["mu"]) == 1
    ref = _toy_jax(monkeypatch, 1, "none", False, 1, interleaved=False)
    ref_p, ref_s, ref_l = ref
    for r in range(W.SIZE):
        got = ranks[r]["toy monolithic"]
        for i, key in enumerate(W.toy_params()):
            np.testing.assert_allclose(got["params"][i], ref_p[key], **P_TOL)
        np.testing.assert_allclose(got["mu"][0], ref_s[0].mu[r], **S_TOL)
        np.testing.assert_allclose(got["nu"][0], ref_s[0].nu[r], **S_TOL)


def _jax_to_torch_names(tree):
    """A JAX Llama-shaped tree -> {torch parameter name: numpy array}, the
    kernels transposed to ``[out, in]``."""
    out = {"embed.table": tree["embed"]["table"],
           "final_norm.scale": tree["final_norm"]["scale"],
           "lm_head.weight": tree["lm_head"]["kernel"].T}
    for i, lt in enumerate(tree["layers"]):
        for norm in ("attn_norm", "ffn_norm"):
            out[f"layers.{i}.{norm}.scale"] = lt[norm]["scale"]
        for w in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
            out[f"layers.{i}.{w}.weight"] = lt[w]["kernel"].T
    return {k: np.asarray(v) for k, v in out.items()}


def _jax_state_per_param(state, params, field):
    """One adam field of the JAX chain's bucketed state, unpacked per
    parameter into the params tree's structure."""
    leaves, treedef = jax.tree_util.tree_flatten(params)
    plan = JF.make_plan([l.shape for l in leaves],
                        [jnp.float32] * len(leaves), W.LLAMA_THRESH)
    out = [None] * plan.num_leaves
    for bi, b in enumerate(plan.buckets):
        flat = np.asarray(getattr(state[bi][0], field)).reshape(-1)
        JF.unpack_bucket(jnp.asarray(flat[:sum(b.sizes)]), b, out)
    return jax.tree_util.tree_unflatten(treedef, out)


def _port_state_per_param(ranks, name, field):
    """One AdamW field of the port's shards, every rank's shard of a bucket
    joined and unpacked per parameter (module order)."""
    template = list(TL.Llama(TL.CONFIGS["tiny"], "meta").named_parameters())
    leaves = [p for _, p in template]
    plan = TZ._bucket_plan(leaves, W.LLAMA_THRESH)
    out = {}
    for bi, b in enumerate(plan.buckets):
        flat = np.concatenate([ranks[r][name][field][bi]
                               for r in range(W.SIZE)])
        off = 0
        for i, size, shape in zip(b.indices, b.sizes, b.shapes):
            out[template[i][0]] = flat[off:off + size].reshape(shape)
            off += size
    return out


def _names():
    return [n for n, _ in TL.Llama(TL.CONFIGS["tiny"], "meta")
            .named_parameters()]


@pytest.mark.parametrize("level", W.LLAMA_LEVELS)
def test_tiny_llama_matches_jax_per_parameter(ranks, monkeypatch, level):
    cfg = JL.CONFIGS["tiny"]
    params = _tiny_params()
    batches = [jnp.asarray(ids.astype(np.int32))
               for ids in W.llama_batches()]
    ref_p, ref_s, ref_l = _jax_chain(
        monkeypatch, params, lambda p, ids: JL.loss_fn(p, ids, cfg), batches,
        level, "none", False, 1, W.LLAMA_THRESH, lr=W.LLAMA_LR)
    name = f"llama L{level}"
    want_p = _jax_to_torch_names(ref_p)
    names = _names()
    for r in range(W.SIZE):
        got = ranks[r][name]
        for i, n in enumerate(names):
            np.testing.assert_array_equal(got["params"][i],
                                          ranks[0][name]["params"][i])
            np.testing.assert_allclose(got["params"][i], want_p[n],
                                       err_msg=f"{name} {n}", **P_TOL)
        np.testing.assert_allclose(got["losses"], ref_l, rtol=1e-5)
    for field, jfield in (("mu", "mu"), ("nu", "nu")):
        want = _jax_to_torch_names(_jax_state_per_param(ref_s, params,
                                                        jfield))
        got = _port_state_per_param(ranks, name, field)
        for n in names:
            np.testing.assert_allclose(got[n], want[n],
                                       err_msg=f"{name} {field} {n}",
                                       **S_TOL)


def test_tiny_llama_levels_bitwise_equal(ranks):
    for r in range(W.SIZE):
        _assert_bitwise(ranks[r]["llama L3"], ranks[r]["llama L1"],
                        f"rank {r} llama level 3 vs 1")


def test_level3_reshard_to_a_new_world_size(ranks):
    """Gathered at four ranks and sharded again at two, the values survive
    bitwise and the shard lengths follow the new world size."""
    full = [np.asarray(a) for a in W.toy_params().values()]
    for r in range(W.SIZE):
        for a, b in zip(ranks[r]["reshard"]["full4"], full):
            np.testing.assert_array_equal(a, b)
    for r in range(2):
        got = ranks[r]["reshard"]
        for a, b in zip(got["full2"], full):
            np.testing.assert_array_equal(a, b)
        sizes = [a.size for a in full]  # the toy's buckets: one leaf each
        assert got["shard_lens4"].tolist() == [-(-s // 4) for s in sizes]
        assert got["shard_lens2"].tolist() == [-(-s // 2) for s in sizes]
