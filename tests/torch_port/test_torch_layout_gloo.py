"""The 3D layout plane (``horovod_tpu_torch/parallel/layout.py``) on four
gloo ranks against the JAX package's ``make_llama_layout_train_step`` on
``jax.devices()[:4]`` reshaped to the same (dp, tp, pp).

One spawned run (``torch_port_layout_worker.py``) records every rank's
results: the runtime's layout from ``HOROVOD_LAYOUT=2,2,1``; 3 steps of the
``tiny`` Llama (8 rows of 16 tokens, ``n_micro=2``, Adam at lr 1e-2) at
(4,1,1), (2,2,1), (2,1,2) and (1,2,2) at level 1, (1,2,2) at levels 2 and 3,
(4,1,1) at level 3, (2,2,1) at k=2, and ``int8_ring`` with error feedback
at (1,2,2) levels 1-3 and (2,2,1) levels 1 and 3; and the generic toy at
level 2 on (2,2,1) and (2,1,2).  The JAX weights are carried over with
``layout_params_from_jax``.

Tolerances are tests/test_layout.py's: losses within 2e-5 absolute,
parameters within 1e-4 (the exact wire) or 5e-3 (``int8_ring``, its
``test_composed_lossy_wire_levels_agree``; losses too), the toy within
1e-5.  Adam runs
at ``eps=1e-3``: at 1e-8 an entry whose gradient is near zero turns two
summation orders into updates a few percent apart (1 of 16,384 elements
of test_layout's own (2,2,2) comparison).  JAX's levels are equivalent by
its own tests, so the port's levels 2 and 3 meet JAX's level 1.  Within the
port the levels of a layout are bitwise equal, parameters are bitwise
equal on every rank, and every layout meets (4,1,1) level 1 within the
same tolerances.  Parameters compare per parameter: the port's weights are
``[out, in]`` and its modules hold one layer each, so its bucket plans
differ from the JAX package's."""

import os
import socket
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch.multiprocessing as tmp
from jax.sharding import Mesh

from horovod_tpu.models import llama as JL
from horovod_tpu.parallel import layout as JLay
from horovod_tpu_torch.models import llama as TL

import torch_port_layout_worker as W

LOSS_ATOL, PARAM_ATOL, LOSSY_ATOL, TOY_ATOL = 2e-5, 1e-4, 5e-3, 1e-5


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out_dir = str(tmp_path_factory.mktemp("layout"))
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


def _mesh(dims):
    return Mesh(np.array(jax.devices()[:W.SIZE]).reshape(dims),
                ("dp", "tp", "pp"))


def _to_torch_names(stacked):
    """The JAX stacked layout tree -> ``[numpy array]`` in ``llama.Llama``'s
    parameter order, stage leaves unstacked, kernels ``[out, in]``."""
    flat = {"embed.table": stacked["embed"]["table"],
            "final_norm.scale": stacked["final_norm"]["scale"],
            "lm_head.weight": np.asarray(stacked["lm_head"]["kernel"]).T}
    for name, sub in stacked["stages"].items():
        for leaf, a in sub.items():
            a = np.asarray(a)
            a = a.reshape((-1,) + a.shape[2:])
            for layer in range(a.shape[0]):
                v = a[layer].T if leaf == "kernel" else a[layer]
                pname = "weight" if leaf == "kernel" else leaf
                flat[f"layers.{layer}.{name}.{pname}"] = v
    names = [n for n, _ in TL.Llama(TL.CONFIGS["tiny"], "meta")
             .named_parameters()]
    return [np.asarray(flat[n]) for n in names]


def _jax_run(dims, level, wire, ef, k):
    """``W.STEPS`` steps of the JAX composed chain: (losses, params in the
    port's order)."""
    cfg = JL.CONFIGS["tiny"]
    mesh = _mesh(dims)
    stacked = JLay.llama_layout_params(_tiny_params(), dims[2])
    specs = JLay.llama_layout_specs(stacked)
    opt = optax.adam(W.LR, eps=W.EPS)
    st = JLay.init_layout_state(opt, stacked, specs, mesh, zero_level=level,
                                wire_policy=wire, error_feedback=ef)
    step = JLay.make_llama_layout_train_step(
        cfg, opt, mesh, n_micro=W.N_MICRO, zero_level=level,
        wire_policy=wire, error_feedback=ef, backward_passes_per_step=k,
        donate=False)
    p = (JLay.shard_layout_params(stacked, specs, mesh) if level == 3
         else stacked)
    losses = []
    for ids in W.llama_batches(k):
        p, st, loss = step(p, st, jnp.asarray(
            (ids if k > 1 else ids[0]).astype(np.int32)))
        losses.append(float(loss))
    if level == 3:
        p = JLay.gather_layout_params(p, stacked, specs, mesh)
    return np.asarray(losses), _to_torch_names(p)


def _assert_close(got, want, atol, tag, loss_atol=LOSS_ATOL):
    np.testing.assert_allclose(got["losses"], want[0], rtol=0,
                               atol=loss_atol, err_msg=f"{tag} losses")
    for a, b in zip(got["params"], want[1]):
        np.testing.assert_allclose(a, b, rtol=0, atol=atol,
                                   err_msg=f"{tag} params")


def _assert_bitwise(a, b, tag):
    np.testing.assert_array_equal(a["losses"], b["losses"], err_msg=tag)
    for x, y in zip(a["params"], b["params"]):
        np.testing.assert_array_equal(x, y, err_msg=tag)


def test_no_case_raised(ranks):
    for r in ranks:
        crashed = {n: v for n, v in r.items() if n.startswith("_")}
        assert not crashed, crashed


def test_runtime_resolves_the_layout_at_init(ranks):
    """HOROVOD_LAYOUT=2,2,1: rank (i*tp + j)*pp + k is coordinate (i, j,
    k), with its dp, tp and pp groups' members in axis order."""
    for r, out in enumerate(ranks):
        init = out["init"]
        assert init["dims"].tolist() == list(W.INIT_LAYOUT)
        i, j = r // 2, r % 2
        assert init["coord"].tolist() == [i, j, 0]
        assert init["ranks"]["dp"].tolist() == [j, 2 + j]
        assert init["ranks"]["tp"].tolist() == [2 * i, 2 * i + 1]
        assert init["ranks"]["pp"].tolist() == [r]


@pytest.mark.parametrize("dims", [(4, 1, 1), (2, 2, 1), (2, 1, 2),
                                  (1, 2, 2)], ids=str)
def test_composed_step_matches_jax(ranks, dims):
    want = _jax_run(dims, 1, "none", None, 1)
    for level in (1, 2, 3):
        name = W.case_name(dims, level, "none", False, 1)
        if name not in ranks[0]:
            continue
        for r in range(W.SIZE):
            _assert_close(ranks[r][name], want, PARAM_ATOL,
                          f"rank {r} {name}")


def test_microbatched_step_matches_jax(ranks):
    dims = (2, 2, 1)
    want = _jax_run(dims, 1, "none", None, 2)
    name = W.case_name(dims, 1, "none", False, 2)
    for r in range(W.SIZE):
        _assert_close(ranks[r][name], want, PARAM_ATOL, f"rank {r} {name}")


@pytest.mark.parametrize("dims,levels", [((1, 2, 2), (1, 2, 3)),
                                         ((2, 2, 1), (1, 3))], ids=str)
def test_lossy_wire_matches_jax(ranks, dims, levels):
    """``int8_ring`` + EF: each level against JAX's level 1 within
    test_composed_lossy_wire_levels_agree's 5e-3, losses too (the two
    frameworks' gradients differ in their last bits, which can flip an
    int8 rounding, a step of the bucket's scale / 127, and so move the
    next step's loss), the levels bitwise equal within the port.  At dp = 1 every bucket's format is ``none``
    (a one-rank reduce-scatter moves no bytes), as in the JAX chain."""
    want = _jax_run(dims, 1, "int8_ring", True, 1)
    ref = W.case_name(dims, 1, "int8_ring", True, 1)
    for level in levels:
        name = W.case_name(dims, level, "int8_ring", True, 1)
        for r in range(W.SIZE):
            _assert_close(ranks[r][name], want, LOSSY_ATOL,
                          f"rank {r} {name}", loss_atol=LOSSY_ATOL)
            _assert_bitwise(ranks[r][name], ranks[r][ref],
                            f"rank {r} {name} against level 1")
    if dims[0] > 1:  # the lossy wire ran: error feedback holds a residual
        res = ranks[0][ref]["res"]
        assert res is not None and any(np.abs(x).sum() > 0 for x in res)
    else:
        assert ranks[0][ref]["res"] is None


def test_every_layout_and_level_meets_the_dp_only_reference(ranks):
    """Within the port: every exact-wire case at k=1 against (4,1,1) level
    1, parameters bitwise equal on every rank, and the levels of a layout
    bitwise equal."""
    ref = ranks[0][W.case_name((4, 1, 1), 1, "none", False, 1)]
    for dims, level, wire, ef, k in W.LLAMA_CASES:
        if wire != "none" or k != 1:
            continue
        name = W.case_name(dims, level, wire, ef, k)
        for r in range(W.SIZE):
            got = ranks[r][name]
            _assert_close(got, (ref["losses"], ref["params"]), PARAM_ATOL,
                          f"rank {r} {name}")
            _assert_bitwise(got, ranks[0][name], f"rank {r} {name}")
            one = W.case_name(dims, 1, wire, ef, k)
            _assert_bitwise(got, ranks[r][one], f"rank {r} {name} vs L1")


@pytest.mark.parametrize("dims", W.TOY_LAYOUTS, ids=str)
def test_generic_layout_step_trains_toy(ranks, dims):
    """The generic (replicated-parameters) composed path at level 2 against
    the JAX one on the same sub-mesh (test_generic_layout_step_trains_toy_on
    _3d_mesh's 1e-5), every rank the same."""
    mesh = _mesh(dims)
    params = {k: jnp.asarray(v) for k, v in W.toy_params().items()}
    x, y = (jnp.asarray(a) for a in W.toy_data())

    def loss_fn(p, batch):
        xb, yb = batch
        return jnp.mean((xb @ p["w"] + p["b"] - yb) ** 2)

    opt = optax.adam(W.TOY_LR, eps=W.EPS)
    st = JLay.init_layout_state(opt, params, jax.sharding.PartitionSpec(),
                                mesh, zero_level=2)
    step = JLay.make_layout_train_step(loss_fn, opt, mesh, zero_level=2,
                                       donate=False)
    p = params
    for _ in range(W.TOY_STEPS):
        p, st, _ = step(p, st, (x, y))
    for r in range(W.SIZE):
        got = ranks[r][f"toy {dims}"]
        for key in ("w", "b"):
            np.testing.assert_allclose(got[key], np.asarray(p[key]),
                                       rtol=0, atol=TOY_ATOL,
                                       err_msg=f"rank {r} {key}")
