"""The 3D layout plane in one process: the port's cost-model solver
(``horovod_tpu_torch/perf/costmodel.py``) and the knob surface, restack,
specs and slicing of ``horovod_tpu_torch/parallel/layout.py`` against the
JAX package's functions on the same inputs (tests/test_layout.py's
``_model8``, knobs and cases), and the one-rank layout (1, 1, 1) against
the ZeRO chain it reduces to."""

import dataclasses
import itertools

import jax
import numpy as np
import pytest
import torch

from horovod_tpu.models import llama as JL
from horovod_tpu.parallel import layout as JLay
from horovod_tpu.perf import costmodel as JC
from horovod_tpu_torch import runtime as rt
from horovod_tpu_torch.models import llama as TL
from horovod_tpu_torch.parallel import layout as Lay
from horovod_tpu_torch.parallel import zero as Z
from horovod_tpu_torch.perf import costmodel as C

CFG = JL.CONFIGS["tiny"]
B, S = 8, 16


def _model8(**kw):
    return dict(batch=B, seq=S, vocab=CFG.vocab, dim=CFG.dim,
                n_layers=CFG.n_layers, n_heads=CFG.n_heads,
                n_kv_heads=CFG.n_kv_heads, ffn_dim=CFG.ffn_dim, **kw)


def _knobs(layout="", tp=0, pp=0, level=1):
    return {"HOROVOD_LAYOUT": layout, "HOROVOD_TP": tp, "HOROVOD_PP": pp,
            "HOROVOD_ZERO_LEVEL": level}


@pytest.fixture
def one_rank(monkeypatch):
    for name in ("HOROVOD_LAYOUT", "HOROVOD_TP", "HOROVOD_PP",
                 "HOROVOD_SIZE", "HOROVOD_RANK"):
        monkeypatch.delenv(name, raising=False)
    rt.shutdown()
    yield monkeypatch
    rt.shutdown()


# --------------------------------------------------------------- cost model
def test_tables_keep_the_jax_entries_and_add_the_h100():
    for chip, tflops in JC.PEAK_TFLOPS.items():
        assert C.PEAK_TFLOPS[chip] == tflops
        assert C.peak_flops(chip) == JC.peak_flops(chip)
    for link, gbps in JC.LINK_GBPS.items():
        assert C.LINK_GBPS[link] == gbps
        assert C.link_bandwidth(link) == JC.link_bandwidth(link)
    assert C.peak_flops("h100") == 989e12
    assert C.link_bandwidth("nvlink") == 450e9
    with pytest.raises(ValueError, match="unknown chip 'unknown'"):
        C.peak_flops("unknown")
    with pytest.raises(ValueError):
        C.link_bandwidth("carrier-pigeon")


@pytest.mark.parametrize("world", [8, 4])
def test_solver_equals_jax_for_every_candidate(world):
    model, jmodel = (m.llama_layout_model(**_model8())
                     for m in (C, JC))
    assert model == jmodel
    kw = dict(levels=(1, 2, 3), overlap_depths=(0, 2), n_micro=2)
    got, want = (m.solve_layout(model, world, **kw) for m in (C, JC))
    assert got == want
    assert got["n_candidates"] > 0
    totals = sorted(r["memory"]["total_bytes"] for r in want["candidates"])
    cap = (totals[0] + totals[-1]) / 2.0
    assert (C.solve_layout(model, world, mem_cap_bytes=cap, **kw)
            == JC.solve_layout(model, world, mem_cap_bytes=cap, **kw))
    for row in want["candidates"]:
        lay = row["layout"]
        dims = (lay["dp"], lay["tp"], lay["pp"])
        for level in (1, 2, 3):
            args = dict(zero_level=level, k=2, wire_format="bf16",
                        overlap_depth=2, n_micro=4, chip="v5e", link="ici")
            assert (C.layout_step_time(model, *dims, **args)
                    == JC.layout_step_time(model, *dims, **args))
            assert (C.layout_memory_bytes(model, *dims, zero_level=level,
                                          ef=True)
                    == JC.layout_memory_bytes(model, *dims,
                                              zero_level=level, ef=True))


def test_cost_model_terms_equal_jax():
    for tp, tokens, dim, layers in itertools.product((1, 2, 4), (128, 77),
                                                     (64,), (2, 3)):
        assert (C.tp_comm_bytes(tp, tokens, dim, layers)
                == JC.tp_comm_bytes(tp, tokens, dim, layers))
    for pp, m in itertools.product((1, 2, 4), (1, 4, 6)):
        assert C.pp_comm_bytes(pp, m, 32, 64) == JC.pp_comm_bytes(pp, m, 32,
                                                                   64)
    for local, req in itertools.product((1, 6, 8, 12), (1, 4, 5, 16)):
        assert (C._effective_microbatches(local, req)
                == JC._effective_microbatches(local, req))
    for n in (1, 2, 3, 8):
        assert C.ring_wire_bytes(1001, 4.0, n) == JC.ring_wire_bytes(1001,
                                                                     4.0, n)
    attn = {"n_layers": 2, "dim": 64, "seq": 16}
    assert C.train_flops_per_token(1000, attn) == JC.train_flops_per_token(
        1000, attn)
    assert list(C._factorizations(12)) == list(JC._factorizations(12))
    assert (C.llama_param_count(128256, 4096, 32, 32, 8, 14336)
            == JC.llama_param_count(128256, 4096, 32, 32, 8, 14336)
            == TL.param_count(TL.CONFIGS["8b"]))
    with pytest.raises(ValueError):
        C.solve_layout(dict(C.llama_layout_model(**_model8()), n_heads=3,
                            n_kv_heads=3, n_layers=3, batch=3), 8)


# ------------------------------------------------------------ knob surface
def test_layout_knob_validation():
    Lay.validate_layout_knobs(_knobs(), world=8)
    Lay.validate_layout_knobs(_knobs("auto", tp=2), world=8)
    Lay.validate_layout_knobs(_knobs("2,2,2"), world=8)
    cases = [
        (_knobs("bogus"), 8, ""),
        (_knobs("2,2"), 8, ""),
        (_knobs("2,2,2"), 16, ""),
        (_knobs("0,4,2"), 8, ""),
        (_knobs("auto", tp=3), 8, ""),
        (_knobs("auto", pp=3), 8, ""),
        (_knobs("auto", tp=4, pp=4), 8, ""),
        (_knobs("dp-only", tp=2), 8, ""),
        (_knobs("2,2,2", tp=4), 8, ""),
        (_knobs("", tp=2), 8, ""),
        (_knobs("auto"), 8, "data=8"),
        (_knobs("", tp=-1), 8, ""),
    ]
    for knobs, world, mesh_spec in cases:
        for module in (Lay, JLay):
            with pytest.raises(ValueError):
                module.validate_layout_knobs(knobs, world=world,
                                             mesh_spec=mesh_spec)


def test_resolve_layout_modes():
    for knobs, world in ((_knobs(), 8), (_knobs("dp-only"), 8),
                         (_knobs("4,1,2"), 8), (_knobs("auto"), 8),
                         (_knobs("auto", tp=2, pp=2), 8),
                         (_knobs("auto", level=3), 4)):
        assert (Lay.resolve_layout(world, knobs)
                == JLay.resolve_layout(world, knobs))
    assert Lay.resolve_layout(8, _knobs()) is None
    assert Lay.resolve_layout(8, _knobs("auto")) == (8, 1, 1)
    assert Lay.resolve_layout(8, _knobs("auto", tp=2, pp=2)) == (2, 2, 2)
    with pytest.raises(ValueError):
        Lay.resolve_layout(16, _knobs("2,2,2"))
    model = C.llama_layout_model(**_model8())
    got = Lay.resolve_layout(8, _knobs("auto"), model=model)
    assert got == JLay.resolve_layout(8, _knobs("auto"), model=model)
    assert got[0] * got[1] * got[2] == 8
    assert CFG.n_kv_heads % got[1] == 0 and CFG.n_layers % got[2] == 0
    assert Lay.layout_mesh_spec(*got) == JLay.layout_mesh_spec(*got)


def test_coordinates_follow_the_jax_numbering():
    for dims in ((2, 2, 2), (4, 1, 2), (1, 4, 2), (8, 1, 1)):
        ranks = np.arange(8).reshape(dims)  # P(("dp", "tp", "pp")) order
        for coord in itertools.product(*(range(n) for n in dims)):
            r = Lay.layout_rank(coord, dims)
            assert r == ranks[coord]
            assert Lay.layout_coord(r, dims) == coord


def test_runtime_resolves_the_layout_at_init(one_rank):
    assert rt.init(device="cpu").layout is None
    with pytest.raises(ValueError):
        Lay.layout_of_runtime()
    rt.shutdown()
    for value in ("1,1,1", "dp-only", "auto"):
        one_rank.setenv("HOROVOD_LAYOUT", value)
        lay = rt.init(device="cpu").layout
        assert Lay.layout_of_runtime() == lay.dims == (1, 1, 1)
        assert lay.coord == (0, 0, 0)
        assert lay.ranks == {"dp": [0], "tp": [0], "pp": [0]}
        rt.shutdown()
    for env in ({"HOROVOD_LAYOUT": "2,1,1"}, {"HOROVOD_TP": "2"},
                {"HOROVOD_LAYOUT": "auto", "HOROVOD_PP": "2"}):
        with one_rank.context() as m:
            for k, v in env.items():
                m.setenv(k, v)
            with pytest.raises(ValueError):
                rt.init(device="cpu")
        assert not rt.is_initialized()


# ------------------------------------------------------ restack and specs
def _jax_tree(cfg=CFG):
    return jax.tree_util.tree_map(np.asarray,
                                  JL.init(jax.random.PRNGKey(0), cfg))


def _spec_tuple(spec):
    return tuple(spec)


def test_llama_layout_restack_and_specs():
    params = _jax_tree()
    for pp in (1, 2):
        got = Lay.llama_layout_params(params, pp)
        want = JLay.llama_layout_params(params, pp)
        jax.tree_util.tree_map(np.testing.assert_array_equal, got,
                               jax.tree_util.tree_map(np.asarray, want))
        lead = got["stages"]["wq"]["kernel"]
        assert lead.shape[:2] == (pp, CFG.n_layers // pp)
        specs = Lay.llama_layout_specs(got)
        jspecs = JLay.llama_layout_specs(want)
        assert specs["stages"]["wq"]["kernel"] == ("pp", None, None, "tp")
        assert specs["stages"]["w_down"]["kernel"] == ("pp", None, "tp",
                                                      None)
        for name, sub in jspecs["stages"].items():
            for leaf, spec in sub.items():
                ours = specs["stages"][name][leaf]
                assert ours[:len(spec)] == _spec_tuple(spec)
                assert all(a is None for a in ours[len(spec):])
        for top in ("embed", "final_norm", "lm_head"):
            for leaf, spec in jspecs[top].items():
                assert _spec_tuple(spec) == specs[top][leaf] == ()
        template = Lay.llama_layout_template(TL.CONFIGS["tiny"], pp)
        jtemplate = JLay.llama_layout_template(CFG, pp)
        jax.tree_util.tree_map(
            lambda a, b: assert_shape(a.shape, b.shape), template,
            jtemplate)
    with pytest.raises(ValueError):
        Lay.llama_layout_params(params, 3)


def assert_shape(a, b):
    assert tuple(a) == tuple(b)


@pytest.mark.parametrize("dims", [(1, 2, 2), (2, 2, 1), (1, 1, 2),
                                  (4, 2, 1)], ids=str)
def test_local_shapes_are_the_jax_local_template(dims):
    """The port module's parameter shapes at every coordinate are the JAX
    ``_local_template`` (kernels transposed), and the local template itself
    equals the JAX one."""
    from jax.sharding import Mesh
    n = int(np.prod(dims))
    mesh = Mesh(np.array(jax.devices()[:n]).reshape(dims),
                ("dp", "tp", "pp"))
    template = Lay.llama_layout_template(TL.CONFIGS["tiny"], dims[2])
    specs = Lay.llama_layout_specs(template)
    local = Lay._local_template(template, specs, dims)
    jtemplate = JLay.llama_layout_template(CFG, dims[2])
    jlocal = JLay._local_template(jtemplate, JLay.llama_layout_specs(
        jtemplate), mesh)
    jax.tree_util.tree_map(lambda a, b: assert_shape(a.shape, b.shape),
                           local, jlocal)
    model = Lay.LayoutLlama(TL.CONFIGS["tiny"], (0, 0, 0), dims, "meta")
    shapes = dict((n, tuple(p.shape)) for n, p in model.named_parameters())
    assert shapes["embed.table"] == tuple(local["embed"]["table"].shape)
    assert shapes["lm_head.weight"] == tuple(
        local["lm_head"]["kernel"].shape)[::-1]
    for name, sub in local["stages"].items():
        for leaf, t in sub.items():
            pname = "weight" if leaf == "kernel" else leaf
            want = tuple(t.shape[2:])
            assert shapes[f"layers.0.{name}.{pname}"] == (
                want[::-1] if leaf == "kernel" else want)
    assert len(model.layers) == CFG.n_layers // dims[2]


@pytest.mark.parametrize("dims", [(1, 2, 2), (2, 2, 1), (1, 1, 2)], ids=str)
def test_layout_params_from_jax_round_trips(dims):
    """Every coordinate's slices, stitched back together, are the full
    model's parameters bitwise; each slice is the JAX local slice."""
    tree = _jax_tree()
    cfg = TL.CONFIGS["tiny"]
    full = dict(TL.params_from_jax(tree, cfg, device="cpu")
                .named_parameters())
    _, tp, pp = dims
    per = cfg.n_layers // pp
    pieces = {}
    for j, k in itertools.product(range(tp), range(pp)):
        part = Lay.layout_params_from_jax(tree, cfg, (0, j, k), dims,
                                          device="cpu")
        for n, p in part.named_parameters():
            parts = n.split(".")
            if parts[0] == "layers":
                parts[1] = str(k * per + int(parts[1]))
            pieces.setdefault(".".join(parts), {})[j] = p.detach()
    for n, want in full.items():
        got = pieces[n]
        name = n.split(".")[2] if n.startswith("layers.") else ""
        if name in Lay.COLUMN + Lay.ROW and tp > 1:
            joined = torch.cat([got[j] for j in range(tp)],
                               dim=0 if name in Lay.COLUMN else 1)
        else:
            assert all(torch.equal(got[j], got[0]) for j in got)
            joined = got[0]
        assert torch.equal(joined, want.detach()), n
    jstack = JLay.llama_layout_params(tree, pp)
    wq = np.asarray(jstack["stages"]["wq"]["kernel"])  # [pp, L/pp, in, out]
    part = Lay.layout_params_from_jax(tree, cfg, (0, tp - 1, pp - 1), dims,
                                      device="cpu")
    cols = wq.shape[-1] // tp
    np.testing.assert_array_equal(
        part.layers[0].wq.weight.detach().numpy(),
        wq[pp - 1, 0][:, (tp - 1) * cols:].T)


def test_step_builder_errors(one_rank):
    rt.init(device="cpu")
    lay = Lay.build_layout(1, 1, 1)
    with pytest.raises(ValueError):
        Lay.LayoutLlama(dataclasses.replace(TL.CONFIGS["tiny"], n_layers=3),
                        (0, 0, 0), (1, 1, 2), "cpu")
    with pytest.raises(ValueError):
        Lay.LayoutLlama(TL.CONFIGS["tiny"], (0, 0, 0), (1, 4, 1), "cpu")
    model = Lay.LayoutLlama(TL.CONFIGS["tiny"], (0, 0, 0), (1, 1, 2), "cpu")
    state = Lay.init_layout_state(torch.optim.SGD, model, zero_level=1,
                                  layout=lay, lr=0.1)
    with pytest.raises(ValueError, match="coordinate"):
        Lay.make_llama_layout_train_step(model, state, layout=lay)
    with pytest.raises(ValueError):
        Lay.init_layout_state(torch.optim.SGD, model, zero_level=0,
                              layout=lay, lr=0.1)
    with pytest.raises(ValueError):
        Lay.make_layout_train_step(model, lambda m, x: x.sum(), state,
                                   layout=lay, zero_level=0)
    with pytest.raises(ValueError, match="no \\(dp, tp, pp\\) layout"):
        Lay.make_layout_train_step(model, lambda m, x: x.sum(), state)


@pytest.mark.parametrize("level", [1, 3])
def test_one_rank_layout_is_the_zero_chain(one_rank, level):
    """At (1, 1, 1) the composed step is ``make_zero_train_step`` on the
    same model: losses and parameters bitwise equal (fp32 parameters, bf16
    compute, as the card's phase runs it)."""
    one_rank.setenv("HOROVOD_LAYOUT", "1,1,1")
    rt.init(device="cpu")
    cfg = dataclasses.replace(TL.CONFIGS["tiny"], dtype=torch.bfloat16)
    batches = [torch.from_numpy(np.random.RandomState(i).randint(
        0, cfg.vocab, (4, 17))) for i in range(3)]
    results = []
    for composed in (False, True):
        model = TL.init(cfg, torch.Generator().manual_seed(0),
                        device="cpu").float()
        kw = dict(lr=1e-3, eps=1e-3, weight_decay=0.01)
        if composed:
            model = Lay.slice_llama(model, (0, 0, 0), (1, 1, 1))
            state = Lay.init_layout_state(torch.optim.AdamW, model,
                                          zero_level=level, **kw)
            step = Lay.make_llama_layout_train_step(
                model, state, zero_level=level, ce_chunks=4,
                compute_dtype=torch.bfloat16)
        else:
            state = Z.init_zero_state(torch.optim.AdamW, model,
                                      zero_level=level, **kw)
            step = Z.make_zero_train_step(
                model, lambda m, ids: TL.loss_fn(m, ids, ce_chunks=4),
                state, zero_level=level, compute_dtype=torch.bfloat16)
        losses = [float(step(ids)) for ids in batches]
        params = (Z.gather_zero3_params(state.shards, model) if level == 3
                  else [p.detach().clone() for p in model.parameters()])
        results.append((losses, params))
    (l0, p0), (l1, p1) = results
    assert l0 == l1
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))
