"""Prefill/decode disaggregation in the port's engine
(``horovod_tpu_torch.serve.engine``): the reference's contract
(tests/test_serve_replica.py:222-268) on the port, the block payload codec
against the JAX codec record for record, and a JAX prefill engine's
handoffs imported into the port's decode engine."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import dataclasses  # noqa: E402
import json  # noqa: E402

import jax  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from horovod_tpu.models import llama as JL  # noqa: E402
from horovod_tpu.serve import engine as JE  # noqa: E402
from horovod_tpu.serve.config import ServeConfig as JServeConfig  # noqa: E402
from horovod_tpu_torch.models import llama as TL  # noqa: E402
from horovod_tpu_torch.serve import engine as TE  # noqa: E402
from horovod_tpu_torch.serve.config import ServeConfig  # noqa: E402
from horovod_tpu_torch.serve.engine import (Request, Scheduler,  # noqa: E402
                                            ServeEngine)


def _cfg(**kw):
    base = dict(max_slots=2, block_size=4, cache_blocks=16, max_seq_len=32,
                max_batch_tokens=16, prefill_chunk=8, spec_decode=False)
    base.update(kw)
    return ServeConfig(**base)


@pytest.fixture(scope="module")
def tiny():
    cfg = JL.CONFIGS["tiny"]
    params = JL.init(jax.random.PRNGKey(0), cfg)
    tree = jax.tree_util.tree_map(np.asarray, params)
    return cfg, params, TL.params_from_jax(tree, TL.CONFIGS["tiny"],
                                           device="cpu")


def _greedy(model, prompt, n_new):
    ids = list(prompt)
    with torch.no_grad():
        for _ in range(n_new):
            ids.append(int(model(torch.tensor([ids]))[0, -1].argmax()))
    return ids[len(prompt):]


def _prompts(vocab):
    rng = np.random.RandomState(11)
    return [rng.randint(0, vocab, n).tolist() for n in (9, 13)]


def _prefill_all(engine, prompts, n_new):
    for i, p in enumerate(prompts):
        engine.submit(p, n_new, req_id=f"r{i}")
    handoffs = []
    while engine.has_work():
        handoffs.extend(engine.step()["handoff"])
    return handoffs


def _decode_all(engine, handoffs):
    reqs = [engine.import_prefill(json.loads(json.dumps(h)))
            for h in handoffs]
    emitted = {r.req_id: [] for r in reqs}
    while engine.has_work():
        for rid, toks in engine.step()["emitted"].items():
            emitted[rid].extend(toks)
    return reqs, emitted


@pytest.mark.parametrize("spec", [False, True])
def test_disaggregated_prefill_decode_is_byte_identical(tiny, spec):
    """A prefill-role engine exports each finished prefill (prompt KV
    blocks + first token) over a JSON-serializable handoff, a decode-role
    engine imports it straight into its slot table, and the joined output
    is the mixed engine's greedy stream, the first token exactly once."""
    cfg, _, model = tiny
    prompts = _prompts(cfg.vocab)
    scfg = _cfg(spec_decode=spec)
    pre = ServeEngine(model, scfg, role="prefill", device="cpu")
    dec = ServeEngine(model, scfg, role="decode", device="cpu")
    handoffs = _prefill_all(pre, prompts, 6)
    assert len(handoffs) == len(prompts)
    assert pre.stats()["handoffs"] == len(prompts)
    assert pre.stats()["tokens_decode"] == 0
    reqs, emitted = _decode_all(dec, handoffs)
    assert dec.stats()["imports"] == len(prompts)
    mixed = ServeEngine(model, scfg, device="cpu")
    mreqs = [mixed.submit(p, 6, req_id=f"r{i}")
             for i, p in enumerate(prompts)]
    mixed.flush()
    for i, p in enumerate(prompts):
        oracle = _greedy(model, p, 6)
        assert mreqs[i].out_tokens == oracle, i
        assert reqs[i].out_tokens == oracle, i
        assert emitted[f"r{i}"] == oracle, i  # exactly once, in order


def test_handoff_record_carries_the_jax_fields(tiny):
    """The port's handoff has the JAX record's keys, the prompt's blocks
    (ceil(prompt / block_size)) and a first token equal to greedy's."""
    cfg, _, model = tiny
    scfg = _cfg()
    p = _prompts(cfg.vocab)[1]
    pre = ServeEngine(model, scfg, role="prefill", device="cpu")
    pre.submit(p, 6, req_id="x", trace={"rid": "x", "span": "s", "hop": 0})
    (h,) = _prefill_all(pre, [], 6)
    jpre = JE.ServeEngine(JL, cfg, tiny[1],
                          JServeConfig(**dataclasses.asdict(scfg)),
                          mesh=jax.sharding.Mesh(
                              np.array(jax.devices()[:1]), ("hvd",)),
                          role="prefill")
    jpre.submit(p, 6, req_id="x")
    (jh,) = _prefill_all(jpre, [], 6)
    assert set(h) == set(jh)
    assert len(h["blocks"]) == len(jh["blocks"]) == -(-len(p) // 4)
    assert h["first_token"] == jh["first_token"] == _greedy(model, p, 1)[0]
    assert h["trace"] == {"rid": "x", "span": "s", "hop": 0}
    for ours, theirs in zip(h["blocks"], jh["blocks"]):
        for name in ("k", "v"):
            assert ours[name]["dtype"] == theirs[name]["dtype"] == "float32"
            assert ours[name]["shape"] == theirs[name]["shape"]
            a = TE.decode_block_payload(ours)[name].numpy()
            b = JE.decode_block_payload(theirs)[name]
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


def test_decode_role_rejects_prefill_admission():
    """A decode-role scheduler never plans prefill work from raw
    submissions; an unknown role raises."""
    sched = Scheduler(_cfg(), role="decode")
    sched.submit(Request([1, 2, 3], 4, req_id="r0"))
    assert sched.plan() == []
    with pytest.raises(ValueError):
        Scheduler(_cfg(), role="mainframe")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_codec_records_equal_the_jax_codec(dtype):
    """``encode_block_payload`` of the same KV values is JSON-equal to the
    JAX codec's record (bf16 named ``"bfloat16"`` over its raw 2-byte
    words), and each side decodes the other's record to the same bytes."""
    rng = np.random.RandomState(4)
    vals = {k: rng.standard_normal((2, 4, 2, 16)).astype(np.float32)
            for k in ("k", "v")}
    if dtype == "bfloat16":
        jax_payload = {k: v.astype(ml_dtypes.bfloat16)
                       for k, v in vals.items()}
        port_payload = {k: torch.from_numpy(v).to(torch.bfloat16)
                        for k, v in vals.items()}
    else:
        jax_payload = vals
        port_payload = {k: torch.from_numpy(v) for k, v in vals.items()}
    ours = TE.encode_block_payload(port_payload)
    theirs = JE.encode_block_payload(jax_payload)
    assert json.dumps(ours, sort_keys=True) == \
        json.dumps(theirs, sort_keys=True)
    assert ours["k"]["dtype"] == dtype
    for name in ("k", "v"):
        back = TE.decode_block_payload(theirs)[name]
        assert back.dtype == port_payload[name].dtype
        assert torch.equal(back, port_payload[name])
        jback = JE.decode_block_payload(ours)[name]
        assert jback.dtype == jax_payload[name].dtype
        assert jback.tobytes() == jax_payload[name].tobytes()


def test_jax_handoff_imported_into_the_port_gives_the_jax_tokens(tiny):
    """A JAX prefill-role engine's handoffs (JSON) through the port's
    decode-role engine: the tokens are the JAX mixed engine's."""
    cfg, params, model = tiny
    prompts = _prompts(cfg.vocab)
    scfg = _cfg()
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("hvd",))
    jcfg = JServeConfig(**dataclasses.asdict(scfg))
    jpre = JE.ServeEngine(JL, cfg, params, jcfg, mesh=mesh, role="prefill")
    handoffs = _prefill_all(jpre, prompts, 6)
    dec = ServeEngine(model, scfg, role="decode", device="cpu")
    reqs, emitted = _decode_all(dec, handoffs)
    jmix = JE.ServeEngine(JL, cfg, params, jcfg, mesh=mesh)
    jreqs = [jmix.submit(p, 6, req_id=f"r{i}")
             for i, p in enumerate(prompts)]
    jmix.flush()
    for i in range(len(prompts)):
        assert reqs[i].out_tokens == jreqs[i].out_tokens, i
        assert emitted[f"r{i}"] == jreqs[i].out_tokens, i


def test_import_carries_trace_and_upstream_timing(tiny):
    """The decode side keeps the record's trace context and the prefill
    side's queue/prefill durations, and measures handoff_s from the
    record's wall-clock export stamp."""
    _, _, model = tiny
    dec = ServeEngine(model, _cfg(), role="decode", device="cpu")
    block = {k: {"dtype": "float32", "shape": [2, 4, 2, 16],
                 "hex": bytes(2 * 4 * 2 * 16 * 4).hex()} for k in "kv"}
    req = dec.import_prefill({
        "req_id": "h0", "tokens": [1, 2, 3], "max_new_tokens": 3,
        "eos_id": None, "first_token": 7, "trace": {"rid": "h0"},
        "queue_s": 0.5, "prefill_s": 0.25, "exported_t": 0.0,
        "blocks": [block]})
    assert req.trace == {"rid": "h0"}
    assert req.upstream == {"queue_s": 0.5, "prefill_s": 0.25}
    assert req.handoff_s > 0
    report = dec.step()
    assert report["emitted"]["h0"] == [7]
    dec.flush()
    assert req.state == "done" and len(req.out_tokens) == 3
