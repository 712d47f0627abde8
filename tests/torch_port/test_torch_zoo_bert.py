"""horovod_tpu_torch.models.bert and .mlp against horovod_tpu.models.bert
and .mlp on the JAX models' weights (``params_from_jax``): BERT ``tiny``
logits with and without a ``pad_mask``, with type ids and shifted
positions; the masked-LM loss and every gradient; the same with each
side's flash attention (``causal=False``; the JAX kernels in interpret
mode) as ``attn_fn``; the MNIST MLP's logits, loss and gradients.
Tolerance: fp32 1e-5 (absolute and relative); through the flash kernels
5e-4, as the Llama's (tests/torch_port/test_torch_llama.py)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from horovod_tpu.models import bert as JB
from horovod_tpu.models import mlp as JM
from horovod_tpu.ops.flash_attention import flash_attention as jax_flash
from horovod_tpu_torch.models import bert as TB
from horovod_tpu_torch.models import layers as TL
from horovod_tpu_torch.models import mlp as TM
from horovod_tpu_torch.ops.flash_attention import flash_attention as t_flash
from torch_port_zoo import numpy_tree

TOL = dict(rtol=1e-5, atol=1e-5)
CFG = "tiny"


@pytest.fixture(scope="module")
def tiny():
    cfg = JB.CONFIGS[CFG]
    params = numpy_tree(JB.init(jax.random.PRNGKey(0), cfg))
    rng = np.random.RandomState(0)
    ids = rng.randint(1, cfg.vocab, (2, 64)).astype(np.int32)
    labels = rng.randint(0, cfg.vocab, (2, 64)).astype(np.int32)
    mask = (rng.rand(2, 64) < 0.15).astype(np.float32)
    return cfg, params, ids, labels, mask


def _model(params):
    return TB.params_from_jax(params, TB.CONFIGS[CFG], device="cpu")


@pytest.mark.parametrize("variant", ["plain", "pad_mask", "types",
                                     "positions"])
def test_bert_tiny_logits_match(tiny, variant):
    cfg, params, ids, _, _ = tiny
    kw = {}
    if variant == "pad_mask":
        kw["pad_mask"] = np.arange(64)[None].repeat(2, 0) < [[40], [64]]
    if variant == "types":
        kw["type_ids"] = (np.arange(64)[None].repeat(2, 0) >= 32).astype(
            np.int32)
    if variant == "positions":
        ids = ids[:, :32]
        kw["positions"] = np.arange(32, 64)
    ref = jax.jit(lambda p, i, kw: JB.apply(p, i, cfg, **kw))(
        params, jnp.asarray(ids), {k: jnp.asarray(v) for k, v in kw.items()})
    with torch.no_grad():
        got = _model(params)(torch.from_numpy(ids),
                             **{k: torch.from_numpy(np.asarray(v))
                                for k, v in kw.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def _grads_match(model, grads, tol):
    want = TL.state_from_jax(numpy_tree(grads))
    for name, p in model.named_parameters():
        got = torch.zeros_like(p) if p.grad is None else p.grad  # unused
        np.testing.assert_allclose(got.numpy(), want[name], err_msg=name,
                                   **tol)


@pytest.mark.parametrize("attn", ["plain", "flash"])
def test_bert_tiny_mlm_loss_and_grads_match(tiny, attn):
    cfg, params, ids, labels, mask = tiny
    j_attn = t_attn = None
    tol = TOL
    if attn == "flash":
        j_attn = lambda q, k, v: jax_flash(q, k, v, False, 32, 32)
        t_attn = lambda q, k, v: t_flash(q, k, v, False, 32, 32)
        tol = dict(rtol=5e-4, atol=5e-4)
    ref, g = jax.jit(jax.value_and_grad(lambda p: JB.loss_fn(
        p, jnp.asarray(ids), jnp.asarray(labels), cfg,
        mask=jnp.asarray(mask), attn_fn=j_attn)))(params)
    model = _model(params)
    loss = TB.loss_fn(model, torch.from_numpy(ids), torch.from_numpy(labels),
                      mask=torch.from_numpy(mask), attn_fn=t_attn)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref), **tol)
    _grads_match(model, g, tol)


def test_bert_refuses_a_pad_mask_with_an_attn_fn(tiny):
    _, params, ids, _, _ = tiny
    with pytest.raises(ValueError, match="pad_mask"):
        _model(params)(torch.from_numpy(ids),
                       pad_mask=torch.ones(2, 64, dtype=torch.bool),
                       attn_fn=t_flash)


def test_bert_configs_and_param_counts():
    for name in ("tiny", "base", "large"):
        j, t = JB.CONFIGS[name], TB.CONFIGS[name]
        assert (j.vocab, j.dim, j.n_layers, j.n_heads, j.ffn_dim,
                j.max_seq) == (t.vocab, t.dim, t.n_layers, t.n_heads,
                               t.ffn_dim, t.max_seq)
        shapes = jax.eval_shape(lambda k: JB.init(k, j),
                                jax.random.PRNGKey(0))
        n = sum(int(np.prod(a.shape))
                for a in jax.tree_util.tree_leaves(shapes))
        assert sum(p.numel() for p in TB.Bert(t, device="meta")
                   .parameters()) == n
    assert TB.CONFIGS["large"].dtype == torch.bfloat16


def test_mlp_logits_loss_and_grads_match():
    params = numpy_tree(JM.init(jax.random.PRNGKey(0), in_dim=64, hidden=32,
                                classes=10))
    rng = np.random.RandomState(0)
    x = rng.randn(8, 8, 8).astype(np.float32)
    y = rng.randint(0, 10, 8).astype(np.int32)
    model = TM.params_from_jax(params, device="cpu")
    with torch.no_grad():
        np.testing.assert_allclose(
            model(torch.from_numpy(x)).numpy(),
            np.asarray(JM.apply(params, jnp.asarray(x))), **TOL)
    ref, g = jax.jit(jax.value_and_grad(JM.loss_fn))(
        params, jnp.asarray(x), jnp.asarray(y))
    loss = TM.loss_fn(model, torch.from_numpy(x), torch.from_numpy(y))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref), **TOL)
    _grads_match(model, g, TOL)
    assert sum(p.numel() for p in TM.init(device="cpu").parameters()) == \
        784 * 512 + 512 + 512 * 512 + 512 + 512 * 10 + 10
