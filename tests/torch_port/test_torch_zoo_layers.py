"""The zoo's layers of horovod_tpu_torch.models.layers against
horovod_tpu.models.layers (and the Inception pool, the VGG resize) on the
same numpy inputs: conv and pools with TF padding on odd and even sizes,
batch normalization in training and eval, layernorm, gelu, dense, and the
JAX tree's carry-over.  Tolerance: fp32 1e-5 (absolute and relative);
bf16 one bf16 step (rtol 1e-2 of max|ref|)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from horovod_tpu.models import inception as JI
from horovod_tpu.models import layers as JL
from horovod_tpu_torch.models import layers as TL

TOL = dict(rtol=1e-5, atol=1e-5)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("size,k,stride,padding", [
    (8, 3, 1, "SAME"), (9, 3, 2, "SAME"), (8, 3, 2, "SAME"),
    (224, 7, 2, "SAME"), (9, 1, 2, "SAME"), (8, 5, 1, "VALID"),
    (9, 3, 2, "VALID"), (10, 7, 1, "SAME"), (11, 3, 2, "VALID")])
def test_conv_matches(size, k, stride, padding):
    cin, cout = 3, 4
    x = _rand(2, size, size, cin)
    w = _rand(k, k, cin, cout, seed=1)
    ref = JL.conv({"kernel": jnp.asarray(w)}, jnp.asarray(x), stride,
                  padding)
    got = TL.conv(torch.from_numpy(w.transpose(3, 2, 0, 1).copy()),
                  _nchw(x), stride, padding)
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref), **TOL)


def test_conv_asymmetric_kernel_matches():
    """Inception's 1x7 and 7x1: the padding of each dim on its own."""
    x = _rand(1, 17, 17, 3)
    for kh, kw in ((1, 7), (7, 1), (1, 3)):
        w = _rand(kh, kw, 3, 2, seed=kh)
        ref = JL.conv({"kernel": jnp.asarray(w)}, jnp.asarray(x))
        got = TL.conv(torch.from_numpy(w.transpose(3, 2, 0, 1).copy()),
                      _nchw(x))
        np.testing.assert_allclose(_nhwc(got), np.asarray(ref), **TOL)


@pytest.mark.parametrize("size,window,stride,padding", [
    (112, 3, 2, "SAME"), (9, 3, 2, "SAME"), (8, 2, 2, "VALID"),
    (9, 2, 2, "VALID"), (147, 3, 2, "VALID"), (35, 3, 2, "VALID")])
def test_maxpool_matches(size, window, stride, padding):
    x = _rand(2, size, size, 3)
    ref = JL.maxpool(jnp.asarray(x), window, stride, padding)
    got = TL.maxpool(_nchw(x), window, stride, padding)
    np.testing.assert_array_equal(_nhwc(got), np.asarray(ref))


@pytest.mark.parametrize("size,window,stride", [
    (8, 3, 1), (9, 3, 1), (8, 3, 2), (9, 2, 2)])
def test_avgpool_matches_inception_pool(size, window, stride):
    """The pad cells are not counted: symmetric (stride 1) and asymmetric
    (stride 2 on an even size) SAME padding."""
    x = _rand(2, size, size, 3)
    ref = JI._pool(jnp.asarray(x), "avg", window, stride, "SAME")
    got = TL.avgpool(_nchw(x), window, stride, "SAME")
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref), **TOL)


@pytest.mark.parametrize("image", [32, 64, 256])
def test_resize_matches_jax_image_resize(image):
    """VGG's bridge to the 7x7 classifier: the trunk's grid of a 32, 64
    and 256 px image (1, 2 and 8 cells; 8 -> 7 downsamples with
    antialiasing)."""
    g = image // 32
    x = _rand(2, g, g, 5)
    ref = jax.image.resize(jnp.asarray(x), (2, 7, 7, 5), "linear")
    got = TL.resize_linear(_nchw(x), 7, 7)
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref), **TOL)


def _bn_params(c, seed=3):
    rng = np.random.RandomState(seed)
    return {"scale": rng.rand(c).astype(np.float32) + 0.5,
            "bias": rng.randn(c).astype(np.float32),
            "mean": rng.randn(c).astype(np.float32) * 0.1,
            "var": rng.rand(c).astype(np.float32) + 0.5}


@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batchnorm_matches(training, dtype):
    c = 6
    x = _rand(4, 5, 5, c) * 3 + 1
    p = _bn_params(c)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    ref, new = JL.batchnorm({k: jnp.asarray(v) for k, v in p.items()},
                            jnp.asarray(x, jdt), training)
    bn = TL.BatchNorm(c, "cpu")
    TL.load_state(bn, p)
    got = bn(_nchw(x).to(tdt), training)
    ref = np.asarray(ref, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(_nhwc(got), ref, **TOL)
    else:
        np.testing.assert_allclose(_nhwc(got.float()), ref, rtol=0,
                                   atol=1e-2 * np.abs(ref).max())
    for k in ("mean", "var"):
        np.testing.assert_allclose(getattr(bn, k).numpy(),
                                   np.asarray(new[k]), **TOL)


def test_conv_bn_relu_matches_with_gradients():
    x = _rand(2, 9, 9, 3)
    w = _rand(3, 3, 3, 4, seed=1) * 0.3
    p = {"conv": {"kernel": w}, "bn": _bn_params(4)}

    def jloss(params, xx):
        y, new = JL.conv_bn_relu(params, xx, stride=2, training=True)
        return jnp.sum(y * jnp.arange(4.0)), new

    (ref, new), g = jax.value_and_grad(jloss, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x))
    m = TL.ConvBN(3, 3, 3, 4, torch.float32, "cpu")
    TL.load_state(m, TL.state_from_jax(p))
    y = m(_nchw(x), 2, training=True)
    loss = (y * torch.arange(4.0)[:, None, None]).sum()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref), **TOL)
    want = TL.state_from_jax(jax.tree_util.tree_map(np.asarray, g))
    for name, prm in m.named_parameters():
        np.testing.assert_allclose(prm.grad.numpy(), want[name], rtol=1e-4,
                                   atol=1e-4 * np.abs(want[name]).max(),
                                   err_msg=name)
    np.testing.assert_allclose(m.bn.mean.numpy(),
                               np.asarray(new["bn"]["mean"]), **TOL)


def test_layernorm_gelu_dense_match():
    x = _rand(3, 7, 16) * 2
    p = {"scale": _rand(16, seed=1), "bias": _rand(16, seed=2)}
    ref = JL.layernorm({k: jnp.asarray(v) for k, v in p.items()},
                       jnp.asarray(x))
    got = TL.layernorm(torch.from_numpy(p["scale"]),
                       torch.from_numpy(p["bias"]), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(TL.gelu(torch.from_numpy(x)).numpy(),
                               np.asarray(JL.gelu(jnp.asarray(x))), **TOL)
    d = {"kernel": _rand(16, 5, seed=4), "bias": _rand(5, seed=5)}
    ref = JL.dense({k: jnp.asarray(v) for k, v in d.items()},
                   jnp.asarray(x))
    dense = TL.Dense(16, 5, torch.float32, "cpu")
    TL.load_state(dense, TL.state_from_jax(d))
    np.testing.assert_allclose(dense(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(ref), **TOL)


def test_state_from_jax_unstacks_and_transposes():
    tree = {"s0b0": {"conv1": {"kernel": np.zeros((3, 3, 2, 4))}},
            "s0rest": {"conv1": {"kernel": np.arange(2 * 3 * 3 * 4 * 4)
                                 .reshape(2, 3, 3, 4, 4)}},
            "head": {"kernel": np.zeros((4, 10)), "bias": np.zeros(10)},
            "layers": [{"ln": {"scale": np.ones(3)}}]}
    state = TL.state_from_jax(tree)
    assert sorted(state) == ["head.bias", "head.weight", "layers.0.ln.scale",
                             "s0b0.conv1.weight", "s0b1.conv1.weight",
                             "s0b2.conv1.weight"]
    assert state["head.weight"].shape == (10, 4)
    np.testing.assert_array_equal(
        state["s0b2.conv1.weight"],
        tree["s0rest"]["conv1"]["kernel"][1].transpose(3, 2, 0, 1))
    assert "s0c1.conv1.weight" in TL.state_from_jax(tree, stacked="c")


def test_load_state_refuses_a_tree_that_does_not_fit():
    dense = TL.Dense(4, 2, torch.float32, "cpu")
    with pytest.raises(ValueError, match="missing"):
        TL.load_state(dense, {"weight": np.zeros((2, 4))})
    with pytest.raises(ValueError, match="shape"):
        TL.load_state(dense, {"weight": np.zeros((4, 2)),
                              "bias": np.zeros(2)})
