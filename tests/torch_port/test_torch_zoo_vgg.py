"""horovod_tpu_torch.models.vgg against horovod_tpu.models.vgg on the same
weights (a numpy tree of the JAX model's shapes, the stacked convs
unstacked by ``params_from_jax``), BN in eval mode (training mode:
``torch_port_zoo``): VGG-16 ``features`` and ``apply`` at 32 and 64 px
(the classifier's 7x7 grid reached by the linear resize), logits within
1e-5 of their largest magnitude; the loss within 1e-5 and every gradient
within 1e-4 of its tensor's largest magnitude at 32 px."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from horovod_tpu.models import vgg as JV
from horovod_tpu_torch.models import vgg as TV
from torch_port_zoo import check_eval, nhwc, numpy_params, scaled_close


@pytest.fixture(scope="module")
def v16():
    return numpy_params(lambda k: JV.init(k, depth=16, classes=10))


@pytest.mark.parametrize("size", [32, 64])
def test_vgg16_apply_and_features_match(v16, size):
    x, _ = nhwc(np.random.RandomState(size), 2, size, 10)
    model = TV.params_from_jax(v16, 16, device="cpu")
    logits, feats = jax.jit(lambda p, xx: (JV.apply(p, xx)[0],
                                           JV.features(p, xx)[0]))(
        v16, jnp.asarray(x))
    with torch.no_grad():
        scaled_close(model(torch.from_numpy(x)).numpy(), logits, 1e-5)
        scaled_close(TV.features(model, torch.from_numpy(x)).numpy(),
                     feats, 1e-5)


def test_vgg16_eval_loss_and_grads_match(v16):
    x, y = nhwc(np.random.RandomState(0), 2, 32, 10)
    check_eval(JV.loss_fn, v16, TV.params_from_jax(v16, 16, device="cpu"),
               x, y, stacked="c")


def test_vgg_params_and_refusal(v16):
    n_jax = sum(int(np.prod(a.shape)) for k, a in
                jax.tree_util.tree_leaves_with_path(v16)
                if k[-1].key not in ("mean", "var"))
    assert sum(p.numel() for p in TV.VGG(16, 10, device="meta")
               .parameters()) == n_jax
    assert sum(p.numel() for p in TV.VGG(19, device="meta")
               .parameters()) > 143e6
    with pytest.raises(ValueError, match="depth"):
        TV.VGG(11, device="cpu")
