"""horovod_tpu_torch.models.inception against horovod_tpu.models.inception
on the same weights (a numpy tree of the JAX model's shapes), BN in eval
mode (training mode: ``torch_port_zoo``), at the JAX tests' size (139 px,
batch 2, 10 classes): logits within 1e-5 of their largest magnitude, the
loss within 1e-5 and every gradient, through every block kind (A, the
reductions, C, E), within 1e-4 of its tensor's largest magnitude."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from horovod_tpu.models import inception as JI
from horovod_tpu_torch.models import inception as TI
from torch_port_zoo import check_eval, nhwc, numpy_params, scaled_close


@pytest.fixture(scope="module")
def v3():
    params = numpy_params(lambda k: JI.init(k, classes=10))
    x, y = nhwc(np.random.RandomState(0), 2, 139, 10)
    return params, x, y


def test_inception_v3_logits_match(v3):
    params, x, _ = v3
    ref, _ = jax.jit(JI.apply)(params, jnp.asarray(x))
    with torch.no_grad():
        got = TI.params_from_jax(params, device="cpu")(torch.from_numpy(x))
    scaled_close(got.numpy(), ref, 1e-5)


def test_inception_v3_eval_loss_and_grads_match(v3):
    params, x, y = v3
    model = TI.params_from_jax(params, device="cpu")
    check_eval(JI.loss_fn, params, model, x, y)
    for block in ("a0", "b0", "c0", "d0", "e1"):
        assert sum(p.grad.abs().sum().item()
                   for p in getattr(model, block).parameters()) > 0, block


def test_inception_v3_param_count():
    n = sum(int(np.prod(a.shape)) for k, a in jax.tree_util
            .tree_leaves_with_path(jax.eval_shape(
                lambda k: JI.init(k, classes=1000), jax.random.PRNGKey(0)))
            if k[-1].key not in ("mean", "var"))
    assert sum(p.numel() for p in TI.Inception(device="meta")
               .parameters()) == n
    assert 22e6 < n < 26e6
