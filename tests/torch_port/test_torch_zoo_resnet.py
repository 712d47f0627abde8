"""horovod_tpu_torch.models.resnet against horovod_tpu.models.resnet on the
same weights (a numpy tree of the JAX model's shapes, carried over by
``params_from_jax``, the stacked blocks unstacked).

ResNet-50 at 32 px, batch 2, 10 classes, BN in eval mode: logits within
1e-5 of their largest magnitude, the loss within 1e-5, every gradient
within 1e-4 of its tensor's largest magnitude (fp32 sums over 50 layers in
two libraries' orders).  BN in training mode, block by block (a
projection bottleneck at stride 2 and an identity one): output, every
gradient and the moved statistics within 1e-4 of their largest
magnitudes; why not the whole model: ``torch_port_zoo``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from horovod_tpu.models import resnet as JR
from horovod_tpu_torch.models import layers as TL
from horovod_tpu_torch.models import resnet as TR
from torch_port_zoo import check_eval, nhwc, numpy_params, numpy_tree, \
    scaled_close


@pytest.fixture(scope="module")
def r50():
    params = numpy_params(lambda k: JR.init(k, depth=50, classes=10))
    x, y = nhwc(np.random.RandomState(0), 2, 32, 10)
    return params, x, y


def test_params_from_jax_counts_and_dtype(r50):
    params = r50[0]
    model = TR.params_from_jax(params, 50, device="cpu")
    n_jax = sum(int(np.prod(a.shape)) for k, a in
                jax.tree_util.tree_leaves_with_path(params)
                if k[-1].key not in ("mean", "var"))
    assert sum(p.numel() for p in model.parameters()) == n_jax
    assert sum(p.numel() for p in TR.ResNet(50, 10, device="meta")
               .parameters()) == n_jax
    np.testing.assert_array_equal(
        model.s2b3.conv2.weight.detach().numpy(),
        params["s2rest"]["conv2"]["kernel"][2].transpose(3, 2, 0, 1))
    bf = jax.tree_util.tree_map(
        lambda a: a.astype(jnp.bfloat16) if a.ndim == 4 else a, params)
    model = TR.params_from_jax(bf, 50, device="cpu")
    assert model.stem.weight.dtype == torch.bfloat16
    assert model.bn_stem.mean.dtype == torch.float32


def test_resnet50_eval_logits_loss_and_grads_match(r50):
    params, x, y = r50
    ref, _ = jax.jit(lambda p, xx: JR.apply(p, xx, depth=50))(
        params, jnp.asarray(x))
    model = TR.params_from_jax(params, 50, device="cpu")
    with torch.no_grad():
        scaled_close(model(torch.from_numpy(x)).numpy(), ref, 1e-5)
    check_eval(lambda p, a, b, training: JR.loss_fn(
        p, a, b, depth=50, training=training), params, model, x, y)


@pytest.mark.parametrize("cin,width,stride", [(64, 16, 2), (64, 16, 1)])
def test_bottleneck_in_training_mode_matches(cin, width, stride):
    """Batch statistics, their gradients and the running averages of one
    v1.5 bottleneck (stride in the 3x3; a projection when the shape
    changes)."""
    p = numpy_params(lambda k: JR._bottleneck_init(
        k, cin, width, stride, jnp.float32), seed=1)
    x = np.random.RandomState(2).randn(4, 9, 9, cin).astype(np.float32)
    w = np.random.RandomState(3).randn(4 * width).astype(np.float32)

    def jloss(params, xx):
        y, new = JR._bottleneck_apply(params, xx, stride, True, None)
        return jnp.sum(y * w), (y, new)

    (ref, (y_ref, new)), g = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(p, jnp.asarray(x))
    block = TR.Bottleneck(cin, width, stride, torch.float32, "cpu")
    TL.load_state(block, TL.state_from_jax(p))
    y = block(torch.from_numpy(x).permute(0, 3, 1, 2), True, None)
    (y * torch.from_numpy(w)[:, None, None]).sum().backward()
    scaled_close(y.detach().permute(0, 2, 3, 1).numpy(), y_ref, 1e-5)
    assert (block.proj is not None) == (stride != 1 or cin != 4 * width)
    want = TL.state_from_jax(numpy_tree(g))
    for name, prm in block.named_parameters():
        scaled_close(prm.grad.numpy(), want[name], 1e-4, name)
    stats = TL.state_from_jax(numpy_tree(new))
    for name, b in block.named_buffers():
        scaled_close(b.numpy(), stats[name], 1e-5, name)


def test_resnet_depths_and_refusal():
    for depth, blocks in ((18, 8), (101, 33), (152, 50)):
        assert len(TR.ResNet(depth, 10, device="meta").blocks) == blocks
    with pytest.raises(ValueError, match="depth"):
        TR.ResNet(34, device="cpu")
