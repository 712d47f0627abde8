"""Shared checks of the zoo's parity tests (tests/torch_port/test_torch_zoo_*.py):
one JAX CNN's logits, loss and gradients against the port's on the same
weights and batch.

Whole CNNs are compared with BN in eval mode (the running statistics).
In training mode a CNN at initialization is chaotic in fp32: a ReLU whose
input lies within rounding of zero flips between two implementations, and
the batch statistics carry the flip to every position of its channel, so a
1e-6 relative change of the input moves the port's own ResNet-50 gradients
by 17-27% at 64 px (4-8 images); no two fp32 implementations agree there.
Training mode is held to the JAX package block by block, where it is
well-conditioned (test_torch_zoo_layers.py, the bottlenecks in
test_torch_zoo_resnet.py)."""

from __future__ import annotations

import numpy as np
import torch

import jax
import jax.numpy as jnp

from horovod_tpu_torch.models import layers as TL


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def numpy_params(init_fn, seed=0):
    """A parameter tree of the shapes ``init_fn(key)`` makes (traced, not
    run: the JAX inits run op by op and take seconds), drawn with numpy
    from ``seed`` at the init's scales; BN statistics and norms are
    perturbed off their initial ones and zeros, so eval mode and the
    biases are exercised."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(init_fn, jax.random.PRNGKey(0))

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        normal = rng.standard_normal(shape, dtype=np.float32)
        if name == "kernel":
            fan_in = int(np.prod(shape[-4:-1])) if len(shape) >= 4 \
                else shape[-2]
            a = normal * np.float32(np.sqrt((2.0 if len(shape) >= 4
                                             else 1.0) / fan_in))
        elif name == "table":
            a = normal * np.float32(0.02)
        elif name in ("scale", "var"):
            a = 1.0 + 0.2 * rng.random(shape, dtype=np.float32)
        else:  # bias, mean
            a = normal * np.float32(0.1)
        return np.asarray(a, leaf.dtype)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def nhwc(rng, n, size, classes):
    return (rng.randn(n, size, size, 3).astype(np.float32),
            rng.randint(0, classes, n).astype(np.int32))


def scaled_close(got, want, rel, name=""):
    """|got - want| <= rel * max|want| (elementwise)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rel * max(scale, 1e-30), \
        f"{name}: max abs err {err:.3g} > {rel} * max|ref| {scale:.3g}"


def check_eval(jax_loss_fn, params, model, x, y, stacked="b", rel=1e-4):
    """The JAX ``jax_loss_fn(params, x, y, training=False) -> (loss,
    new_params)`` (one compiled call) against the port's model in eval
    mode: the loss within 1e-5 and every parameter's gradient within
    ``rel`` of its largest magnitude."""
    f = jax.jit(jax.value_and_grad(
        lambda p, a, b: jax_loss_fn(p, a, b, training=False), has_aux=True))
    (ref, _), grads = f(params, jnp.asarray(x), jnp.asarray(y))
    logits = model(torch.from_numpy(x))
    loss = TL.softmax_cross_entropy(logits, torch.from_numpy(y)).mean()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref), rtol=1e-5, atol=1e-5)
    want = TL.state_from_jax(numpy_tree(grads), stacked)
    for name, p in model.named_parameters():
        scaled_close(p.grad.numpy(), want[name], rel, name)
