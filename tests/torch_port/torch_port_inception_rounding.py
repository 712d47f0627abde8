"""Why the port's CNNs run NCHW contiguous on the CPU (``models/layers.py``
``nchw``): Inception V3 at ``test_torch_zoo_inception.py``'s size, its
gradients in fp32 against the same model in float64, in ``channels_last``
and in contiguous memory, on one thread and on the default count; the
rounding of each of its convolutions on its own, relative to the sum of
|w||x| at the worst output; and the ReLU inputs whose sign fp32 gets
wrong.

    JAX_PLATFORMS=cpu python tests/torch_port/torch_port_inception_rounding.py

(the JAX package only draws the weights' shapes, as the tests do)."""

import os
import sys

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from horovod_tpu.models import inception as JI  # noqa: E402
from horovod_tpu_torch.models import inception as TI  # noqa: E402
from horovod_tpu_torch.models import layers as TL  # noqa: E402
from torch_port_zoo import nhwc, numpy_params  # noqa: E402


def grads(params, x, y, dtype, fmt):
    model = TI.params_from_jax(params, device="cpu").to(dtype)
    inp = TL.nchw(torch.from_numpy(x).to(dtype)).contiguous(
        memory_format=fmt)
    logits = model.head(_trunk(model, inp).mean((2, 3)))
    TL.softmax_cross_entropy(logits, torch.from_numpy(y)).mean().backward()
    return {n: p.grad.double() for n, p in model.named_parameters()}


def _trunk(model, y):
    """``Inception.forward`` after its NHWC permute, on an NCHW ``y``."""
    for (name, _kh, _kw, _c, stride, padding, pool_after) in TI.STEM:
        y = getattr(model, name)(y, stride, padding)
        if pool_after:
            y = TL.maxpool(y, 3, 2, "VALID")
    for (bname, spec, kind) in TI.BLOCKS:
        block = getattr(model, bname)

        def run(branch, src):
            return TI._run(block[branch], spec[branch], src, False, None)
        if kind == "e":
            t2, t3 = run("b2", y), run("b3", y)
            outs = [run("b1", y), run("b2a", t2), run("b2b", t2),
                    run("b3a", t3), run("b3b", t3),
                    run("pool", TL.avgpool(y))]
        else:
            outs = [TL.maxpool(y, 3, 2, "VALID") if branch == "maxpool"
                    else run(branch, TL.avgpool(y) if branch == "pool"
                             else y) for branch in spec]
        y = torch.cat(outs, dim=1)
    return y


def conv_rounding(params, x):
    """Each convolution's worst error against float64 over the sum of
    |w||x| there, in both layouts, on the forward's own inputs."""
    model = TI.params_from_jax(params, device="cpu")
    plain = F.conv2d
    worst = {"channels_last": [], "contiguous": []}

    def conv2d(inp, w, stride=1, padding=0):
        exact = plain(inp.double(), w.double(), stride=stride,
                      padding=padding)
        cond = plain(inp.double().abs(), w.double().abs(), stride=stride,
                     padding=padding).max().item()
        for name, fmt in (("channels_last", torch.channels_last),
                          ("contiguous", torch.contiguous_format)):
            got = plain(inp.contiguous(memory_format=fmt),
                        w.contiguous(memory_format=fmt), stride=stride,
                        padding=padding)
            worst[name].append((got.double() - exact).abs().max().item()
                               / cond)
        return plain(inp, w, stride=stride, padding=padding)
    F.conv2d = conv2d
    try:
        with torch.no_grad():
            model(torch.from_numpy(x))
    finally:
        F.conv2d = plain
    return {k: (float(np.median(v)), max(v)) for k, v in worst.items()}


def relu_flips(params, x, fmt):
    """The BN outputs (ReLU inputs) whose sign differs between fp32 in
    memory format ``fmt`` and float64: (module, index, fp32, float64)."""
    outs = {}
    for dtype in (torch.float32, torch.float64):
        model = TI.params_from_jax(params, device="cpu").to(dtype)
        seen = outs[dtype] = {}
        for name, mod in model.named_modules():
            if isinstance(mod, TL.BatchNorm):
                mod.register_forward_hook(
                    lambda m, a, out, name=name: seen.__setitem__(
                        name, out.detach().double()))
        with torch.no_grad():
            inp = TL.nchw(torch.from_numpy(x).to(dtype))
            _trunk(model, inp.contiguous(memory_format=fmt))
    flips = []
    for name, want in outs[torch.float64].items():
        got = outs[torch.float32][name]
        for idx in ((got > 0) != (want > 0)).nonzero().tolist():
            idx = tuple(idx)
            flips.append((name, idx, got[idx].item(), want[idx].item()))
    return flips


def main():
    params = numpy_params(lambda k: JI.init(k, classes=10))
    x, y = nhwc(np.random.RandomState(0), 2, 139, 10)
    default = torch.get_num_threads()
    for threads in (1, default):
        torch.set_num_threads(threads)
        ref = grads(params, x, y, torch.float64, torch.contiguous_format)
        for name, fmt in (("channels_last", torch.channels_last),
                          ("contiguous", torch.contiguous_format)):
            got = grads(params, x, y, torch.float32, fmt)
            errs = {n: ((got[n] - ref[n]).abs().max()
                        / ref[n].abs().max()).item() for n in ref}
            print(f"{threads} thread(s), {name}: s0.conv.weight "
                  f"{errs['s0.conv.weight']:.3g} of its largest magnitude; "
                  f"{sum(e > 1e-4 for e in errs.values())} of {len(errs)} "
                  f"gradients beyond 1e-4, the worst {max(errs.values()):.3g}")
        for name, (med, top) in conv_rounding(params, x).items():
            print(f"{threads} thread(s), {name} convolutions: error over "
                  f"sum |w||x|, median {med:.3g}, worst {top:.3g}")
        for name, fmt in (("channels_last", torch.channels_last),
                          ("contiguous", torch.contiguous_format)):
            flips = relu_flips(params, x, fmt)
            print(f"{threads} thread(s), {name}: {len(flips)} ReLU input(s) "
                  "of another sign than in float64"
                  + "".join(f"; {m}{list(i)}: {a:.3g} against {b:.3g}"
                            for m, i, a, b in flips))
    torch.set_num_threads(default)


if __name__ == "__main__":
    main()
