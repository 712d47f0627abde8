"""Inception V3: the port of ``horovod_tpu/models/inception.py`` (``init``,
``apply`` as ``Inception.forward``, ``loss_fn``), with the same stem and
block specs (the canonical V3 channel counts, no auxiliary head).

NHWC batches in, NCHW in ``channels_last`` memory inside, so the
branches concatenate along dim 1.  The average pool of the ``pool``
branches divides by the count of cells inside the image
(``layers.avgpool``), the max pools are ``VALID``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Union

import torch
import torch.nn as nn

from .. import runtime as _rt
from . import layers as L

Tensor = torch.Tensor


# A block spec maps a branch to its conv steps (name, kh, kw, cout,
# stride, padding); "maxpool" is a bare max pool, "pool" starts with an
# average pool.
def _inc_a(pool_features):
    return {
        "b1": [("c1", 1, 1, 64, 1, "SAME")],
        "b2": [("c1", 1, 1, 48, 1, "SAME"), ("c2", 5, 5, 64, 1, "SAME")],
        "b3": [("c1", 1, 1, 64, 1, "SAME"), ("c2", 3, 3, 96, 1, "SAME"),
               ("c3", 3, 3, 96, 1, "SAME")],
        "pool": [("c1", 1, 1, pool_features, 1, "SAME")],
    }


def _inc_b():  # grid reduction 35 -> 17
    return {
        "b1": [("c1", 3, 3, 384, 2, "VALID")],
        "b2": [("c1", 1, 1, 64, 1, "SAME"), ("c2", 3, 3, 96, 1, "SAME"),
               ("c3", 3, 3, 96, 2, "VALID")],
        "maxpool": [],
    }


def _inc_c(c7):
    return {
        "b1": [("c1", 1, 1, 192, 1, "SAME")],
        "b2": [("c1", 1, 1, c7, 1, "SAME"), ("c2", 1, 7, c7, 1, "SAME"),
               ("c3", 7, 1, 192, 1, "SAME")],
        "b3": [("c1", 1, 1, c7, 1, "SAME"), ("c2", 7, 1, c7, 1, "SAME"),
               ("c3", 1, 7, c7, 1, "SAME"), ("c4", 7, 1, c7, 1, "SAME"),
               ("c5", 1, 7, 192, 1, "SAME")],
        "pool": [("c1", 1, 1, 192, 1, "SAME")],
    }


def _inc_d():  # grid reduction 17 -> 8
    return {
        "b1": [("c1", 1, 1, 192, 1, "SAME"), ("c2", 3, 3, 320, 2, "VALID")],
        "b2": [("c1", 1, 1, 192, 1, "SAME"), ("c2", 1, 7, 192, 1, "SAME"),
               ("c3", 7, 1, 192, 1, "SAME"), ("c4", 3, 3, 192, 2, "VALID")],
        "maxpool": [],
    }


def _inc_e():
    return {
        "b1": [("c1", 1, 1, 320, 1, "SAME")],
        # b2/b3 fan out into parallel 1x3 and 3x1 convs (b2a/b2b, b3a/b3b)
        "b2": [("c1", 1, 1, 384, 1, "SAME")],
        "b2a": [("c1", 1, 3, 384, 1, "SAME")],
        "b2b": [("c1", 3, 1, 384, 1, "SAME")],
        "b3": [("c1", 1, 1, 448, 1, "SAME"), ("c2", 3, 3, 384, 1, "SAME")],
        "b3a": [("c1", 1, 3, 384, 1, "SAME")],
        "b3b": [("c1", 3, 1, 384, 1, "SAME")],
        "pool": [("c1", 1, 1, 192, 1, "SAME")],
    }


# (name, spec, kind): kind drives how the branches concatenate
BLOCKS = (
    ("a0", _inc_a(32), "a"),
    ("a1", _inc_a(64), "a"),
    ("a2", _inc_a(64), "a"),
    ("b0", _inc_b(), "reduce"),
    ("c0", _inc_c(128), "a"),
    ("c1", _inc_c(160), "a"),
    ("c2", _inc_c(160), "a"),
    ("c3", _inc_c(192), "a"),
    ("d0", _inc_d(), "reduce"),
    ("e0", _inc_e(), "e"),
    ("e1", _inc_e(), "e"),
)

STEM = (  # (name, kh, kw, cout, stride, padding, pool_after)
    ("s0", 3, 3, 32, 2, "VALID", False),
    ("s1", 3, 3, 32, 1, "VALID", False),
    ("s2", 3, 3, 64, 1, "SAME", True),
    ("s3", 1, 1, 80, 1, "VALID", False),
    ("s4", 3, 3, 192, 1, "VALID", True),
)


def _branch(steps, cin: int, dtype, device):
    m = nn.ModuleDict({name: L.ConvBN(kh, kw, c, cout, dtype, device)
                       for (name, kh, kw, cout, _s, _p), c in zip(
                           steps, [cin] + [s[3] for s in steps])})
    return m, (steps[-1][3] if steps else cin)


def _run(branch: nn.ModuleDict, steps, x: Tensor, training: bool, group
         ) -> Tensor:
    for (name, _kh, _kw, _cout, stride, padding) in steps:
        x = branch[name](x, stride, padding, training, group)
    return x


class Inception(nn.Module):
    def __init__(self, classes: int = 1000,
                 dtype: torch.dtype = torch.float32,
                 device: Union[str, torch.device, None] = None):
        super().__init__()
        device = _rt.resolve_device(device)
        cin = 3
        for (name, kh, kw, cout, _s, _p, _pool) in STEM:
            self.add_module(name, L.ConvBN(kh, kw, cin, cout, dtype, device))
            cin = cout
        for (bname, spec, kind) in BLOCKS:
            block, width = nn.ModuleDict(), {}
            for branch, steps in spec.items():
                # the e-block's fan-outs (b2a, b2b, ...) read b2's output
                src = (width[branch[:-1]]
                       if kind == "e" and branch.endswith(("a", "b")) else cin)
                block[branch], width[branch] = _branch(steps, src, dtype,
                                                       device)
            self.add_module(bname, block)
            if kind == "e":  # b2 and b3 feed only their fan-outs
                width.pop("b2"), width.pop("b3")
            cin = sum(width.values())
        self.head = L.Dense(cin, classes, dtype, device)

    def forward(self, x: Tensor, training: bool = False, group=None
                ) -> Tensor:
        """``x`` ``[N, H, W, 3]`` (299 canonical; any size that survives
        the stem's VALID stages) -> logits."""
        y = x.permute(0, 3, 1, 2)
        for (name, _kh, _kw, _c, stride, padding, pool_after) in STEM:
            y = getattr(self, name)(y, stride, padding, training, group)
            if pool_after:
                y = L.maxpool(y, 3, 2, "VALID")
        for (bname, spec, kind) in BLOCKS:
            block = getattr(self, bname)

            def run(branch, src):
                return _run(block[branch], spec[branch], src, training,
                            group)
            if kind == "e":
                t2, t3 = run("b2", y), run("b3", y)
                outs = [run("b1", y), run("b2a", t2), run("b2b", t2),
                        run("b3a", t3), run("b3b", t3),
                        run("pool", L.avgpool(y))]
            else:
                outs = [L.maxpool(y, 3, 2, "VALID") if branch == "maxpool"
                        else run(branch, L.avgpool(y) if branch == "pool"
                                 else y)
                        for branch in spec]
            y = torch.cat(outs, dim=1)
        return self.head(y.mean((2, 3)))


def init(classes: int = 1000, dtype: torch.dtype = torch.float32,
         generator: Optional[torch.Generator] = None,
         device: Union[str, torch.device, None] = None) -> Inception:
    return L.init_weights(Inception(classes, dtype, device), generator)


def loss_fn(model: Inception, x: Tensor, y: Tensor, training: bool = True,
            group=None) -> Tensor:
    return L.softmax_cross_entropy(model(x, training, group), y).mean()


def params_from_jax(tree: Dict[str, Any],
                    device: Union[str, torch.device, None] = None) -> Inception:
    """A model holding a JAX ``inception.init`` tree's weights and BN
    statistics (numpy leaves), at the dtype of the tree's convs."""
    state = L.state_from_jax(tree)
    dtype = L.to_tensor(state["s0.conv.weight"]).dtype
    return L.load_state(Inception(state["head.weight"].shape[0], dtype,
                                  device), state)
