"""VGG-16/19 with BatchNorm: the port of ``horovod_tpu/models/vgg.py``
(``init``, ``apply`` as ``VGG.forward``, ``features``, ``loss_fn``).

Stages of 3x3 conv -> BN -> relu, each closed by a 2x2 max pool, then the
4096-wide classifier.  NHWC batches in, NCHW inside (``layers.nchw``:
``channels_last`` memory on a card).  A trunk output other than 7x7 is
resized to 7x7 as ``jax.image.resize(..., "linear")`` does
(``layers.resize_linear``), and flattened in the JAX model's (h, w, c)
order, so ``fc1`` takes the JAX kernel's rows as they are.  The stacked
``s{i}rest`` convs of the JAX tree are the port's ``s{i}c1``, ``s{i}c2``,
...
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from .. import runtime as _rt
from . import layers as L

Tensor = torch.Tensor

STAGE_CHANNELS = (64, 128, 256, 512, 512)
STAGE_CONVS = {
    16: (2, 2, 3, 3, 3),
    19: (2, 2, 4, 4, 4),
}


class VGG(nn.Module):
    def __init__(self, depth: int = 16, classes: int = 1000,
                 dtype: torch.dtype = torch.float32,
                 device: Union[str, torch.device, None] = None):
        super().__init__()
        if depth not in STAGE_CONVS:
            raise ValueError(f"unsupported depth {depth}")
        device = _rt.resolve_device(device)
        self.depth = depth
        self.stages = []
        cin = 3
        for stage, (cout, n) in enumerate(zip(STAGE_CHANNELS,
                                              STAGE_CONVS[depth])):
            names = []
            for j in range(n):
                names.append(f"s{stage}c{j}")
                self.add_module(names[-1], L.ConvBN(3, 3, cin, cout, dtype,
                                                    device))
                cin = cout
            self.stages.append(names)
        self.fc1 = L.Dense(512 * 7 * 7, 4096, dtype, device)
        self.fc2 = L.Dense(4096, 4096, dtype, device)
        self.head = L.Dense(4096, classes, dtype, device)

    def trunk(self, x: Tensor, training: bool = False, group=None
              ) -> Tensor:
        """``x`` ``[N, H, W, 3]`` -> the last stage's ``[N, 512, H/32,
        W/32]``."""
        y = L.nchw(x)
        for names in self.stages:
            for name in names:
                y = getattr(self, name)(y, training=training, group=group)
            y = L.maxpool(y, 2, 2, "VALID")
        return y

    def forward(self, x: Tensor, training: bool = False, group=None
                ) -> Tensor:
        y = self.trunk(x, training, group)
        if tuple(y.shape[2:]) != (7, 7):  # a 224 input lands on 7x7
            y = L.resize_linear(y, 7, 7)
        y = y.permute(0, 2, 3, 1).reshape(y.shape[0], -1)  # (h, w, c)
        y = F.relu(self.fc1(y))
        y = F.relu(self.fc2(y))
        return self.head(y)


def features(model: VGG, x: Tensor, training: bool = False, group=None
             ) -> Tensor:
    """The conv trunk, globally pooled: ``[N, 512]``."""
    return model.trunk(x, training, group).mean((2, 3))


def init(depth: int = 16, classes: int = 1000,
         dtype: torch.dtype = torch.float32,
         generator: Optional[torch.Generator] = None,
         device: Union[str, torch.device, None] = None) -> VGG:
    return L.init_weights(VGG(depth, classes, dtype, device), generator)


def loss_fn(model: VGG, x: Tensor, y: Tensor, training: bool = True,
            group=None) -> Tensor:
    return L.softmax_cross_entropy(model(x, training, group), y).mean()


def params_from_jax(tree: Dict[str, Any], depth: int = 16,
                    device: Union[str, torch.device, None] = None) -> VGG:
    """A model holding a JAX ``vgg.init`` tree's weights and BN statistics
    (numpy leaves), at the dtype of the tree's convs."""
    state = L.state_from_jax(tree, stacked="c")
    dtype = L.to_tensor(state["s0c0.conv.weight"]).dtype
    return L.load_state(VGG(depth, state["head.weight"].shape[0], dtype,
                            device), state)
