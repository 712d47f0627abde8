"""ResNet v1.5 (ResNet-18/50/101/152): the port of
``horovod_tpu/models/resnet.py`` (``init``, ``apply`` as
``ResNet.forward``, ``loss_fn``).

Bottleneck blocks with the stride in the 3x3 (v1.5), BatchNorm after each
conv.  The model takes the JAX package's NHWC batch ``[N, H, W, 3]`` and
runs NCHW in ``channels_last`` memory.  Where the JAX model stacks the
shape-identical blocks of a stage for one ``lax.scan`` (``s{i}rest``),
the port keeps one module a block, ``s{i}b{j}``; ``params_from_jax``
unstacks them.  BN running statistics are buffers the training forward
moves in place (the JAX ``new_params``); conv and dense weights take the
model's dtype, BN stays fp32.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from .. import runtime as _rt
from . import layers as L

Tensor = torch.Tensor

STAGES = {
    18: (2, 2, 2, 2),
    50: (3, 4, 6, 3),
    101: (3, 4, 23, 3),
    152: (3, 8, 36, 3),
}


class Bottleneck(nn.Module):
    def __init__(self, cin: int, width: int, stride: int, dtype, device):
        super().__init__()
        cout = width * 4
        self.stride = stride
        self.conv1 = L.Conv(1, 1, cin, width, dtype, device)
        self.bn1 = L.BatchNorm(width, device)
        self.conv2 = L.Conv(3, 3, width, width, dtype, device)
        self.bn2 = L.BatchNorm(width, device)
        self.conv3 = L.Conv(1, 1, width, cout, dtype, device)
        self.bn3 = L.BatchNorm(cout, device)
        if stride != 1 or cin != cout:
            self.proj = L.Conv(1, 1, cin, cout, dtype, device)
            self.bn_proj = L.BatchNorm(cout, device)
        else:
            self.proj = None

    def forward(self, x: Tensor, training: bool, group) -> Tensor:
        y = F.relu(self.bn1(self.conv1(x), training, group))
        y = F.relu(self.bn2(self.conv2(y, self.stride), training, group))
        y = self.bn3(self.conv3(y), training, group)
        if self.proj is not None:
            x = self.bn_proj(self.proj(x, self.stride), training, group)
        return F.relu(y + x)


class ResNet(nn.Module):
    def __init__(self, depth: int = 50, classes: int = 1000,
                 dtype: torch.dtype = torch.float32,
                 device: Union[str, torch.device, None] = None):
        super().__init__()
        if depth not in STAGES:
            raise ValueError(f"unsupported depth {depth}")
        device = _rt.resolve_device(device)
        self.depth = depth
        self.stem = L.Conv(7, 7, 3, 64, dtype, device)
        self.bn_stem = L.BatchNorm(64, device)
        self.blocks = []
        cin = 64
        for stage, nblocks in enumerate(STAGES[depth]):
            width = 64 * 2 ** stage
            for j in range(nblocks):
                stride = 2 if stage > 0 and j == 0 else 1
                name = f"s{stage}b{j}"
                self.add_module(name, Bottleneck(cin, width, stride, dtype,
                                                 device))
                self.blocks.append(name)
                cin = width * 4
        self.head = L.Dense(cin, classes, dtype, device)

    def forward(self, x: Tensor, training: bool = False, group=None
                ) -> Tensor:
        """``x`` ``[N, H, W, 3]`` -> logits; ``training`` uses the batch
        statistics and moves the running ones, over ``group`` when it has
        more than one rank."""
        y = self.stem(x.permute(0, 3, 1, 2), 2)
        y = F.relu(self.bn_stem(y, training, group))
        y = L.maxpool(y, 3, 2, "SAME")
        for name in self.blocks:
            y = getattr(self, name)(y, training, group)
        return self.head(y.mean((2, 3)))


def init(depth: int = 50, classes: int = 1000,
         dtype: torch.dtype = torch.float32,
         generator: Optional[torch.Generator] = None,
         device: Union[str, torch.device, None] = None) -> ResNet:
    """A model with the JAX package's initial distributions (He-normal
    convs, N(0, 1/in) dense, BN ones and zeros)."""
    return L.init_weights(ResNet(depth, classes, dtype, device), generator)


def loss_fn(model: ResNet, x: Tensor, y: Tensor, training: bool = True,
            group=None) -> Tensor:
    return L.softmax_cross_entropy(model(x, training, group), y).mean()


def params_from_jax(tree: Dict[str, Any], depth: int = 50,
                    device: Union[str, torch.device, None] = None) -> ResNet:
    """A model holding a JAX ``resnet.init`` tree's weights and BN
    statistics (numpy leaves), at the dtype of the tree's convs."""
    state = L.state_from_jax(tree, stacked="b")
    head = state["head.weight"]
    dtype = L.to_tensor(state["stem.weight"]).dtype
    return L.load_state(ResNet(depth, head.shape[0], dtype, device), state)
