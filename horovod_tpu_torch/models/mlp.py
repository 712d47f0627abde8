"""The MNIST MLP: the port of ``horovod_tpu/models/mlp.py`` (``init``,
``apply`` as ``MLP.forward``, ``loss_fn``), the classifier of BASELINE
config 1 trained data-parallel."""

from __future__ import annotations

from typing import Any, Dict, Optional, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from .. import runtime as _rt
from . import layers as L

Tensor = torch.Tensor


class MLP(nn.Module):
    def __init__(self, in_dim: int = 784, hidden: int = 512,
                 classes: int = 10, dtype: torch.dtype = torch.float32,
                 device: Union[str, torch.device, None] = None):
        super().__init__()
        device = _rt.resolve_device(device)
        self.fc1 = L.Dense(in_dim, hidden, dtype, device)
        self.fc2 = L.Dense(hidden, hidden, dtype, device)
        self.out = L.Dense(hidden, classes, dtype, device)

    def forward(self, x: Tensor) -> Tensor:
        x = x.reshape(x.shape[0], -1)
        x = F.relu(self.fc1(x))
        x = F.relu(self.fc2(x))
        return self.out(x)


def init(in_dim: int = 784, hidden: int = 512, classes: int = 10,
         dtype: torch.dtype = torch.float32,
         generator: Optional[torch.Generator] = None,
         device: Union[str, torch.device, None] = None) -> MLP:
    return L.init_weights(MLP(in_dim, hidden, classes, dtype, device),
                          generator)


def loss_fn(model: MLP, x: Tensor, y: Tensor) -> Tensor:
    return L.softmax_cross_entropy(model(x), y).mean()


def params_from_jax(tree: Dict[str, Any],
                    device: Union[str, torch.device, None] = None) -> MLP:
    """An MLP holding a JAX ``mlp.init`` tree's weights (numpy leaves), at
    their dtype."""
    state = L.state_from_jax(tree)
    w1, w2 = state["fc1.weight"], state["out.weight"]
    dtype = L.to_tensor(w1).dtype
    return L.load_state(MLP(w1.shape[1], w1.shape[0], w2.shape[0], dtype,
                            device), state)
