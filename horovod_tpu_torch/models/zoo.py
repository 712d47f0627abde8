"""The CNN training recipe of the JAX package's CNN benchmark (``bench.py``
``CNN_FAMILIES`` and ``resnet_bench``) on the port.

Each family trains data-parallel with SGD (momentum 0.9) at its learning
rate and canonical image size, 64 images a card (VGG-16: 32), weights in
bf16 on the card (BN parameters and statistics fp32).  The step is the
port's ``make_train_step`` over this rank's rows, with the optimizer
(wrapped in ``DistributedOptimizer``) averaging the gradients; the
forward moves the BN running statistics, over the whole process group
when it has more than one rank (sync-BN).
"""

from __future__ import annotations

import importlib
from typing import Callable, NamedTuple, Optional, Union

import torch
import torch.distributed as dist

from ..parallel.data_parallel import make_train_step


class Family(NamedTuple):
    module: str           # horovod_tpu_torch.models.<module>
    kwargs: dict          # its init / params_from_jax arguments
    fwd_flops: float      # forward FLOPs an image at the canonical size
    size: int             # canonical image size
    cpu_size: int         # the size a CPU run takes
    lr: float
    batch: int            # images a card


# forward FLOPs are the published numbers (torchvision/tf-slim), as bench.py
CNN_FAMILIES = {
    "resnet50": Family("resnet", {"depth": 50}, 4.089e9, 224, 64, 0.1, 64),
    "resnet101": Family("resnet", {"depth": 101}, 7.80e9, 224, 64, 0.1, 64),
    "vgg16": Family("vgg", {"depth": 16}, 15.47e9, 224, 64, 0.01, 32),
    "inception3": Family("inception", {}, 5.73e9, 299, 139, 0.1, 64),
}


def module(family: str):
    return importlib.import_module(
        f"{__package__}.{CNN_FAMILIES[family].module}")


def cnn_init(family: str, classes: int = 1000,
             dtype: torch.dtype = torch.bfloat16,
             generator: Optional[torch.Generator] = None,
             device: Union[str, torch.device, None] = None):
    """The family's model, initialized as the JAX package's ``init``."""
    return module(family).init(classes=classes, dtype=dtype,
                               generator=generator, device=device,
                               **CNN_FAMILIES[family].kwargs)


def sync_group():
    """The process group BN statistics span: the world when it has more
    than one rank, else None (local statistics)."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        return dist.group.WORLD
    return None


def make_cnn_train_step(family: str, model,
                        optimizer: torch.optim.Optimizer) -> Callable:
    """``step(x, y) -> loss``: ``x`` the global batch ``[N, H, W, 3]``,
    ``y`` its labels; this rank trains on its rows with sync-BN, and the
    loss returned is the mean over ranks."""
    loss_fn, group = module(family).loss_fn, sync_group()
    return make_train_step(
        model, lambda m, x, y: loss_fn(m, x, y, training=True, group=group),
        optimizer)
