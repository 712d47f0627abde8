"""Gradient compression: the port of ``horovod_tpu/ops/compression.py``
(the reference's compressor surface): ``Compression.none``,
``Compression.fp16`` and ``Compression.bf16``, each with
``compress(tensor) -> (tensor, ctx)`` and ``decompress(tensor, ctx)``,
and ``Compression.by_name`` for the cast formats of the wire plane
(``ops/wire.py``).  The eager API's ``torch/compression.py`` re-exports
these classes.  The casts run on the caller's stream and round to
nearest even, as XLA's do.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch


class Compressor:
    """Interface for compressing and decompressing a given tensor."""

    @staticmethod
    def compress(tensor: torch.Tensor) -> Tuple[torch.Tensor, Any]:
        raise NotImplementedError

    @staticmethod
    def decompress(tensor: torch.Tensor, ctx: Any) -> torch.Tensor:
        raise NotImplementedError


class NoneCompressor(Compressor):
    @staticmethod
    def compress(tensor):
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        return tensor


class FP16Compressor(Compressor):
    """Cast floating tensors to fp16 for the wire (reference:
    torch/compression.py FP16Compressor)."""

    @staticmethod
    def compress(tensor):
        if tensor.dtype.is_floating_point:
            return tensor.to(torch.float16), tensor.dtype
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        return tensor.to(ctx) if ctx is not None else tensor


class BF16Compressor(Compressor):
    """bfloat16 wire compression (an addition of the JAX package: bf16
    keeps fp32's exponent range)."""

    @staticmethod
    def compress(tensor):
        if tensor.dtype.is_floating_point and tensor.dtype != torch.bfloat16:
            return tensor.to(torch.bfloat16), tensor.dtype
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        return tensor.to(ctx) if ctx is not None else tensor


class Compression:
    """Optional gradient compression algorithm used during allreduce
    (reference: horovod/torch/compression.py Compression namespace)."""
    none = NoneCompressor
    fp16 = FP16Compressor
    bf16 = BF16Compressor

    @staticmethod
    def by_name(name: str) -> type:
        """Wire-format name -> compressor (the cast formats of the wire
        plane, ops/wire.py)."""
        try:
            return {"none": NoneCompressor, "fp16": FP16Compressor,
                    "bf16": BF16Compressor}[name]
        except KeyError:
            raise ValueError(f"no compressor named {name!r}") from None
