"""Gradient compression for the eager torch API (the port of
``horovod_tpu/torch/compression.py``): the classes of ``ops/compression.py``,
re-exported under the reference's ``horovod.torch.compression`` path."""

from ..ops.compression import (BF16Compressor, Compression, Compressor,
                               FP16Compressor, NoneCompressor)

__all__ = ["Compression", "Compressor", "NoneCompressor", "FP16Compressor",
           "BF16Compressor"]
