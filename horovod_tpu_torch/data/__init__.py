"""Data loader utilities, the port of ``horovod_tpu/data`` (reference:
horovod/data/data_loader_base.py)."""

from .fs import BaseFS, LocalFS
from .loader import (AsyncDataLoaderMixin, AsyncImageFolderDataLoader,
                     AsyncNumpyDataLoader, AsyncParquetDataLoader,
                     AsyncStreamingParquetDataLoader, BaseDataLoader,
                     CudaTransfer, ImageFolderDataLoader, NumpyDataLoader,
                     ParquetDataLoader, ShuffleBufferLoader,
                     StreamingParquetDataLoader, list_parquet_files,
                     prefetch, shard_indices)

__all__ = ["BaseDataLoader", "AsyncDataLoaderMixin", "NumpyDataLoader",
           "AsyncNumpyDataLoader", "ParquetDataLoader",
           "AsyncParquetDataLoader", "StreamingParquetDataLoader",
           "AsyncStreamingParquetDataLoader", "ImageFolderDataLoader",
           "AsyncImageFolderDataLoader", "ShuffleBufferLoader", "BaseFS",
           "LocalFS", "CudaTransfer", "list_parquet_files",
           "prefetch", "shard_indices"]
