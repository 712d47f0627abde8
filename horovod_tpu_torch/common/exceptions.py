"""Exception types shared across the framework: the port's own copy of
``horovod_tpu/common/exceptions.py``.

Mirrors the reference's two elastic control-flow exceptions (reference:
horovod/common/exceptions.py:1-49) plus error types the coordinator surfaces
for inconsistent collective submissions (reference: controller.cc:482-707).
"""

from __future__ import annotations


class HorovodInternalError(RuntimeError):
    """Hard failure inside a collective (peer died / mesh broke).

    In elastic mode this triggers a full reset: shutdown, re-rendezvous,
    re-init, ``state.restore()`` (reference: common/elastic.py:151-175).
    """


class HostsUpdatedInterrupt(Exception):
    """Raised at a commit/check point when the host set changed.

    Soft reset: live state is kept, only the mesh is rebuilt
    (reference: common/elastic.py:60-97).
    """

    def __init__(self, skip_sync: bool = False):
        super().__init__("hosts updated")
        self.skip_sync = skip_sync


class TensorShapeMismatchError(ValueError):
    """Ranks submitted the same tensor name with different shapes
    (reference: controller.cc:540-580 builds an ERROR response)."""


class TensorDtypeMismatchError(TypeError):
    """Ranks submitted the same tensor name with different dtypes
    (reference: controller.cc:506-538)."""


class DuplicateTensorNameError(ValueError):
    """A tensor name was submitted twice before completing
    (reference: common.h:169 DUPLICATE_NAME_ERROR, tensor_queue.cc)."""


class StallError(RuntimeError):
    """The stall inspector hit HOROVOD_STALL_SHUTDOWN_TIME_SECONDS
    (reference: stall_inspector.h:70-82)."""
