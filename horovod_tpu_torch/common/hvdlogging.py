"""Leveled, per-rank-prefixed logging: the port's copy of
``horovod_tpu/common/hvdlogging.py``.

Mirrors the reference's C++ logger semantics (reference:
horovod/common/logging.cc:39-95): levels trace..fatal selected by
``HOROVOD_LOG_LEVEL``, optional timestamp suppression via
``HOROVOD_LOG_HIDE_TIME``, and a ``[rank]`` prefix on every line.  The
logger is built on first use from the environment the launcher stamped.
"""

from __future__ import annotations

import logging
import os
import sys

TRACE = 5
logging.addLevelName(TRACE, "TRACE")

_LEVELS = {
    "trace": TRACE,
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "fatal": logging.CRITICAL,
}

_logger: logging.Logger | None = None


class _RankFilter(logging.Filter):
    def filter(self, record: logging.LogRecord) -> bool:
        record.hvd_rank = os.environ.get("HOROVOD_RANK", "-")
        return True


def get_logger() -> logging.Logger:
    global _logger
    if _logger is not None:
        return _logger
    logger = logging.getLogger("horovod_tpu_torch")
    level = _LEVELS.get(os.environ.get("HOROVOD_LOG_LEVEL", "warning").lower(),
                        logging.WARNING)
    logger.setLevel(level)
    handler = logging.StreamHandler(sys.stderr)
    hide_time = os.environ.get("HOROVOD_LOG_HIDE_TIME", "").lower() in (
        "1", "true", "yes", "on")
    fmt = "[%(hvd_rank)s]<%(levelname)s> %(message)s" if hide_time else \
        "%(asctime)s [%(hvd_rank)s]<%(levelname)s> %(message)s"
    handler.setFormatter(logging.Formatter(fmt))
    handler.addFilter(_RankFilter())
    logger.addHandler(handler)
    logger.propagate = False
    _logger = logger
    return logger


def trace(msg: str, *args) -> None:
    get_logger().log(TRACE, msg, *args)


def debug(msg: str, *args) -> None:
    get_logger().debug(msg, *args)


def info(msg: str, *args) -> None:
    get_logger().info(msg, *args)


def warning(msg: str, *args) -> None:
    get_logger().warning(msg, *args)


def error(msg: str, *args) -> None:
    get_logger().error(msg, *args)
