"""A time limit for a test that places tasks in this process
(``spark.run``, ``RayExecutor``, ``ElasticRayExecutor``): SIGALRM raises
in the main thread at the deadline, wherever the caller waits, so the
executor's own cleanup ends its tasks and the test fails by name."""

from __future__ import annotations

import contextlib
import signal

import pytest


class DeadlineExceeded(BaseException):
    """Not an Exception: no ``except Exception`` on the way swallows it."""


@contextlib.contextmanager
def deadline(seconds: float, what: str):
    def expire(signum, frame):
        raise DeadlineExceeded(f"{what} did not end in {seconds} s")

    previous = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    except DeadlineExceeded as e:
        pytest.fail(str(e))
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, previous)
