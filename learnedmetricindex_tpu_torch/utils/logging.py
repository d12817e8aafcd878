"""Logging utilities (the port's copy of the JAX package's).

Every class gets a module-qualified stdlib logger, and ``log_runtime``
wraps a method to log its wall-clock time with a format-string message,
as the reference's logging layer does.
"""

from __future__ import annotations

import functools
import logging
import time

LOG_FORMAT = "[%(asctime)s][%(levelname)-5.5s][%(name)-.40s] %(message)s"


def configure_logging(level: int = logging.INFO) -> None:
    logging.basicConfig(level=level, format=LOG_FORMAT)


class Logger:
    """Mixin exposing a per-class logger."""

    @property
    def logger(self) -> logging.Logger:
        component = f"{type(self).__module__}.{type(self).__name__}"
        return logging.getLogger(component)


def log_runtime(level: int, message: str):
    """Decorator logging the runtime of the wrapped method.

    The wrapped function must be a method of a class with a ``logger``
    property; ``message`` must contain a ``{}`` placeholder for the
    elapsed seconds.
    """

    def decorator(func):
        @functools.wraps(func)
        def wrapper(self, *args, **kwargs):
            start = time.perf_counter()
            result = func(self, *args, **kwargs)
            self.logger.log(level, message.format(time.perf_counter() - start))
            return result

        return wrapper

    return decorator
