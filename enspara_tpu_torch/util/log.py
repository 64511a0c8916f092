"""Lightweight timing helpers.

``timed`` mirrors the reference's context manager (enspara/util/log.py:5)
and is used to wrap hot sections throughout the framework.
"""

import logging
import time
from contextlib import contextmanager

logger = logging.getLogger(__name__)


@contextmanager
def timed(tick_msg, log_func=logger.debug):
    """Context manager that logs the wall time of its block.

    Parameters
    ----------
    tick_msg : str
        printf-style format string with one ``%s``/``%f``-style slot that
        receives the elapsed seconds.
    log_func : callable
        Logging function, e.g. ``logger.info`` or ``print``.
    """
    tick = time.perf_counter()
    yield
    tock = time.perf_counter()
    if log_func is not None:
        log_func(tick_msg, tock - tick)


def setup_logging(level=logging.INFO):
    logging.basicConfig(
        level=level,
        format='%(asctime)s %(name)s %(levelname)s %(message)s')
