"""Lightweight timing helpers (counterpart of ``enspara_tpu/util/log.py``).

``timed`` mirrors the reference's context manager (enspara/util/log.py:5)
and is used to wrap hot sections throughout the framework;
``trace_region`` names a region in a ``torch.profiler`` trace, and
``device_memory_stats`` reports each visible card's memory.
"""

import logging
import time
from contextlib import contextmanager

import torch

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


@contextmanager
def trace_region(name):
    """A named region in a ``torch.profiler`` trace
    (``torch.profiler.record_function``); it costs next to nothing when
    no profiler runs."""
    with torch.profiler.record_function(name):
        yield


def device_memory_stats():
    """Memory of each visible CUDA card, in bytes, under the JAX
    package's keys: ``{'cuda:0': {'bytes_in_use', 'bytes_limit',
    'peak_bytes_in_use'}, ...}`` (PyTorch's allocator for the bytes in
    use and their peak, the card's total memory for the limit); ``{}``
    without a card."""
    if not torch.cuda.is_available():
        return {}
    stats = {}
    for i in range(torch.cuda.device_count()):
        s = torch.cuda.memory_stats(i)
        stats['cuda:%d' % i] = {
            'bytes_in_use': s.get('allocated_bytes.all.current', 0),
            'bytes_limit': torch.cuda.mem_get_info(i)[1],
            'peak_bytes_in_use': s.get('allocated_bytes.all.peak', 0),
        }
    return stats


def setup_logging(level=logging.INFO):
    logging.basicConfig(
        level=level,
        format='%(asctime)s %(name)s %(levelname)s %(message)s')
