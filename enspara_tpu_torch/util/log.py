"""Lightweight timing helpers (counterpart of ``enspara_tpu/util/log.py``).

``timed`` mirrors the reference's context manager (enspara/util/log.py:5)
and is used to wrap hot sections throughout the framework;
``trace_region`` is the program's span, a named range in a
``torch.profiler`` trace, and ``device_memory_stats`` reports each
visible card's memory.

Spans. ``with trace_region('enspara/<layer>.<stage>'): ...`` names a
stretch of host time. A span is recorded only while a ``torch.profiler``
runs, as a CPU op on the profiler's clock (an event of ``device_type``
CPU, not a user annotation) nested under the ranges open around it; the
device's timeline never shows it, so it is never counted as device
work. With no profiler running a span records nothing and costs about a
microsecond. ``trace_region`` is torch's
``torch._C._profiler._RecordFunctionFast`` (the range torch's inductor
names its launches with), which the port needs. The program opens
these spans:

- ``enspara/khybrid.kcenters``, ``enspara/khybrid.pam``: the two stages
  of ``hybrid`` and ``hybrid_device``, each ending in its host fetch of
  labels and distances;
- ``enspara/kcenters.loop``: the one-device RMSD k-centers loop of one
  ``kcenters_device_fused`` call, and inside it
  ``enspara/kcenters.chunk``: one chunk of it (``CHUNK`` iterations and
  the host read after them); ``enspara/kcenters.results``: the fetch of
  that call's results to the host after its loop, one device or
  sharded (labels, distances and centers in the caller's order);
  ``enspara/kcenters.warm_start``: a warm start from ``init_centers``
  (the assignment to them, the search for their frames and the
  hand-over of the assignment to the loop as its start state), and
  inside it ``enspara/kcenters.init_centers``: the search, a per-shard
  first minimum on the devices, one cross-shard argmax and its one host
  read of the init centers' frame indices;
- ``enspara/pam.batch`` (a batch of proposals of the device PAM sweeps),
  and inside it ``enspara/pam.try`` (one proposal past the host-side
  screen), ``enspara/pam.repair`` (a re-rank of the second-nearest
  cache) and ``enspara/pam.read`` (a synchronising read of device
  scalars: the host's wait for the card plus the copy, one for each
  count of ``_pam_sweeps.n_host_syncs``);
- ``enspara/msm.prepare``: ``implied_timescales_batched`` from its entry
  to its first launch (the padded labels, the checks, the copies to the
  card);
- ``enspara/kcenters.sharded``: the sharded RMSD k-centers loop of one
  ``kcenters_device_fused`` call, and inside it
  ``enspara/kcenters.global_best`` (each global max and argmax over the
  shards that the host issues), ``enspara/kcenters.capture`` (the
  capture of a chunk as a CUDA graph, one a loop that takes the graph)
  and ``enspara/kcenters.replay`` (the host's launch of one replay of
  that graph); the feature k-centers loop of ``kcenters_device``
  opens ``enspara/kcenters.global_best`` too, around each of its
  searches, on one device and over shards alike;
- ``enspara/mesh.all_reduce``, ``enspara/mesh.all_gather``: one
  collective over the processes of a ``FrameMesh`` that the host issues
  (its enqueueing; its copies through host memory where staged), eager
  or into a CUDA graph's capture. The mesh's ``n_collectives`` counts
  the collectives that run: one for each eager span, none for a
  captured one, and a chunk's worth for each replay.

The span that caused a span is the one that encloses it; no ids are
kept. To record them, run the work under ``torch.profiler``; the
profiler being on is the only switch::

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        KHybrid('rmsd', n_clusters=1000).fit(X)
    spans = [e for e in prof.events() if e.name.startswith('enspara/')]

Each span is then an event with ``device_type`` CPU, its
``time_range`` on the profiler's clock, as the device's kernels are.
"""

import logging
import time
from contextlib import contextmanager

import torch
from torch._C._profiler import _RecordFunctionFast

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


# the span: the contract is the module's docstring
trace_region = _RecordFunctionFast


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
