"""The k-centers warm start where it does not stay on the devices:
an init center that owns no frame raises ``ImproperlyConfigured`` (on
the devices and in the host loop of a callable metric alike), and a
locality-sorted layout, whose frame order is not the assignment's, goes
through the host (``_kcenters_fast.n_host_warm_starts`` reads 1) with
the host path's results, while bf16 frames in the caller's order take
the float32 assignment's tensors on the devices. The helpers are
``tests/test_torch_warm_start.py``'s."""

import numpy as np
import pytest
import torch

from enspara_tpu_torch.cluster.kcenters import _kcenters_fast, kcenters
from enspara_tpu_torch.exception import ImproperlyConfigured

from test_torch_warm_start import (K, _assert_same, _frames, _host_path,
                                   _where)


@pytest.fixture(autouse=True)
def _cpu_platform(monkeypatch):
    """Host inputs run on the CPU in these tests; torch on one thread
    (the tier-1 run puts several test workers on one host's cores)."""
    monkeypatch.setenv('ENSPARA_TPU_PLATFORM', 'cpu')
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _euclidean(X, center):
    return np.sqrt(((X - center) ** 2).sum(-1))


@pytest.mark.parametrize('metric,shards', [
    ('rmsd', 1), ('rmsd', 4), ('euclidean', 1), ('euclidean', 4),
    ('callable', 1)])
def test_ownerless_init_center_raises(metric, shards):
    """Two copies of one init center: the second owns no frame, on the
    devices and in the host loop of a callable metric alike."""
    X = _frames('rmsd' if metric == 'rmsd' else 'euclidean')
    where = {} if metric == 'callable' else _where(shards)
    with pytest.raises(ImproperlyConfigured,
                       match=r'init_centers \[1\] own no frames'):
        kcenters(X, _euclidean if metric == 'callable' else metric,
                 n_clusters=K, init_centers=[X[7], X[7]], **where)


@pytest.mark.parametrize('shards', [1, 2])
def test_locality_sort_warm_starts_through_the_host(shards):
    """A sorted layout is not the assignment's frame order: its warm
    start goes through the host, counted once, with the host path's
    results; the unsorted layout of bf16 frames takes the float32
    assignment's tensors on the devices, with the host path's results
    on the same bf16 frames."""
    X = _frames('rmsd')
    init = [X[7], X[1500]]
    where = _where(shards)
    res = kcenters(X, 'rmsd', n_clusters=K, init_centers=init,
                   sort='locality', **where)
    assert _kcenters_fast.n_host_warm_starts == 1
    _assert_same(res, _host_path(X, 'rmsd', init, K, sort='locality',
                                 **where))
    res = kcenters(X, 'rmsd', n_clusters=K, init_centers=init,
                   precision='bf16', **where)
    assert _kcenters_fast.n_host_warm_starts == 0
    _assert_same(res, _host_path(X, 'rmsd', init, K, precision='bf16',
                                 **where))
