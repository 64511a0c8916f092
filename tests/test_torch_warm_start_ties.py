"""The k-centers warm start on the devices, at its edges: a frame
duplicated across a shard boundary, whose tie the first minimum gives
to the lower global index as the host search does, and the search
alone (``engine._first_minima``) against ``util.find_cluster_centers``
on labels and distances full of ties, on one device and meshes of 2 and
4 shards. The helpers are ``tests/test_torch_warm_start.py``'s."""

import numpy as np
import pytest
import torch

from enspara_tpu_torch.cluster import engine, util
from enspara_tpu_torch.cluster.kcenters import kcenters

from test_torch_warm_start import (K, _assert_same, _boundary, _frames,
                                   _host_path, _where)


@pytest.fixture(autouse=True)
def _cpu_platform(monkeypatch):
    """Host inputs run on the CPU in these tests; torch on one thread
    (the tier-1 run puts several test workers on one host's cores)."""
    monkeypatch.setenv('ENSPARA_TPU_PLATFORM', 'cpu')
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize('metric', ['rmsd', 'euclidean'])
@pytest.mark.parametrize('shards', [1, 2, 4])
@pytest.mark.parametrize('n_init', [1, 2])
def test_tie_across_a_shard_boundary_goes_to_the_lower_index(metric,
                                                             shards,
                                                             n_init):
    """The init center's own frame, duplicated as the first frame of
    the next shard: both hold its cluster's minimum, and the center
    sits at the lower index, as the host search puts it."""
    n = 3000
    X = _frames(metric, n)
    b = _boundary(metric, n, shards)
    X[b] = X[b - 1]
    init = [X[b - 1], X[20]][:n_init]
    where = _where(shards)
    res = kcenters(X, metric, n_clusters=K, init_centers=init, **where)
    assert res.center_indices[0] == b - 1
    assert res.distances[b] == res.distances[b - 1]
    _assert_same(res, _host_path(X, metric, init, K, **where))


@pytest.mark.parametrize('shards', [1, 2, 4])
def test_first_minima_equal_find_cluster_centers(shards):
    """The search alone, on labels and distances full of ties (five
    distance values, one label of six held by no frame)."""
    n = 1001
    rng = np.random.default_rng(3)
    labels = rng.choice([0, 1, 2, 4, 5], size=n).astype(np.int32)
    dists = rng.choice([0.5, 1.0, 1.5, 2.0, np.inf], size=n) \
        .astype(np.float32)
    where = _where(shards)
    prep = engine.prepare_sharded(np.zeros((n, 2), np.float32),
                                  'euclidean', **where)
    shards_, n_local, first = engine._shards(prep)
    total = n_local * getattr(prep, 'n_shards', 1)
    lab = np.zeros(total, np.int32)
    gap = np.full(total, -7.0, np.float32)   # pad rows: never read
    lab[:n], gap[:n] = labels, dists
    a = [torch.from_numpy(lab[s * n_local:(s + 1) * n_local].copy())
         for s in range(len(shards_))]
    d = [torch.from_numpy(gap[s * n_local:(s + 1) * n_local].copy())
         for s in range(len(shards_))]
    got = engine._first_minima(prep, a, d, 6, where.get('mesh'))
    want = util.find_cluster_centers(labels, dists)
    assert got.dtype == np.int64 and got[3] == n
    np.testing.assert_array_equal(got[[0, 1, 2, 4, 5]], want)
