"""enspara_tpu_torch's feature-vector clustering on the card against the
same on the CPU. Imports no jax: on the card machine, run with
``python -m pytest --noconftest -m cuda tests/test_torch_cuda_features.py``.

The ``cuda`` tests skip without a card. They hold the k-centers loop
(``engine.kcenters_device``), the assignment (``engine.assign_device``,
across a 512-center block edge), a 2-shard mesh of the card and the PAM
sweeps, by the euclidean, manhattan and hamming metrics, against the CPU
runs of the same torch ops: centers equal up to the first near tie and
the covering radius within 1e-5; labels equal but for near ties, hamming
exactly; and none of the six kernels launches.
"""

import numpy as np
import pytest
import torch

from enspara_tpu_torch.cluster import engine, engine_kmedoids
from enspara_tpu_torch.ops import (distances, ell_spmm, kcenters_step,
                                   qcp_matrix, qcp_update)
from enspara_tpu_torch.parallel import FrameMesh

from test_torch_port import assert_gram_close

METRICS = ['euclidean', 'manhattan', 'hamming']


@pytest.fixture(autouse=True)
def _cpu_platform(monkeypatch):
    """Host inputs run on the CPU in these tests: with no device named,
    the port sends them to the card. Torch runs on one thread: the
    tier-1 run puts several test workers on one host's cores."""
    monkeypatch.setenv('ENSPARA_TPU_PLATFORM', 'cpu')
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (torch.cuda.is_available() is '
                    'False)')
    return torch.device('cuda', 0)


def _features(metric, n=20_000, d=32, seed=0):
    rng = np.random.RandomState(seed)
    if metric == 'hamming':
        tmpl = rng.randint(0, 3, size=(200, d))
        X = tmpl[rng.randint(0, 200, n)]
        X = np.where(rng.random_sample(X.shape) < 0.2,
                     rng.randint(0, 3, size=X.shape), X)
        return X.astype(np.int32)
    X = (4.0 * rng.normal(size=(200, d)))[rng.randint(0, 200, n)]
    return (X + rng.normal(size=(n, d))).astype(np.float32)


def _dist64(X, C, metric):
    X, C = np.asarray(X, np.float64), np.asarray(C, np.float64)
    if metric == 'euclidean':
        return np.sqrt(((X[:, None] - C[None]) ** 2).sum(-1))
    if metric == 'manhattan':
        return np.abs(X[:, None] - C[None]).sum(-1)
    return (X[:, None] != C[None]).mean(-1)


def _launches():
    return (kcenters_step.kcenters_chunk.n_launches,
            kcenters_step.kcenters_iteration_skip.n_launches,
            qcp_update.kcenters_iteration.n_launches,
            qcp_matrix.qcp_rmsd_matrix_kernel.n_launches,
            ell_spmm.ell_spmm_kernel.n_launches)


def _same_covering(a, b, X, metric):
    ca, cb = np.asarray(a.center_indices), np.asarray(b.center_indices)
    diff = np.flatnonzero(ca != cb)
    if len(diff):
        i = int(diff[0])
        d = _dist64(X[[ca[i], cb[i]]], X[ca[:i]], metric).min(1)
        assert abs(d[0] - d[1]) <= 1e-5 * d.max(), (i, d)
    else:
        np.testing.assert_allclose(a.distances, b.distances, rtol=1e-5)
    ra, rb = a.distances.max(), b.distances.max()
    assert abs(ra - rb) <= 1e-5 * rb


@pytest.mark.cuda
@pytest.mark.parametrize('metric', METRICS)
def test_cuda_feature_loop_matches_cpu(cuda, metric):
    X = _features(metric)
    before = _launches()
    g = engine.kcenters_device(X, metric, n_clusters=150, device=cuda)
    c = engine.kcenters_device(X, metric, n_clusters=150, device='cpu')
    assert _launches() == before
    assert g.n_found == c.n_found == 150
    if metric == 'hamming':
        np.testing.assert_array_equal(g.center_indices, c.center_indices)
        np.testing.assert_array_equal(g.distances, c.distances)
    _same_covering(g, c, X, metric)
    # a 2-shard mesh of the card equals one card device
    m = engine.kcenters_device(X, metric, n_clusters=150,
                               mesh=FrameMesh((cuda, cuda)))
    _same_covering(m, g, X, metric)


@pytest.mark.cuda
@pytest.mark.parametrize('metric', METRICS)
def test_cuda_feature_assignment_matches_cpu(cuda, metric):
    """600 centers (two blocks) with center 10 duplicated at 550: labels
    equal but for near ties, the duplicate never wins; the peak memory
    stays within a few (n, 512) blocks and one broadcast chunk of
    ``_BROADCAST_ELEMS`` elements."""
    X = _features(metric, seed=1)
    C = X[np.random.default_rng(1).choice(len(X), 600, replace=False)]
    C[550] = C[10]
    torch.cuda.reset_peak_memory_stats(cuda)
    before = _launches()
    ag, dg = engine.assign_device(X, C, metric, device=cuda)
    peak = torch.cuda.max_memory_allocated(cuda)
    assert _launches() == before
    ac, dc = engine.assign_device(X, C, metric, device='cpu')
    assert peak < 4 * (4 * len(X) * 512 + distances._BROADCAST_ELEMS) \
        + 64 * 2 ** 20, peak
    assert not (ag == 550).any()
    flip = np.flatnonzero(ag != ac)
    if metric == 'hamming':
        assert len(flip) == 0
        np.testing.assert_array_equal(dg, dc)
        return
    both = _dist64(X[flip], C, metric)
    r = np.arange(len(flip))
    assert (np.abs(both[r, ag[flip]] - both[r, ac[flip]])
            <= 1e-5 * both[r, ac[flip]] + 1e-3).all()
    if metric == 'euclidean':
        assert_gram_close(dg, dc, X, C)
    else:
        np.testing.assert_allclose(dg, dc, rtol=1e-5)


@pytest.mark.cuda
def test_cuda_feature_pam_sweeps_match_cpu(cuda):
    """The PAM sweeps on euclidean features on the card against the CPU,
    fed the same random bits."""
    X = _features('euclidean', n=8000, d=16, seed=2)
    res = engine.kcenters_device(X, 'euclidean', n_clusters=40,
                                 device='cpu')
    out = {}
    for dev in ('cpu', cuda):
        prep = engine.prepare_sharded(X, 'euclidean', device=dev)
        gen = torch.Generator().manual_seed(1)
        bits = [torch.randint(0, 2 ** 32, (prep.n_pad,), generator=gen,
                              dtype=torch.long) for _ in range(2)]
        d1 = torch.from_numpy(res.distances.astype(np.float32)).to(dev)
        a1 = torch.from_numpy(res.assignments.astype(np.int32)).to(dev)
        before = _launches()
        (d,), (a,), m = engine_kmedoids._pam_sweeps(
            prep, [d1], [a1], res.center_indices, bits, 8 * 200, batch=16)
        assert _launches() == before
        out[str(dev)] = (d.cpu().numpy(), a.cpu().numpy(), m.cpu().numpy())
    (dc, ac, mc), (dg, ag, mg) = out.values()
    np.testing.assert_array_equal(mg, mc)
    np.testing.assert_array_equal(ag, ac)
    assert_gram_close(dg, dc, X, X)
