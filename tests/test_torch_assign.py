"""enspara_tpu_torch nearest-center assignment and the k-centers warm
starts held against the JAX package.

The same seeded numpy inputs go through both: ``engine.assign_device``
against the JAX ``_assign_all_rmsd_pallas(..., interpret=True)`` (the
TPU kernel's scan over 256-wide center blocks) and the JAX
``assign_device`` on the CPU (the XLA path), ``kcenters`` with
``init_centers`` and ``random_first_center`` against the JAX
``kcenters``, and the host helpers of ``cluster/util.py``; the RMSD
assignment holds one center block at a time. Assignments
and center indices are equal (the data is tie-free, or the ties are
exact duplicates, where the lower index wins); distances are held on
the msd bar of test_torch_port.py.
"""

import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enspara_tpu.cluster import KCenters as JaxKCenters
from enspara_tpu.cluster import engine as jengine
from enspara_tpu.cluster import kcenters as jax_kcenters
from enspara_tpu.cluster import util as jutil

from enspara_tpu_torch.cluster import KCenters, engine, kcenters, util
from enspara_tpu_torch.exception import ImproperlyConfigured
from enspara_tpu_torch.ops import qcp_matrix
from enspara_tpu_torch.util.backend import check_random_state, select_device

from test_torch_port import assert_gram_close, assert_rmsd_close, basin_data


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


def _gsum(X):
    Xc = X - X.mean(axis=1, keepdims=True)
    return 2 * float((Xc ** 2).sum((1, 2)).max())


def _data(seed=0, n=600, a=10, basins=20):
    return basin_data(np.random.default_rng(seed), n, a, n_basins=basins)


@pytest.mark.parametrize('k', [5, 64, 300])
def test_assign_device_matches_jax(k):
    X = _data(k)
    rng = np.random.default_rng(k + 1)
    centers = X[rng.choice(len(X), k, replace=False)]
    if k > 256:
        # an exact duplicate in the second 256-wide block: the first wins
        centers[280] = centers[10]
    Xc = np.asarray(jengine._center_structures(jnp.asarray(X)))
    Cc = np.asarray(jengine._center_structures(jnp.asarray(centers)))
    ref_a, ref_d = jengine._assign_all_rmsd_pallas(
        jnp.asarray(Xc), jnp.asarray(Cc), k_real=k, interpret=True)
    xla_a, xla_d = jengine.assign_device(X, centers, 'rmsd')
    before = qcp_matrix.qcp_rmsd_matrix_kernel.n_launches
    a, d = engine.assign_device(X, centers, 'rmsd')
    assert qcp_matrix.qcp_rmsd_matrix_kernel.n_launches == before
    assert a.dtype == np.int64 and d.dtype == np.float64
    assert a.shape == d.shape == (len(X),)
    for ra_, rd in ((np.asarray(ref_a), np.asarray(ref_d)),
                    (xla_a, xla_d)):
        np.testing.assert_array_equal(a, ra_)
        assert_rmsd_close(d, rd, _gsum(X), X.shape[1])
    if k > 256:
        assert not (a == 280).any() and (a == 10).any()


def test_assign_device_holds_one_block_at_a_time(monkeypatch):
    """The RMSD assignment drops each center block before it makes the
    next, as the JAX scan does (peak memory: the frames and one (n_pad,
    256) block): no earlier block is alive when the next call starts,
    and the labels are the JAX package's."""
    X = _data(21, n=3000, a=10, basins=40)
    rng = np.random.default_rng(22)
    centers = X[rng.choice(len(X), 700, replace=False)]
    real = engine.qcp_rmsd_matrix_block
    blocks, alive_at_call = [], []

    def tracked(*args):
        alive_at_call.append(sum(r() is not None for r in blocks))
        out = real(*args)
        blocks.append(weakref.ref(out))
        return out

    monkeypatch.setattr(engine, 'qcp_rmsd_matrix_block', tracked)
    a, d = engine.assign_device(X, centers, 'rmsd')
    assert alive_at_call == [0, 0, 0]          # 256 + 256 + 188 centers
    ja, jd = jengine.assign_device(X, centers, 'rmsd')
    np.testing.assert_array_equal(a, ja)
    assert_rmsd_close(d, jd, _gsum(X), X.shape[1])


def test_assign_device_prepared_and_tensor_inputs():
    X = _data(3, n=300)
    centers = X[[0, 50, 100]]
    a, d = engine.assign_device(X, centers, 'rmsd')
    prep = engine.prepare_rmsd_frames(X, tile=128)     # n_pad 384
    a2, d2 = engine.assign_device(prep, torch.from_numpy(centers), 'rmsd')
    np.testing.assert_array_equal(a2, a)
    np.testing.assert_array_equal(d2, d)
    with pytest.raises(ValueError, match='centers'):
        engine.assign_device(X, centers[:, :5], 'rmsd')
    # prepared RMSD frames take only 'rmsd'; 3-D input is not features
    with pytest.raises(ValueError, match='prepared for'):
        engine.assign_device(prep, centers, 'euclidean')
    with pytest.raises(ValueError, match='feature vectors'):
        engine.assign_device(X, centers, 'euclidean')
    # the euclidean assignment of flattened frames equals the JAX one
    F, C = X.reshape(len(X), -1), centers.reshape(3, -1)
    ja, jd = jengine.assign_device(F, C, 'euclidean')
    pa, pd = engine.assign_device(F, C, 'euclidean')
    np.testing.assert_array_equal(pa, ja)
    assert_gram_close(pd, jd, F, C)


def test_kcenters_init_centers_matches_jax():
    X = _data(7)
    init = [X[5], X[300], X[450]]
    ref = jax_kcenters(X, 'rmsd', n_clusters=15, init_centers=init)
    port = kcenters(X, 'rmsd', n_clusters=15, init_centers=init)
    np.testing.assert_array_equal(port.center_indices, ref.center_indices)
    np.testing.assert_array_equal(port.assignments, ref.assignments)
    assert_rmsd_close(port.distances, ref.distances, _gsum(X), 10)
    assert list(port.center_indices[:3]) == [5, 300, 450]
    for c, r in zip(port.centers, ref.centers):
        np.testing.assert_array_equal(c, r)


def test_kcenters_init_centers_without_frames_raise():
    X = _data(8)
    with pytest.raises(ImproperlyConfigured, match=r'\[1\]'):
        kcenters(X, 'rmsd', n_clusters=5, init_centers=[X[3], X[3]])


@pytest.mark.parametrize('seed', [0, 11, 'RandomState'])
def test_random_first_center_matches_jax(seed):
    X = _data(9)

    def rs():
        return np.random.RandomState(4) if seed == 'RandomState' else seed
    ref = jax_kcenters(X, 'rmsd', n_clusters=10, random_first_center=True,
                       random_state=rs())
    port = kcenters(X, 'rmsd', n_clusters=10, random_first_center=True,
                    random_state=rs())
    np.testing.assert_array_equal(port.center_indices, ref.center_indices)
    np.testing.assert_array_equal(port.assignments, ref.assignments)
    with pytest.raises(ImproperlyConfigured):
        kcenters(X, 'rmsd', n_clusters=3, random_first_center=True,
                 init_centers=[X[0]])


def _flat_euclidean(traj, center):
    """A user callable: euclidean distance of flattened coordinates."""
    return np.linalg.norm((np.asarray(traj) - np.asarray(center))
                          .reshape(len(traj), -1), axis=1)


def test_callable_metric_host_loop_matches_jax():
    X = _data(10, n=200, a=4)
    ref = jax_kcenters(X, _flat_euclidean, n_clusters=9)
    port = kcenters(X, _flat_euclidean, n_clusters=9)
    np.testing.assert_array_equal(port.center_indices, ref.center_indices)
    np.testing.assert_array_equal(port.assignments, ref.assignments)
    np.testing.assert_array_equal(port.distances, ref.distances)
    ref = jax_kcenters(X, _flat_euclidean, n_clusters=9,
                       init_centers=[X[7], X[70]])
    port = kcenters(X, _flat_euclidean, n_clusters=9,
                    init_centers=[X[7], X[70]])
    np.testing.assert_array_equal(port.center_indices, ref.center_indices)


def test_host_helpers_match_jax():
    X = _data(12, n=250, a=7)
    centers = [X[i] for i in (0, 40, 90, 200)]
    ra, rd = jutil.assign_to_nearest_center(X, centers, jutil._rmsd_metric)
    pa, pd = util.assign_to_nearest_center(X, centers, util._rmsd_metric)
    np.testing.assert_array_equal(pa, ra)
    assert_rmsd_close(pd, rd, _gsum(X), 7)
    np.testing.assert_array_equal(util.find_cluster_centers(pa, pd),
                                  jutil.find_cluster_centers(ra, rd))
    labels = np.array([2, 0, 2, 1, 0])
    gaps = np.array([0.5, 0.1, 0.5, 0.0, 0.1])
    np.testing.assert_array_equal(util.find_cluster_centers(labels, gaps),
                                  [1, 3, 0])


@pytest.mark.parametrize('case', ['ties', 'negative', 'int32_float32',
                                  'wide', 'nan', 'one_label'])
def test_find_cluster_centers_scatter_equals_the_sort(case):
    """The O(n) scatter-min path (integer labels no wider than the
    frames) and the sort it falls back to (wide labels, a NaN) give the
    JAX package's first minimum-distance frame of each label."""
    rng = np.random.default_rng(len(case))
    n = 5000
    labels = rng.integers(0, 40, n)
    gaps = np.round(rng.random(n), 2)           # many ties
    if case == 'negative':
        labels -= 20
    elif case == 'int32_float32':
        labels, gaps = labels.astype(np.int32), gaps.astype(np.float32)
    elif case == 'wide':
        labels = labels * 10 ** 6
    elif case == 'nan':
        gaps[rng.integers(0, n, 30)] = np.nan
    elif case == 'one_label':
        labels[:] = 3
    got = util.find_cluster_centers(labels, gaps)
    np.testing.assert_array_equal(got, jutil.find_cluster_centers(labels,
                                                                  gaps))


def test_estimator_predict_and_params_match_jax():
    X = _data(13, n=300, a=6)
    ref = JaxKCenters('rmsd', n_clusters=8).fit(X)
    est = KCenters('rmsd', n_clusters=8).fit(torch.from_numpy(X))
    np.testing.assert_array_equal(est.center_indices_, ref.center_indices_)
    new = _data(14, n=50, a=6)
    rp, pp = ref.predict(new), est.predict(new)
    np.testing.assert_array_equal(pp.assignments, rp.assignments)
    assert_rmsd_close(pp.distances, rp.distances, _gsum(X), 6)
    assert est.runtime_ >= 0
    assert est.get_params()['n_clusters'] == 8
    assert est.set_params(n_clusters=3).n_clusters == 3
    with pytest.raises(ImproperlyConfigured):
        KCenters('rmsd', n_clusters=2).predict(new)


def test_unported_metrics_raise():
    """The named metrics dispatch to libdist as in the JAX package;
    an unknown name raises."""
    for name in ('euclidean', 'manhattan', 'cityblock', 'hamming'):
        fn = util._get_distance_method(name)
        assert fn.__name__ == jutil._get_distance_method(name).__name__
        assert util._metric_name(fn) == jutil._metric_name(
            jutil._get_distance_method(name))
    with pytest.raises(ImproperlyConfigured):
        util._get_distance_method('nope')
    assert util._metric_name(util._rmsd_metric) == 'rmsd'
    assert util._metric_name(_flat_euclidean) is None


def test_select_device_and_random_state(monkeypatch):
    monkeypatch.setenv('ENSPARA_TPU_PLATFORM', 'cpu')
    assert select_device() == torch.device('cpu')
    monkeypatch.setenv('ENSPARA_TPU_PLATFORM', 'tpu')
    with pytest.raises(ValueError):
        select_device()
    monkeypatch.delenv('ENSPARA_TPU_PLATFORM')
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='CUDA'):
            select_device()
    assert check_random_state(None) is np.random.mtrand._rand
    rs = np.random.RandomState(3)
    assert check_random_state(rs) is rs
    assert check_random_state(5).randint(2 ** 31) == \
        np.random.RandomState(5).randint(2 ** 31)
    with pytest.raises(ValueError):
        check_random_state('seed')
