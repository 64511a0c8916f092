"""enspara_tpu_torch k-medoids and k-hybrid held against the JAX package.

The same seeded numpy inputs go through both: the host PAM sweep
(``_kmedoids_pam_update``, with explicit proposals and with a seeded
``RandomState``), the device PAM sweeps (``_pam_sweeps``, fed the very
random bits the JAX module draws for its frame count), and the
functional/estimator ``kmedoids``, ``hybrid`` and ``KHybrid`` (the host
PAM path, as the JAX package runs off its accelerator). Medoids and
assignments are equal (tie-free basin data); distances are held on the
msd bar of test_torch_port.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enspara_tpu.cluster import KHybrid as JaxKHybrid
from enspara_tpu.cluster import KMedoids as JaxKMedoids
from enspara_tpu.cluster import engine as jengine
from enspara_tpu.cluster import engine_kmedoids as jek
from enspara_tpu.cluster import hybrid as jax_hybrid
from enspara_tpu.cluster import kcenters as jax_kcenters
from enspara_tpu.cluster import kmedoids as jax_kmedoids
from enspara_tpu.cluster import util as jutil
from enspara_tpu.cluster.kmedoids import _kmedoids_pam_update as jax_pam

from enspara_tpu_torch.cluster import (KHybrid, KMedoids, engine,
                                       engine_kmedoids, hybrid,
                                       hybrid_device, kmedoids, util)
from enspara_tpu_torch.cluster.kmedoids import (_kmedoids_pam_update, _msq,
                                                _kmedoids_iterations)
from enspara_tpu_torch.exception import DataInvalid
from enspara_tpu_torch.ops import qcp_matrix

from test_torch_port import assert_rmsd_close, basin_data


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


def _data(seed, n=400, a=9, basins=14):
    return basin_data(np.random.default_rng(seed), n, a, n_basins=basins)


def _gsum(X):
    Xc = X - X.mean(axis=1, keepdims=True)
    return 2 * float((Xc ** 2).sum((1, 2)).max())


def _assert_same(port, ref, X):
    np.testing.assert_array_equal(np.asarray(port.center_indices),
                                  np.asarray(ref.center_indices))
    np.testing.assert_array_equal(port.assignments, ref.assignments)
    assert_rmsd_close(port.distances, ref.distances, _gsum(X), X.shape[1])


@pytest.mark.parametrize('mode', ['proposals', 'random_state'])
def test_host_pam_update_matches_jax(mode):
    X = _data(1)
    seed = jax_kcenters(X, 'rmsd', n_clusters=10)
    inds = list(np.asarray(seed.center_indices))
    kw = {}
    if mode == 'proposals':
        # each medoid's proposal: the next member of its own cluster
        kw['proposals'] = [int(np.flatnonzero(seed.assignments == c)[1])
                           for c in range(10)]
    out = {}
    for tag, fn, metric in (('jax', jax_pam, jutil._rmsd_metric),
                            ('port', _kmedoids_pam_update,
                             util._rmsd_metric)):
        if mode == 'random_state':
            kw['random_state'] = np.random.RandomState(9)
        out[tag] = fn(X, metric, inds, seed.assignments, seed.distances,
                      **kw)
    (jm, jd, ja, _), (pm, pd, pa, pc) = out['jax'], out['port']
    assert list(pm) == list(jm)
    np.testing.assert_array_equal(pa, ja)
    assert_rmsd_close(pd, jd, _gsum(X), 9)
    assert list(pm) != inds, 'some proposal must be accepted'
    assert _msq(pd) <= _msq(seed.distances)
    for c, i in zip(pc, pm):
        np.testing.assert_array_equal(c, X[i])


def _jax_bits(key, s, n):
    return np.asarray(jax.random.bits(jax.random.fold_in(key, s), (n,),
                                      jnp.uint32)).astype(np.int64)


@pytest.mark.parametrize('n,k,n_sweeps,batch', [
    (512, 12, 3, 8),      # 2 batches of 8, the last one ragged
    (450, 20, 2, 64),     # padded frames; one batch of all 20 medoids
    (300, 70, 1, 64),     # k > 64: two cache-init chunks
])
def test_pam_sweeps_match_jax(n, k, n_sweeps, batch):
    _sweeps_match_jax(n, k, n_sweeps, batch)


@pytest.mark.parametrize('rows', [1, 3])
def test_pam_sampling_in_row_chunks_matches_jax(rows, monkeypatch):
    """Proposals sampled and screened a few clusters at a time (as a
    large job takes them, to bound the (rows, n) 8-byte temporaries;
    here 1 and 3 of a batch of 8, the last chunk ragged) make the JAX
    sweep's swaps."""
    monkeypatch.setattr(engine_kmedoids, '_SAMPLE_ELEMS', rows * 512)
    _sweeps_match_jax(512, 12, 3, 8)     # 512 frames: n_pad 512


def _sweeps_match_jax(n, k, n_sweeps, batch):
    X = _data(n + k, n=n, a=8, basins=2 * k)
    seed = jax_kcenters(X, 'rmsd', n_clusters=k)
    Xc = np.asarray(jengine._center_structures(jnp.asarray(X)))
    d1 = seed.distances.astype(np.float32)
    a1 = seed.assignments.astype(np.int32)
    minds = np.asarray(seed.center_indices, np.int32)
    key = jax.random.PRNGKey(7)
    bucket = int(min(n, max(64, 8 * ((n + k - 1) // k))))
    jd, ja, jm = jek._pam_sweeps(
        jnp.asarray(Xc), jnp.ones(n, bool), jnp.asarray(d1),
        jnp.asarray(a1), jnp.asarray(minds), key, 'rmsd', n_sweeps,
        bucket, batch=batch)

    prep = engine.prepare_rmsd_frames(X)
    n_pad = prep.frames_r.shape[1]
    bits = []
    for s in range(n_sweeps):
        b = np.zeros(n_pad, np.int64)
        b[:n] = _jax_bits(key, s, n)
        bits.append(torch.from_numpy(b))
    pad = np.full(n_pad - n, np.inf, np.float32)
    syncs = engine_kmedoids._pam_sweeps.n_host_syncs
    (pd,), (pa,), pm = engine_kmedoids._pam_sweeps(
        prep, [torch.from_numpy(np.concatenate([d1, pad]))],
        [torch.from_numpy(np.concatenate([a1, np.full(n_pad - n, -1,
                                                      np.int32)]))],
        minds.astype(np.int64), bits, bucket, batch=batch)
    np.testing.assert_array_equal(pm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(pa.numpy()[:n], np.asarray(ja))
    assert (pa.numpy()[n:] == -1).all()
    assert_rmsd_close(pd.numpy()[:n], np.asarray(jd), _gsum(X), 8)
    assert not np.array_equal(np.asarray(jm), minds), 'no swap accepted'
    assert engine_kmedoids._pam_sweeps.n_host_syncs > syncs


def test_mul32_wraps_like_uint32():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 2 ** 32, 1000, dtype=np.uint64)
    for c in (0x85EBCA6B, 0x9E3779B9, 1, 0xFFFFFFFF):
        want = (x * np.uint64(c)) & np.uint64(0xFFFFFFFF)
        got = engine_kmedoids._mul32(torch.from_numpy(x.astype(np.int64)),
                                     c)
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_device_pam_cache_consistency():
    """After many sweeps with accepts the carried (d1, a1) equal a
    brute-force nearest-medoid recompute: the invariant the FastPAM
    second-nearest cache has to keep (tests/test_kmedoids.py, by RMSD)."""
    rng = np.random.default_rng(21)
    X = rng.normal(size=(300, 6, 3)).astype(np.float32)  # no structure:
    # high acceptance churn stresses the cache-repair path
    seed = jax_kcenters(X, 'rmsd', n_clusters=12)
    m, d, a = engine_kmedoids.kmedoids_sweeps_device(
        X, 'rmsd', seed.assignments, seed.distances,
        np.asarray(seed.center_indices), n_sweeps=8, seed=3)
    Xc = X - X.mean(axis=1, keepdims=True)
    full = qcp_matrix.pairwise_rmsd(Xc, Xc[m]).numpy().astype(np.float64)
    full[m, np.arange(len(m))] = 0.0       # PAM's self-distance clamp
    assert_rmsd_close(d, full.min(axis=1), _gsum(X), 6)
    assert_rmsd_close(full[np.arange(len(X)), a], full.min(axis=1),
                      _gsum(X), 6)
    assert _msq(d) <= _msq(seed.distances)
    assert sorted(set(a.tolist())) == list(range(12))
    m2, d2, a2 = engine_kmedoids.kmedoids_sweeps_device(
        X, 'rmsd', seed.assignments, seed.distances,
        np.asarray(seed.center_indices), n_sweeps=8, seed=3)
    np.testing.assert_array_equal(m2, m)
    np.testing.assert_array_equal(a2, a)


@pytest.mark.parametrize('random_first_center', [False, True])
def test_hybrid_matches_jax(random_first_center):
    X = _data(30)
    kw = dict(n_iters=3, n_clusters=11,
              random_first_center=random_first_center)
    ref = jax_hybrid(X, 'rmsd', random_state=5, **kw)
    port = hybrid(X, 'rmsd', random_state=5, **kw)
    _assert_same(port, ref, X)
    kc = jax_kcenters(X, 'rmsd', n_clusters=11)
    if not random_first_center:
        assert _msq(port.distances) <= _msq(kc.distances)
    est = KHybrid('rmsd', n_clusters=11, kmedoids_updates=3,
                  random_first_center=random_first_center,
                  random_state=5).fit(X)
    jest = JaxKHybrid('rmsd', n_clusters=11, kmedoids_updates=3,
                      random_first_center=random_first_center,
                      random_state=5).fit(X)
    np.testing.assert_array_equal(est.labels_, jest.labels_)
    np.testing.assert_array_equal(est.center_indices_,
                                  jest.center_indices_)
    assert len(est.centers_) == 11


def test_kmedoids_matches_jax():
    X = _data(40)
    ref = jax_kmedoids(X, 'rmsd', n_clusters=9, n_iters=2, random_state=2)
    port = kmedoids(X, 'rmsd', n_clusters=9, n_iters=2, random_state=2)
    _assert_same(port, ref, X)
    warm = dict(assignments=port.assignments, distances=port.distances)
    ref = jax_kmedoids(X, 'rmsd', n_iters=1, random_state=4, **warm)
    est = KMedoids('rmsd', n_iters=1, random_state=4).fit(X, **warm)
    _assert_same(est.result_, ref, X)
    jest = JaxKMedoids('rmsd', n_clusters=9, n_iters=0,
                       random_state=1).fit(X)
    est = KMedoids('rmsd', n_clusters=9, n_iters=0, random_state=1).fit(X)
    _assert_same(est.result_, jest.result_, X)


def test_kmedoids_rejects_inconsistent_warm_start():
    X = _data(41, n=200)
    res = jax_kcenters(X, 'rmsd', n_clusters=5)
    with pytest.raises(DataInvalid):
        kmedoids(X, 'rmsd', assignments=res.assignments,
                 distances=res.distances + 1.0,
                 cluster_center_inds=res.center_indices)


def test_device_backend_runs_the_sweeps_on_the_cpu():
    """``backend='device'`` takes the device sweeps wherever the data
    lies (on the CPU, the plain block); ``hybrid_device`` chains both
    stages on one prepared copy."""
    X = _data(42, n=300)
    kc = jax_kcenters(X, 'rmsd', n_clusters=8)
    res = _kmedoids_iterations(
        X, util._rmsd_metric, 3, list(kc.center_indices), kc.assignments,
        kc.distances, random_state=0, backend='device')
    assert _msq(res.distances) <= _msq(kc.distances)
    assert_rmsd_close(res.distances[res.center_indices], np.zeros(8),
                      _gsum(X), X.shape[1])
    hd = hybrid_device(X, n_clusters=8, n_iters=3, seed=0)
    assert len(hd.center_indices) == len(hd.centers) == 8
    assert _msq(hd.distances) <= _msq(kc.distances)
    with pytest.raises(DataInvalid):
        _kmedoids_iterations(X, util._rmsd_metric, 1, [0], kc.assignments,
                             kc.distances, backend='gpu')
