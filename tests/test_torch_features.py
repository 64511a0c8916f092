"""enspara_tpu_torch clustering of feature vectors held against the JAX
package: the device k-centers loop (``engine.kcenters_device``) and
assignment (``engine.assign_device``) by the euclidean, manhattan and
hamming metrics, on one device and over CPU frame meshes, the device PAM
sweeps fed the JAX package's random bits, and ``kcenters``, ``hybrid``
and ``kmedoids`` with feature metrics.

Inputs are seeded numpy blobs (float32) or three-state int32 labels
(hamming, rotamer-like), with exact ties planted: duplicate frames and
duplicate centers. Bars: the k-centers loop (the difference form) keeps
the JAX centers and labels, its distances within rtol 1e-5; over a mesh
the centers equal one device's up to the first near tie and the
covering radius agrees within 1e-5; assignments equal JAX's except near
ties, their distances on the Gram bar of ``assert_gram_close`` for
euclidean and within rtol 1e-5 for manhattan; hamming is exact
throughout.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enspara_tpu.cluster import engine as jengine
from enspara_tpu.cluster import engine_kmedoids as jek
from enspara_tpu.cluster import hybrid as jax_hybrid
from enspara_tpu.cluster import kcenters as jax_kcenters
from enspara_tpu.cluster import kmedoids as jax_kmedoids
from enspara_tpu.cluster import KCenters as JaxKCenters

from enspara_tpu_torch.cluster import (KCenters, engine, engine_kmedoids,
                                       hybrid, hybrid_device, kcenters,
                                       kmedoids)
from enspara_tpu_torch.ops import qcp_matrix
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


def features(metric, n=1500, d=12, seed=0, n_blobs=60):
    """Blobs of float32 features (the generator of
    benchmarks/reference_cpu_kcenters.py: centers at scale 4, unit
    noise) or, for hamming, 3-state int32 labels around blob templates
    with 20% of the positions redrawn; the last 5 frames duplicate the
    first 5 (exact ties)."""
    rng = np.random.RandomState(seed)
    if metric == 'hamming':
        tmpl = rng.randint(0, 3, size=(n_blobs, d))
        X = tmpl[rng.randint(0, n_blobs, n)]
        flip = rng.random_sample(X.shape) < 0.2
        X = np.where(flip, rng.randint(0, 3, size=X.shape), X)
        X = X.astype(np.int32)
    else:
        X = (rng.normal(size=(n_blobs, d)) * 4.0)[rng.randint(0, n_blobs, n)]
        X = (X + rng.normal(size=(n, d))).astype(np.float32)
    X[-5:] = X[:5]
    return X


def _dist64(X, C, metric):
    """float64 distances (n, k) of frames to centers."""
    X, C = np.asarray(X, np.float64), np.asarray(C, np.float64)
    if metric == 'euclidean':
        return np.sqrt(((X[:, None] - C[None]) ** 2).sum(-1))
    if metric == 'manhattan':
        return np.abs(X[:, None] - C[None]).sum(-1)
    return (X[:, None] != C[None]).mean(-1)


def assert_same_covering(port, ref, X, metric):
    """Centers equal up to the first near tie (both frames equally far,
    within 1e-5, from the centers before it); the covering radius equal
    within 1e-5; with the same centers, the same labels up to near ties."""
    pc, rc = np.asarray(port.center_indices), np.asarray(ref.center_indices)
    diff = np.flatnonzero(pc != rc)
    if len(diff):
        i = int(diff[0])
        d = _dist64(X[[pc[i], rc[i]]], X[pc[:i]], metric).min(1)
        assert abs(d[0] - d[1]) <= 1e-5 * d.max(), (i, d)
    rp, rr = float(port.distances.max()), float(ref.distances.max())
    assert abs(rp - rr) <= 1e-5 * rr
    if not len(diff):
        np.testing.assert_allclose(port.distances, ref.distances, rtol=1e-5)


def assert_labels_close(pa, pd, ja, jd, X, C, metric):
    """Assignments equal but for near ties (a flipped frame lies equally
    far from both centers on the metric's bar); distances on the bar."""
    if metric == 'hamming':
        np.testing.assert_array_equal(pa, ja)
        np.testing.assert_array_equal(pd, jd)
        return
    flip = np.flatnonzero(pa != ja)
    both = _dist64(X[flip], C, metric)
    dp, dj = both[np.arange(len(flip)), pa[flip]], \
        both[np.arange(len(flip)), ja[flip]]
    assert (np.abs(dp - dj) <= 1e-5 * np.maximum(dp, dj) + 1e-3).all()
    assert len(flip) <= 3, len(flip)
    if metric == 'euclidean':
        assert_gram_close(pd, jd, X, C)
    else:
        np.testing.assert_allclose(pd, jd, rtol=1e-5)


@pytest.mark.parametrize('metric', METRICS)
def test_kcenters_device_matches_jax(metric):
    X = features(metric)
    ref = jengine.kcenters_device(X, metric, n_clusters=40)
    port = engine.kcenters_device(X, metric, n_clusters=40)
    assert port.n_found == ref.n_found == 40
    np.testing.assert_array_equal(port.center_indices, ref.center_indices)
    np.testing.assert_array_equal(port.assignments, ref.assignments)
    assert port.distances.dtype == np.float64
    if metric == 'hamming':
        np.testing.assert_array_equal(port.distances, ref.distances)
    else:
        np.testing.assert_allclose(port.distances, ref.distances, rtol=1e-5)
    # the duplicates of frames 0-4 sit at 0 from them
    assert (port.distances[-5:] == port.distances[:5]).all()
    t = engine.kcenters_device(torch.from_numpy(X), metric, n_clusters=40)
    np.testing.assert_array_equal(t.center_indices, port.center_indices)


@pytest.mark.parametrize('metric', METRICS)
def test_cutoff_and_warm_start_match_jax(metric):
    """The cutoff stop, and a warm start from 10 centers to 25, equal
    the JAX package's and the uninterrupted run."""
    X = features(metric, seed=1)
    full = jengine.kcenters_device(X, metric, n_clusters=25)
    cut = float(full.distances.max()) if metric != 'hamming' else 0.5
    ref = jengine.kcenters_device(X, metric, dist_cutoff=cut)
    port = engine.kcenters_device(X, metric, dist_cutoff=cut)
    assert port.n_found == ref.n_found
    np.testing.assert_array_equal(port.center_indices, ref.center_indices)
    assert port.distances.max() <= cut
    half = jengine.kcenters_device(X, metric, n_clusters=10)
    warm = dict(init_distances=half.distances,
                init_assignments=half.assignments, n_init_centers=10,
                init_center_indices=half.center_indices)
    ref = jengine.kcenters_device(X, metric, n_clusters=25, **warm)
    port = engine.kcenters_device(X, metric, n_clusters=25, **warm)
    for r in (ref, full):
        np.testing.assert_array_equal(port.center_indices, r.center_indices)
        np.testing.assert_array_equal(port.assignments, r.assignments)


@pytest.mark.parametrize('n_shards', [2, 4])
def test_mesh_matches_one_device(n_shards):
    """A CPU FrameMesh of 2 and 4 shards (1499 frames: padded shards),
    and of one, against one device; the sharded assignment equals one
    device's."""
    for metric in METRICS:
        X = features(metric, n=1499, seed=2)
        one = engine.kcenters_device(X, metric, n_clusters=30)
        mesh = FrameMesh(['cpu'] * n_shards)
        sh = engine.kcenters_device(X, metric, n_clusters=30, mesh=mesh)
        assert_same_covering(sh, one, X, metric)
        k = kcenters(X, metric, n_clusters=30, mesh=mesh)
        np.testing.assert_array_equal(k.center_indices, sh.center_indices)
        one_shard = engine.kcenters_device(X, metric, n_clusters=30,
                                           mesh=FrameMesh(['cpu']))
        np.testing.assert_array_equal(one_shard.center_indices,
                                      one.center_indices)
        C = X[one.center_indices]
        a1, d1 = engine.assign_device(X, C, metric)
        am, dm = engine.assign_device(X, C, metric, mesh=mesh)
        np.testing.assert_array_equal(am, a1)
        np.testing.assert_array_equal(dm, d1)


@pytest.mark.parametrize('k', [513, 1000])
def test_assign_device_across_the_block_edge(k):
    """k centers past one 512-wide block, with an exact duplicate of
    center 10 in the second block (the first wins) and duplicate
    frames."""
    for metric in METRICS:
        X = features(metric, n=1200, d=10, seed=k)
        rng = np.random.default_rng(k)
        C = X[rng.choice(len(X), k, replace=False)]
        dup = min(600, k - 1)
        C[dup] = C[10]
        ja, jd = jengine.assign_device(X, C, metric)
        pa, pd = engine.assign_device(X, C, metric)
        assert pa.dtype == np.int64 and pd.dtype == np.float64
        assert_labels_close(pa, pd, np.asarray(ja), np.asarray(jd), X, C,
                            metric)
        assert not (pa == dup).any() and (pa == 10).any()
        np.testing.assert_array_equal(pa[-5:], pa[:5])


def _jax_bits(key, s, n):
    return np.asarray(jax.random.bits(jax.random.fold_in(key, s), (n,),
                                      jnp.uint32)).astype(np.int64)


def test_pam_sweeps_euclidean_match_jax():
    """The device PAM sweeps on euclidean features, fed the random bits
    the JAX module draws, accept the same swaps."""
    n, k, n_sweeps, batch = 600, 20, 2, 8
    X = features('euclidean', n=n, d=8, seed=3, n_blobs=40)
    seed = jengine.kcenters_device(X, 'euclidean', n_clusters=k)
    d1 = seed.distances.astype(np.float32)
    a1 = seed.assignments.astype(np.int32)
    minds = np.asarray(seed.center_indices, np.int32)
    key = jax.random.PRNGKey(7)
    bucket = int(min(n, max(64, 8 * ((n + k - 1) // k))))
    jd, ja, jm = jek._pam_sweeps(
        jnp.asarray(X), jnp.ones(n, bool), jnp.asarray(d1), jnp.asarray(a1),
        jnp.asarray(minds), key, 'euclidean', n_sweeps, bucket, batch=batch)
    prep = engine.prepare_sharded(X, 'euclidean')
    assert prep.n_pad == n and prep.device == torch.device('cpu')
    bits = [torch.from_numpy(_jax_bits(key, s, n)) for s in range(n_sweeps)]
    n0 = qcp_matrix.qcp_rmsd_matrix_kernel.n_launches
    (pd,), (pa,), pm = engine_kmedoids._pam_sweeps(
        prep, [torch.from_numpy(d1)], [torch.from_numpy(a1)],
        minds.astype(np.int64), bits, bucket, batch=batch)
    assert qcp_matrix.qcp_rmsd_matrix_kernel.n_launches == n0
    np.testing.assert_array_equal(pm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(pa.numpy(), np.asarray(ja))
    assert_gram_close(pd.numpy(), np.asarray(jd), X, X)
    assert not np.array_equal(np.asarray(jm), minds), 'no swap accepted'


@pytest.mark.parametrize('algo', ['hybrid', 'kmedoids'])
def test_hybrid_and_kmedoids_match_jax(algo):
    """``hybrid`` and ``kmedoids`` by euclidean (the host PAM path, as
    both packages run it on the CPU) equal the JAX package's."""
    X = features('euclidean', n=500, d=6, seed=4, n_blobs=30)
    if algo == 'hybrid':
        kw = dict(n_iters=2, n_clusters=12, random_state=5)
        ref, port = jax_hybrid(X, 'euclidean', **kw), \
            hybrid(X, 'euclidean', **kw)
    else:
        # scaled down: the cold start's Gram self-distances, about
        # sqrt(eps |x|^2), must pass the warm-start gate of 1e-3
        X = X * np.float32(0.1)
        kw = dict(n_clusters=9, n_iters=2, random_state=2)
        ref, port = jax_kmedoids(X, 'euclidean', **kw), \
            kmedoids(X, 'euclidean', **kw)
    np.testing.assert_array_equal(np.asarray(port.center_indices),
                                  np.asarray(ref.center_indices))
    np.testing.assert_array_equal(port.assignments, ref.assignments)
    np.testing.assert_allclose(port.distances, ref.distances, rtol=1e-5,
                               atol=1e-3)
    for c, i in zip(port.centers, port.center_indices):
        np.testing.assert_array_equal(c, X[i])


def test_kcenters_api_with_features():
    """``kcenters`` with init centers and a random first center, and the
    estimator, equal the JAX package's."""
    X = features('manhattan', n=800, d=7, seed=5)
    for kw in (dict(init_centers=[X[3], X[400]]),
               dict(random_first_center=True, random_state=11)):
        ref = jax_kcenters(X, 'manhattan', n_clusters=15, **kw)
        port = kcenters(X, 'cityblock', n_clusters=15, **kw)
        np.testing.assert_array_equal(port.center_indices,
                                      ref.center_indices)
        np.testing.assert_array_equal(port.assignments, ref.assignments)
        for c, r in zip(port.centers, ref.centers):
            np.testing.assert_array_equal(c, r)
    est = KCenters('hamming', n_clusters=6).fit(features('hamming', n=300))
    jest = JaxKCenters('hamming', n_clusters=6).fit(features('hamming',
                                                             n=300))
    np.testing.assert_array_equal(est.labels_, jest.labels_)
    new = features('hamming', n=40, seed=9)
    np.testing.assert_array_equal(est.predict(new).assignments,
                                  jest.predict(new).assignments)


def test_assign_device_defaults_to_euclidean():
    """Both packages' ``assign_device`` measure with 'euclidean' when no
    metric is named."""
    for fn in (engine.assign_device, jengine.assign_device):
        assert inspect.signature(fn).parameters['metric'].default == \
            'euclidean'
    X = features('euclidean', n=300, d=5, seed=6)
    C = X[[0, 100, 200]]
    ja, jd = jengine.assign_device(X, C)
    pa, pd = engine.assign_device(X, C)
    np.testing.assert_array_equal(pa, ja)
    assert_gram_close(pd, jd, X, C)


def test_feature_errors_match_jax():
    X = features('euclidean', n=50, d=4)
    coords = np.zeros((50, 4, 3), np.float32)
    for kw in (dict(precision='bf16'), dict(sort='locality'),
               dict(n_clusters=None)):
        with pytest.raises(ValueError) as ref:
            jengine.kcenters_device(X, 'euclidean', **dict(
                dict(n_clusters=3), **kw))
        with pytest.raises(ValueError) as port:
            engine.kcenters_device(X, 'euclidean', **dict(
                dict(n_clusters=3), **kw))
        assert str(port.value) == str(ref.value)
    with pytest.raises(ValueError, match='supports metrics'):
        engine.kcenters_device(X, 'cosine', n_clusters=3)
    # 'rmsd' takes both and passes them on to kcenters_device_fused
    R = np.random.default_rng(2).normal(size=(50, 4, 3)).astype(np.float32)
    res = engine.kcenters_device(R, 'rmsd', n_clusters=3, precision='bf16',
                                 sort='locality')
    assert res.n_found == 3
    np.testing.assert_array_equal(res.assignments[res.center_indices],
                                  np.arange(3))
    prep_r = engine.prepare_rmsd_frames(coords + np.arange(50)[:, None, None])
    prep_f = engine.prepare_sharded(X, 'euclidean')
    with pytest.raises(ValueError, match='prepared for'):
        engine.kcenters_device(prep_r, 'euclidean', n_clusters=3)
    with pytest.raises(ValueError, match='prepared for'):
        engine.assign_device(prep_f, coords[:2], 'rmsd')
    with pytest.raises(ValueError, match='feature vectors'):
        engine.kcenters_device(coords, 'hamming', n_clusters=3)
    with pytest.raises(ValueError, match='centers must be'):
        engine.assign_device(X, X[:2, :3])
    with pytest.raises(ValueError, match='laid out for'):
        engine.assign_device(prep_f, X[:2], mesh=FrameMesh(['cpu'] * 2))


def test_hybrid_device_and_device_sweeps_on_features():
    """``hybrid_device`` and the device sweeps (``backend='device'``, on
    the CPU) run every feature metric: the PAM cost never rises above
    k-centers', every medoid sits at 0 from itself."""
    for metric in ('manhattan', 'hamming'):
        X = features(metric, n=400, d=9, seed=7)
        kc = engine.kcenters_device(X, metric, n_clusters=10)
        hd = hybrid_device(X, metric, n_clusters=10, n_iters=2, seed=1)
        assert len(hd.center_indices) == 10
        assert np.mean(hd.distances ** 2) <= np.mean(kc.distances ** 2)
        assert (hd.distances[hd.center_indices] == 0).all()
        m, d, a = engine_kmedoids.kmedoids_sweeps_device(
            engine.prepare_sharded(X, metric), metric, kc.assignments,
            kc.distances, kc.center_indices, n_sweeps=2, seed=1)
        np.testing.assert_array_equal(m, hd.center_indices)
        np.testing.assert_array_equal(a, hd.assignments)
