"""enspara_tpu_torch ``ops/distances`` and ``geometry/libdist`` held
against the JAX package.

The same seeded numpy inputs go through both. Bars: the difference
forms (point against set) and manhattan within rtol 1e-5 (fp32 sums in
another order); the Gram form of the pairwise euclidean on the d^2 bar
of ``assert_gram_close`` (16 ulp of ``|x|^2 + |c|^2``); hamming bit for
bit (an exact count times the float32 1/d, as XLA lowers the JAX
mean); libdist
(float64 numpy in both) equal, its error messages word for word.
"""

import numpy as np
import pytest
import torch

from enspara_tpu.geometry import libdist as jax_libdist
from enspara_tpu.ops import distances as jdist

from enspara_tpu_torch.exception import DataInvalid
from enspara_tpu_torch.geometry import libdist
from enspara_tpu_torch.ops import distances

from test_torch_port import assert_gram_close


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


def _data(metric, n=700, d=13, seed=0):
    """Feature rows for ``metric``: float32 blobs, or int32 labels of 3
    states (rotamer-like) for hamming."""
    rng = np.random.default_rng(seed)
    X = (4 * rng.normal(size=(20, d)))[rng.integers(0, 20, n)] \
        + rng.normal(size=(n, d))
    if metric == 'hamming':
        return rng.integers(0, 3, size=(n, d)).astype(np.int32)
    return X.astype(np.float32)


@pytest.mark.parametrize('metric', ['euclidean', 'manhattan', 'hamming'])
def test_to_point_matches_jax(metric):
    X = _data(metric)
    y = X[17]
    ref = np.asarray(jdist.distance_to_point(X, y, metric))
    port = distances.distance_to_point(X, y, metric)
    assert port.dtype == torch.float32 and port.shape == (len(X),)
    if metric == 'hamming':
        np.testing.assert_array_equal(port.numpy(), ref)
    else:
        np.testing.assert_allclose(port.numpy(), ref, rtol=1e-5, atol=1e-6)
    assert float(port[17]) == 0.0
    if metric == 'manhattan':
        np.testing.assert_array_equal(
            distances.distance_to_point(X, y, 'cityblock').numpy(),
            port.numpy())
    fn = getattr(distances, metric + '_to_point')
    np.testing.assert_array_equal(fn(torch.from_numpy(X),
                                     torch.from_numpy(y)).numpy(),
                                  port.numpy())


@pytest.mark.parametrize('metric', ['euclidean', 'manhattan', 'hamming'])
def test_pairwise_matches_jax(metric, monkeypatch):
    """Every pairwise form against JAX, and the broadcast forms cut into
    center chunks equal to the uncut pass."""
    X, Y = _data(metric, seed=1), _data(metric, n=37, seed=2)
    ref = np.asarray(jdist.pairwise_distance(X, Y, metric))
    port = distances.pairwise_distance(X, Y, metric).numpy()
    assert port.shape == (len(X), len(Y)) and port.dtype == np.float32
    if metric == 'euclidean':
        assert_gram_close(port, ref, X, Y)
        sq = distances.pairwise_euclidean(X, Y, squared=True).numpy()
        np.testing.assert_allclose(np.sqrt(sq), port, rtol=1e-6)
    elif metric == 'hamming':
        np.testing.assert_array_equal(port, ref)
    else:
        np.testing.assert_allclose(port, ref, rtol=1e-5)
    monkeypatch.setattr(distances, '_BROADCAST_ELEMS', 5 * X.size)
    np.testing.assert_array_equal(
        distances.pairwise_distance(X, Y, metric).numpy(), port)


def test_hamming_is_exact_for_any_int32():
    """Values past 2^24 (where float32 casts collide) still count
    exactly; the mean is the JAX mean bit for bit."""
    rng = np.random.default_rng(3)
    X = rng.integers(2 ** 30, 2 ** 30 + 4, size=(300, 9)).astype(np.int32)
    X[:, 0] = 2 ** 30 + X[:, 0] % 2       # differ by 1 above 2^24
    Y = X[[0, 5, 100]].copy()
    ref = np.asarray(jdist.pairwise_hamming(X, Y))
    port = distances.pairwise_hamming(X, Y).numpy()
    np.testing.assert_array_equal(port, ref)
    want = (X[:, None, :] != Y[None]).sum(-1).astype(np.float32)
    np.testing.assert_array_equal(port, want * np.float32(1 / 9))


def test_identical_points():
    """Identical rows: 0 in the difference forms, the clamp keeps the
    Gram form's d^2 at or above 0."""
    X = np.repeat(_data('euclidean', n=5, seed=4), 3, axis=0)
    for metric in ('euclidean', 'manhattan', 'hamming'):
        Xm = X.astype(np.int32) if metric == 'hamming' else X
        d = distances.distance_to_point(Xm, Xm[4], metric).numpy()
        assert (d[3:6] == 0).all()
        assert (distances.pairwise_distance(Xm, Xm, metric).numpy()
                >= 0).all()
    sq = distances.pairwise_euclidean(X, X, squared=True).numpy()
    assert (sq >= 0).all()
    assert_gram_close(np.sqrt(sq[np.arange(15), np.arange(15)]),
                      np.zeros(15), X, X)


def test_dispatch_and_numpy_mirror_match_jax():
    X, Y = _data('manhattan', n=30), _data('manhattan', n=7, seed=5)
    for metric in ('euclidean', 'manhattan', 'cityblock', 'hamming'):
        np.testing.assert_array_equal(
            distances.pairwise_distance_np(X, Y, metric),
            jdist.pairwise_distance_np(X, Y, metric))
    for fn, jfn in ((distances.pairwise_distance, jdist.pairwise_distance),
                    (distances.distance_to_point, jdist.distance_to_point)):
        with pytest.raises(ValueError) as ref:
            jfn(X, Y, 'rmsd')
        with pytest.raises(ValueError) as port:
            fn(X, Y, 'rmsd')
        assert str(port.value) == str(ref.value)


def test_libdist_matches_jax():
    for name in ('euclidean', 'manhattan', 'hamming'):
        X = _data('euclidean', n=50, d=6, seed=6)
        if name == 'hamming':
            X = np.round(X)
        y = X[3]
        ref = getattr(jax_libdist, name)(X, y)
        port = getattr(libdist, name)(X, y)
        assert port.dtype == np.float64
        np.testing.assert_array_equal(port, ref)
        out = np.full(50, -1.0)
        assert getattr(libdist, name)(X, y, out=out) is out
        np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize('bad', ['X_ndim', 'y_ndim', 'width', 'out_dtype',
                                 'out_ndim', 'out_len'])
def test_libdist_errors_match_jax(bad):
    X, y, out = np.zeros((4, 3)), np.zeros(3), None
    if bad == 'X_ndim':
        X = np.zeros((4, 3, 1))
    elif bad == 'y_ndim':
        y = np.zeros((1, 3))
    elif bad == 'width':
        y = np.zeros(2)
    elif bad == 'out_dtype':
        out = np.zeros(4, np.float32)
    elif bad == 'out_ndim':
        out = np.zeros((4, 1))
    else:
        out = np.zeros(5)
    from enspara_tpu.exception import DataInvalid as JaxDataInvalid
    with pytest.raises(JaxDataInvalid) as ref:
        jax_libdist.euclidean(X, y, out=out)
    with pytest.raises(DataInvalid) as port:
        libdist.euclidean(X, y, out=out)
    assert str(port.value) == str(ref.value)
