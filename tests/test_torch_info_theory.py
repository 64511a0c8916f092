"""The port's joint counts, mutual information and entropies
(``enspara_tpu_torch.info_theory``) held against the JAX package's on
the same numpy inputs, on the CPU: joint counts exactly (uint32, int64
past 2^32, counts above 256, several chunks, a 4-shard CPU mesh), MI,
NMI/APC, weighted MI and the entropy functions within 1e-12.
"""

import numpy as np
import pytest
import torch

from enspara_tpu.info_theory import entropy as jax_entropy
from enspara_tpu.info_theory import libinfo as jax_libinfo
from enspara_tpu.info_theory import mutual_info as jax_mi

from enspara_tpu_torch.exception import DataInvalid
from enspara_tpu_torch.info_theory import entropy, libinfo, mutual_info
from enspara_tpu_torch.parallel import FrameMesh


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


def _correlated(rng, T, F, n, dtype=np.int16, dwell=20):
    """(T, F) labels in [0, n) that hold their value ~dwell frames, the
    features partly copies of each other (so the MI is not ~0)."""
    hidden = np.cumsum(rng.random((T, 3)) < 1 / dwell, axis=0) % n
    X = hidden[:, rng.integers(0, 3, F)]
    noise = rng.random((T, F)) < 0.1
    X[noise] = rng.integers(0, n, int(noise.sum()))
    return X.astype(dtype)


@pytest.mark.parametrize('case', ['int16', 'uint8_bool', 'chunks',
                                  'over_256'])
def test_joint_counts_equal_jax(case, monkeypatch):
    rng = np.random.default_rng(1)
    if case == 'uint8_bool':
        # 256 states in uint8 and bool labels
        X = rng.integers(0, 256, (3000, 3)).astype(np.uint8)
        Y = rng.random((3000, 4)) < 0.3
        n_x, n_y = 256, 2
    else:
        X = _correlated(rng, 5000, 5, 3)
        Y = _correlated(rng, 5000, 4, 2, dtype=np.int32)
        n_x, n_y = 3, 2
    if case == 'chunks':
        monkeypatch.setattr(libinfo, '_CHUNK_ELEMENTS', 64 * 11)
    if case == 'over_256':
        X[:, 0] = 1             # every count of feature 0 above 256
    jc = libinfo.matrix_bincount2d(X, Y, n_x, n_y)
    ref = jax_libinfo.matrix_bincount2d(X, Y, n_x, n_y)
    assert jc.dtype == ref.dtype == np.uint32
    np.testing.assert_array_equal(jc, ref)
    np.testing.assert_array_equal(
        libinfo.matrix_bincount2d_np(X, Y, n_x, n_y),
        jax_libinfo.matrix_bincount2d_np(X, Y, n_x, n_y))
    np.testing.assert_array_equal(libinfo.bincount2d(X[:, 0], Y[:, 1], n_x,
                                                     n_y),
                                  jax_libinfo.bincount2d(X[:, 0], Y[:, 1],
                                                         n_x, n_y))
    if case == 'over_256':
        assert jc[0, 0].max() > 256
        same = libinfo.matrix_bincount2d(X, X, n_x, n_x)
        np.testing.assert_array_equal(
            same, jax_libinfo.matrix_bincount2d(X, X, n_x, n_x))


def test_joint_counts_past_2_32_are_int64(monkeypatch):
    """A count at 2^32 turns the result int64, as in the JAX package
    (the product is shifted: no test can hold 2^32 frames)."""
    count = libinfo._count
    monkeypatch.setattr(libinfo, '_count',
                        lambda *a: count(*a) + 2 ** 32)
    X = _correlated(np.random.default_rng(2), 300, 3, 3)
    jc = libinfo.matrix_bincount2d(X, X, 3, 3)
    assert jc.dtype == np.int64
    np.testing.assert_array_equal(
        jc - 2 ** 32, jax_libinfo.matrix_bincount2d(X, X, 3, 3))


@pytest.mark.parametrize('same', [True, False])
def test_joint_counts_over_a_cpu_mesh(same, monkeypatch):
    """FrameMesh(['cpu'] * 4): 1003 frames (no multiple of 4), in chunks
    that cut the shards unevenly, equal to the JAX counts."""
    monkeypatch.setattr(libinfo, '_CHUNK_ELEMENTS', 9 * 301)
    rng = np.random.default_rng(4)
    X = rng.integers(0, 4, size=(1003, 3)).astype('int16')
    Y = X if same else rng.integers(0, 2, size=(1003, 6)).astype('int16')
    n_y = 4 if same else 2
    mesh = FrameMesh(['cpu'] * 4)
    jc = libinfo.matrix_bincount2d(X, Y, 4, n_y, mesh=mesh)
    np.testing.assert_array_equal(
        jc, jax_libinfo.matrix_bincount2d(X, Y, 4, n_y))
    np.testing.assert_array_equal(
        mutual_info.joint_counts(X, None if same else Y, 4,
                                 None if same else 2, mesh=mesh), jc)


@pytest.mark.parametrize('bad', ['negative', 'contiguous', 'length',
                                 'mesh_and_device'])
def test_joint_count_contracts(bad):
    X = np.zeros((10, 2), np.int16)
    Y = np.ones((10, 2), np.int16)
    if bad == 'negative':
        X[3, 1] = -1
        with pytest.raises(AssertionError, match='non-negative'):
            libinfo.matrix_bincount2d(X, Y, 2, 2)
        with pytest.raises(AssertionError, match='non-negative'):
            jax_mi.joint_counts(X, Y, 2, 2)
    elif bad == 'contiguous':
        with pytest.raises(AssertionError, match='contiguous'):
            libinfo.matrix_bincount2d(X, Y, 2, 1)
    elif bad == 'length':
        with pytest.raises(AssertionError, match='match in length'):
            libinfo.matrix_bincount2d(X, Y[:9], 2, 2)
    else:
        with pytest.raises(ValueError, match='not both'):
            libinfo.matrix_bincount2d(X, Y, 2, 2, mesh=FrameMesh(['cpu']),
                                      device='cpu')


def test_mi_and_normalizations_match_jax():
    rng = np.random.default_rng(5)
    Xs = [_correlated(rng, 800, 6, 3), _correlated(rng, 500, 6, 3)]
    Ys = [_correlated(rng, 800, 6, 2), _correlated(rng, 500, 6, 2)]
    n_x, n_y = np.full(6, 3), np.full(6, 2)
    for normalize in (True, False):
        np.testing.assert_allclose(
            mutual_info.mi_matrix(Xs, Ys, n_x, n_y, normalize=normalize),
            jax_mi.mi_matrix(Xs, Ys, n_x, n_y, normalize=normalize),
            rtol=0, atol=1e-12)
    mi = mutual_info.mi_matrix(Xs, Xs, n_x, n_x)
    np.testing.assert_allclose(
        mi, mutual_info.mi_matrix_serial(Xs, Xs, n_x, n_x), atol=1e-12)
    for name in ('mi_to_nmi', 'mi_to_apc', 'mi_to_nmi_apc',
                 'deconvolute_network'):
        np.testing.assert_allclose(getattr(mutual_info, name)(mi),
                                   getattr(jax_mi, name)(mi), rtol=0,
                                   atol=1e-12, err_msg=name)
    jc = mutual_info.joint_counts(Xs[0], Ys[0])
    np.testing.assert_allclose(mutual_info.mutual_information(jc),
                               jax_mi.mutual_information(jc), atol=1e-12)
    with pytest.raises(DataInvalid, match='4-D'):
        mutual_info.mutual_information(jc[0, 0])
    with pytest.raises(DataInvalid, match='fewer than 2 states'):
        mutual_info.channel_capacity_normalization(mi, np.full(6, 1),
                                                   n_x)
    with pytest.raises(DataInvalid, match='feature count differs'):
        mutual_info.check_features_states([Xs[0], Xs[1][:, :5]], n_x)


@pytest.mark.parametrize('case', ['three_states', 'bool', 'uniform'])
def test_weighted_mi_matches_jax(case):
    """The port's float64 one-hot product against the JAX package's
    float64 host einsum (the size below its fp32 switch)."""
    rng = np.random.default_rng(6)
    X = _correlated(rng, 2000, 7, 3, dtype=np.int64)
    w = rng.random(2000)
    states = np.full(7, 3)
    if case == 'bool':
        X, states = X > 0, None
    if case == 'uniform':
        w = None
    np.testing.assert_allclose(
        mutual_info.weighted_mi(X, w, states),
        jax_mi.weighted_mi(X, w, states), rtol=0, atol=1e-12)


def test_entropy_functions_match_jax():
    rng = np.random.default_rng(7)
    p, q = rng.random((4, 6)), rng.random((4, 6))
    p[0, 2] = 0.0
    assert abs(entropy.shannon_entropy(p) - jax_entropy.shannon_entropy(p)) \
        <= 1e-12
    for name in ('kl_divergence', 'js_divergence'):
        np.testing.assert_allclose(getattr(entropy, name)(p, q),
                                   getattr(jax_entropy, name)(p, q),
                                   atol=1e-12, err_msg=name)
    u = rng.normal(size=9)
    np.testing.assert_allclose(entropy.energy_to_probability(u),
                               jax_entropy.energy_to_probability(u),
                               atol=1e-12)
    assigns = rng.integers(0, 5, (2, 300))
    P = entropy.Q_from_assignments(assigns, n_states=5, lag_time=2)
    np.testing.assert_allclose(
        P, jax_entropy.Q_from_assignments(assigns, n_states=5, lag_time=2),
        atol=1e-12)
    Q = rng.random((5, 5)) + 0.1
    Q /= Q.sum(1, keepdims=True)
    for kw in ({}, {'state_subset': [0, 2, 3]}):
        assert abs(entropy.relative_entropy_msm(P, Q, **kw)
                   - jax_entropy.relative_entropy_msm(P, Q, **kw)) <= 1e-12
    np.testing.assert_allclose(
        entropy.relative_entropy_per_state(P, assignments=assigns),
        jax_entropy.relative_entropy_per_state(P, assignments=assigns),
        atol=1e-12)
    with pytest.raises(DataInvalid, match='negative'):
        entropy.kl_divergence(-p, q)
