"""The port's device MLE and device KMC, and its host copies of
``synthetic_ensemble`` and BACE, held against the JAX package on the
same seeded inputs on the CPU.

Bars: ``mle_device`` T and pi within 1e-5 of the JAX ``mle_device`` and
within 5e-4 of the host ``mle`` (the JAX package's own bar,
tests/test_msm.py:223), T within 1e-8 of it (the port sweeps in
float64); the KMC, whose random stream cannot match the
JAX package's, holds the contract (shape, int32, the start column, every
step an edge with T > 0, frequencies within 5 binomial sigma of T);
``synthetic_ensemble`` rtol 1e-12; BACE labels exactly equal and Bayes
factors at 1e-12 (the cases of tests/test_bace_reference_spec.py and
tests/test_bace.py)."""

import warnings

import numpy as np
import pytest
import scipy.sparse
import torch

from enspara_tpu.msm import bace as jax_bace
from enspara_tpu.msm import builders as jax_builders
from enspara_tpu.msm import synthetic_data as jax_synthetic

from enspara_tpu_torch.exception import ConvergenceWarning, DataInvalid
from enspara_tpu_torch.msm import bace, builders, synthetic_data


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


def _counts(seed, n):
    """tests/test_msm.py :: _random_counts."""
    return np.random.default_rng(seed).integers(1, 50, size=(n, n)).astype(
        float)


@pytest.mark.parametrize('container', [np.array, scipy.sparse.csr_matrix])
def test_mle_device_matches_jax_and_host(container):
    def dense(M):
        return M.toarray() if scipy.sparse.issparse(M) else np.asarray(M)
    for seed, n in ((3, 10), (5, 8)):
        C = container(_counts(seed, n))
        C_out, T, pi = builders.mle_device(C)
        _, T_jax, pi_jax = jax_builders.mle_device(C)
        _, T_host, pi_host = builders.mle(C)
        assert isinstance(T, type(C)) and isinstance(C_out, type(C))
        np.testing.assert_allclose(dense(T), dense(T_jax), rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(pi, pi_jax, rtol=0, atol=1e-5)
        np.testing.assert_allclose(dense(T), dense(T_host), rtol=0,
                                   atol=5e-4)
        np.testing.assert_allclose(pi, pi_host, rtol=0, atol=5e-4)
        np.testing.assert_allclose(dense(T).sum(axis=1), 1.0, atol=1e-12)
        # the port sweeps in float64 (the JAX package in float32)
        np.testing.assert_allclose(dense(T), dense(T_host), rtol=0,
                                   atol=1e-8)


def test_mle_device_refuses_a_state_without_counts_and_warns():
    C = _counts(1, 6)
    C[4, :] = C[:, 4] = 0
    with pytest.raises(ValueError, match='at least one transition'):
        builders.mle_device(C)
    with pytest.raises(ValueError, match='at least one transition'):
        jax_builders.mle_device(C)
    with pytest.warns(ConvergenceWarning, match='max_iter=1'):
        builders.mle_device(_counts(1, 6), max_iter=1)
    with warnings.catch_warnings():
        warnings.simplefilter('error')
        _, _, pi = builders.mle_device(_counts(1, 6),
                                       calculate_eq_probs=False)
    assert pi is None


@pytest.mark.parametrize('seed,n', [(3, 10), (7, 40)])
def test_block_stop_is_the_per_sweep_stop(seed, n):
    """Sweeps in blocks of 32 with a frozen X stop where a check after
    every sweep stops: the same X bit for bit and the same count."""
    Cj = torch.as_tensor(_counts(seed, n))
    X1, n1, d1 = builders._jacobi_mle(Cj, 1e-11, 2000, block=1)
    X32, n32, d32 = builders._jacobi_mle(Cj, 1e-11, 2000, block=32)
    assert 1 <= n1 < 2000 and n1 % 32 != 0
    assert (n32, d32) == (n1, d1) and torch.equal(X32, X1)
    # cut at max_iter inside a block: the count and X of the cut
    Xc, nc, _ = builders._jacobi_mle(Cj, 1e-11, n1 - 1, block=32)
    Xs, ns, _ = builders._jacobi_mle(Cj, 1e-11, n1 - 1, block=1)
    assert nc == ns == n1 - 1 and torch.equal(Xc, Xs)


def _kmc_T():
    """A 6-state row-stochastic T with zeros in every row."""
    T = np.array([[0.5, 0.5, 0, 0, 0, 0],
                  [0.2, 0.3, 0.5, 0, 0, 0],
                  [0, 0.1, 0.2, 0.7, 0, 0],
                  [0, 0, 0.3, 0, 0.6, 0.1],
                  [0.25, 0, 0, 0.25, 0.5, 0],
                  [0, 0, 0, 0, 0.9, 0.1]])
    return T


@pytest.mark.parametrize('container', [np.array, scipy.sparse.csr_matrix])
def test_kmc_contract(container):
    T = _kmc_T()
    start = np.arange(400) % 6
    chains = synthetic_data.synthetic_trajectory_device(
        container(T), start, 300)
    assert chains.shape == (400, 300) and chains.dtype == np.int32
    assert np.array_equal(chains[:, 0], start)
    src, dst = chains[:, :-1].ravel(), chains[:, 1:].ravel()
    assert (T[src, dst] > 0).all()
    freq = np.zeros_like(T)
    np.add.at(freq, (src, dst), 1)
    visits = freq.sum(axis=1)
    assert (visits >= 1000).all()
    emp = freq / visits[:, None]
    sigma = np.sqrt(T * (1 - T) / visits[:, None])
    assert (np.abs(emp - T) <= 5 * sigma + 1e-12).all()


def test_kmc_generator_and_zero_rows():
    T = _kmc_T()
    start = np.arange(50) % 6

    def run(seed):
        gen = torch.Generator().manual_seed(seed)
        return synthetic_data.synthetic_trajectory_device(T, start, 100,
                                                          generator=gen)
    assert np.array_equal(run(4), run(4))
    assert not np.array_equal(run(4), run(5))
    # the default generator is seeded 0 on the device
    assert np.array_equal(
        synthetic_data.synthetic_trajectory_device(T, start, 100), run(0))
    T[5] = 0.0      # state 5 is reached from state 3 and has no way out
    with pytest.raises(DataInvalid, match='row 5'):
        synthetic_data.synthetic_trajectory_device(T, start, 100)


@pytest.mark.parametrize('sparse_T', [False, True])
def test_synthetic_ensemble_matches_jax(sparse_T):
    T = _kmc_T()
    T_in = scipy.sparse.csr_matrix(T) if sparse_T else T
    p0 = np.random.default_rng(2).random(6)
    p0 /= p0.sum()
    obs = np.arange(6.0) ** 2
    for kw in ({}, {'observable_per_state': obs}):
        p, traj = synthetic_data.synthetic_ensemble(T_in, p0, 25, **kw)
        p_ref, traj_ref = jax_synthetic.synthetic_ensemble(T_in, p0, 25, **kw)
        np.testing.assert_allclose(p, p_ref, rtol=1e-12)
        np.testing.assert_allclose(traj, traj_ref, rtol=1e-12)


# tests/test_bace.py :: TCOUNTS, the published simple model
SIMPLE = np.array(
    [[1000, 100, 100, 10, 0, 0, 0, 0, 0],
     [100, 1000, 100, 0, 0, 0, 0, 0, 0],
     [100, 100, 1000, 0, 1, 0, 0, 0, 0],
     [10, 0, 0, 1000, 100, 100, 10, 0, 0],
     [0, 0, 1, 100, 1000, 100, 0, 0, 0],
     [0, 0, 0, 100, 100, 1000, 0, 1, 0],
     [0, 0, 0, 10, 0, 0, 1000, 100, 100],
     [0, 0, 0, 0, 0, 1, 100, 1000, 100],
     [0, 0, 0, 0, 0, 0, 100, 100, 1000]])


def _block_counts(seed, n_blocks=4, block=10):
    """tests/test_bace.py :: _block_counts."""
    rng = np.random.default_rng(seed)
    n = n_blocks * block
    C = np.ones((n, n))
    for b in range(n_blocks):
        s = slice(b * block, (b + 1) * block)
        C[s, s] += rng.integers(40, 400, size=(block, block)).astype(float)
    for b in range(n_blocks - 1):
        C[b * block, (b + 1) * block] += 17 + 9 * b
    return C + C.T


@pytest.mark.parametrize('case', ['simple', 'simple_lil', 'blocks'])
def test_bace_matches_jax(case):
    C = {'simple': SIMPLE, 'simple_lil': scipy.sparse.lil_matrix(SIMPLE),
         'blocks': _block_counts(1)}[case]
    copy = (lambda c: c.copy())
    bf, labels = bace.bace(copy(C), n_macrostates=2)
    bf_ref, labels_ref = jax_bace.bace(copy(C), n_macrostates=2)
    assert sorted(bf) == sorted(bf_ref) and sorted(labels) == sorted(
        labels_ref)
    for k in labels:
        assert np.array_equal(labels[k], labels_ref[k])
    np.testing.assert_allclose([bf[k] for k in sorted(bf)],
                               [bf_ref[k] for k in sorted(bf)], rtol=1e-12)


PRUNE_CASES = {
    'three': np.array([[100, 10, 1], [10, 100, 0], [1, 0, 5]]),
    'empty_row': np.array([[100, 10, 1, 0], [10, 100, 0, 0], [1, 0, 5, 0],
                           [0, 0, 0, 0]]),
    'four': np.array([[100, 10, 0, 1], [10, 100, 10, 0], [0, 10, 100, 0],
                      [1, 0, 0, 1]], dtype=float)}
TYPES = [np.array, scipy.sparse.csr_matrix, scipy.sparse.coo_matrix,
         scipy.sparse.lil_matrix, scipy.sparse.csc_matrix,
         scipy.sparse.dia_matrix]


def _dense(c):
    return np.asarray(c.todense()) if scipy.sparse.issparse(c) else c


@pytest.mark.parametrize('case', sorted(PRUNE_CASES))
def test_baysean_prune_and_absorb_match_jax(case):
    c0 = PRUNE_CASES[case]
    for array_type in TYPES:
        got = bace.baysean_prune(array_type(c0), n_procs=4)
        ref = jax_bace.baysean_prune(array_type(c0), n_procs=4)
        assert np.array_equal(_dense(got[0]), _dense(ref[0]))
        assert np.array_equal(got[1], ref[1]) and np.array_equal(got[2],
                                                                 ref[2])
    for factor in (1.3, np.log(3)):
        got = bace.baysean_prune(c0, factor=factor)
        ref = jax_bace.baysean_prune(c0, factor=factor)
        assert np.array_equal(got[0], ref[0]) and np.array_equal(got[1],
                                                                 ref[1])
    for array_type in (np.array, scipy.sparse.csr_matrix):
        got = bace.absorb(array_type(c0), [2])
        ref = jax_bace.absorb(array_type(c0), [2])
        assert np.array_equal(_dense(got[0]), _dense(ref[0]))
        assert np.array_equal(got[1], ref[1])
    island = np.array([[100, 10, 0], [10, 100, 0], [0, 0, 5]])
    with pytest.raises(DataInvalid):
        bace.absorb(island, [2])
    assert np.array_equal(bace.renumberMap(np.array([0, 3, 2, 5]), 2),
                          jax_bace.renumberMap(np.array([0, 3, 2, 5]), 2))
    rng = np.random.default_rng(6)
    c1, c2 = rng.integers(0, 5, 40), rng.integers(0, 5, size=(7, 40))
    c2[3] = 0
    np.testing.assert_allclose(
        bace._merge_bayes_factors(c1, c1.sum() + 1.0, c2, c2.sum(1) + 1.0),
        jax_bace._merge_bayes_factors(c1, c1.sum() + 1.0, c2,
                                      c2.sum(1) + 1.0), rtol=1e-12)
