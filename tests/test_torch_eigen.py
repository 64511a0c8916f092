"""The port's ``eigenspectrum_reversible`` on the CPU (``device='cpu'``:
the filtered solver's sparse products take the plain ELL SpMM) held
against the JAX package's on the same (T, pi) and against a host ARPACK
oracle, in all four methods.

Bars, those of ``tests/test_eigen_device.py``: the filtered solver's
eigenvalues within 1e-10 of JAX's and of ARPACK, ``vecs[:, 0]`` within
1e-9 of pi, residual certificates below 1e-9; 'eigh' (fp32 on the
device) within 1e-4 of JAX's; 'arpack' equal to JAX's.
"""

import numpy as np
import pytest
import scipy.linalg
import scipy.sparse
import scipy.sparse.linalg
import torch

from enspara_tpu.msm import builders as jax_builders
from enspara_tpu.msm.eigen_device import \
    eigenspectrum_reversible as jax_eigenspectrum_reversible
from enspara_tpu.msm.synthetic_data import \
    sparse_metastable_counts as jax_counts

from enspara_tpu_torch.msm import builders, eigen_device
from enspara_tpu_torch.msm import eigenspectrum_reversible
from enspara_tpu_torch.msm.synthetic_data import sparse_metastable_counts
from enspara_tpu_torch.ops import ell_spmm as ell_mod


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


def _metastable(n, seed, n_blocks=25):
    """(T, pi) of the port's sparse_metastable_counts (which equals the
    JAX package's) through the port's transpose builder."""
    C = sparse_metastable_counts(n, n_blocks=n_blocks, seed=seed)
    assert (C != jax_counts(n, n_blocks=n_blocks, seed=seed)).nnz == 0
    _, T, pi = builders.transpose(C)
    return scipy.sparse.csr_matrix(T), np.asarray(pi)


def _gapless(n, seed, extra_per_state=6):
    """A connected sparse reversible MSM whose top spectrum is gapless
    (tests/test_eigen_device.py :: _sparse_gapless_msm)."""
    rng = np.random.default_rng(seed)
    ij = [np.stack([np.arange(n - 1), np.arange(1, n)])]
    vals = [rng.integers(1, 20, n - 1).astype(float)]
    m = extra_per_state * n
    ij.append(np.stack([rng.integers(0, n, m), rng.integers(0, n, m)]))
    vals.append(rng.integers(1, 5, m).astype(float))
    ij = np.concatenate(ij, axis=1)
    C = scipy.sparse.coo_matrix((np.concatenate(vals), (ij[0], ij[1])),
                                shape=(n, n))
    _, T, pi = builders.transpose((C + C.T).tocsr())
    return scipy.sparse.csr_matrix(T), np.asarray(pi)


def _arpack_oracle(T, pi, k):
    sq = np.sqrt(pi)
    S = scipy.sparse.diags(sq) @ T @ scipy.sparse.diags(1.0 / sq)
    S = ((S + S.T) * 0.5).tocsc().astype(np.float64)
    w = scipy.sparse.linalg.eigsh(S, k=k, which='LA',
                                  return_eigenvectors=False)
    return np.sort(w)[::-1]


def _solve(T, pi, k, **kw):
    kw.setdefault('device', 'cpu')
    return eigenspectrum_reversible(T, pi=pi, n_eigs=k, return_info=True,
                                    **kw)


@pytest.mark.parametrize('n,seed', [(5000, 5), (10_000, 11)])
def test_filtered_matches_jax_and_arpack(n, seed):
    T, pi = _metastable(n, seed)
    k = 21
    before = ell_mod.ell_spmm_kernel.n_launches
    vals, vecs, info = _solve(T, pi, k, method='filtered')
    assert ell_mod.ell_spmm_kernel.n_launches == before   # plain on the CPU
    assert info['method'] == 'filtered' and not info['fallback'], info
    assert info['residuals'].shape == (k,)
    assert info['residuals'].max() < 1e-9, info['residuals']
    assert info['stage1_sweeps'] > 0 and info['stage1_w_padded'] % 8 == 0
    jvals, jvecs, jinfo = jax_eigenspectrum_reversible(
        T, pi=pi, n_eigs=k, method='filtered', return_info=True)
    assert not jinfo['fallback']
    np.testing.assert_allclose(vals, jvals, atol=1e-10)
    np.testing.assert_allclose(vals, _arpack_oracle(T, pi, k), atol=1e-10)
    np.testing.assert_allclose(vecs[:, 0], pi, atol=1e-9)
    np.testing.assert_allclose(vecs[:, 0], jvecs[:, 0], atol=1e-9)


def test_filtered_grows_block_on_gapless_spectrum():
    """A gapless spectrum stalls a fixed block: the solver grows it and
    converges with certificates, as the JAX package does."""
    T, pi = _gapless(5000, seed=5)
    vals, _, info = _solve(T, pi, 6, method='filtered')
    jvals, _, jinfo = jax_eigenspectrum_reversible(
        T, pi=pi, n_eigs=6, method='filtered', return_info=True)
    assert not info['fallback'] and not jinfo['fallback']
    assert info['residuals'].max() < 1e-9
    assert info['stage1_grown'] == jinfo['stage1_grown']
    np.testing.assert_allclose(vals, jvals, atol=1e-10)
    np.testing.assert_allclose(vals, _arpack_oracle(T, pi, 6), atol=1e-10)


@pytest.mark.parametrize('cause', ['budget', 'singular_gram',
                                   'non_finite_block'])
def test_numerical_fallbacks_hand_over_to_arpack(cause, monkeypatch):
    """An exhausted refinement budget, a singular Gram matrix in the
    stage-2 Rayleigh-Ritz, and a non-finite stage-1 block each hand the
    problem to host ARPACK and report ``fallback``, as in the JAX
    package."""
    T, pi = _metastable(5000, seed=5)
    kw = {'method': 'filtered'}
    if cause == 'budget':
        kw.update(tol=1e-14, max_refine=0)
        jinfo = jax_eigenspectrum_reversible(
            T, pi=pi, n_eigs=6, return_info=True, **kw)[2]
        assert jinfo['fallback']
    elif cause == 'singular_gram':
        real_eigh = scipy.linalg.eigh

        def breaking_eigh(a, b=None, **k):
            if b is not None:
                raise np.linalg.LinAlgError('not positive definite '
                                            '(simulated)')
            return real_eigh(a, **k)
        monkeypatch.setattr(scipy.linalg, 'eigh', breaking_eigh)
    else:
        real_sweep = eigen_device._filter_sweep

        def poisoned(spmm, V, b, degree, use_qr):
            Vr, w_r, res = real_sweep(spmm, V, b, degree, use_qr)
            return Vr * float('nan'), w_r * float('nan'), res
        monkeypatch.setattr(eigen_device, '_filter_sweep', poisoned)
    vals, _, info = _solve(T, pi, 6, **kw)
    assert info['fallback'] and info['method'] == 'filtered'
    np.testing.assert_allclose(vals, _arpack_oracle(T, pi, 6), atol=1e-10)


def test_stage1_exception_propagates(monkeypatch):
    """Unlike the JAX package (tests/test_eigen_device.py ::
    test_stage1_exception_falls_back_to_arpack), a failure of the
    device stage raises: a kernel that does not build or launch must not
    quietly become host ARPACK."""
    T, pi = _metastable(3000, seed=5)

    def boom(cols, vals, X, shift=0.0):
        raise RuntimeError('synthetic kernel failure')
    monkeypatch.setattr(eigen_device, 'ell_spmm', boom)
    with pytest.raises(RuntimeError, match='synthetic kernel failure'):
        _solve(T, pi, 5, method='filtered')


def test_orth_qr_knob_and_csr_branch(monkeypatch):
    """``ENSPARA_TPU_EIG_ORTH=qr`` (Householder QR in stage 1) and a
    hub-dominated graph (the torch.sparse CSR product instead of ELL)
    both converge to ARPACK's eigenvalues with certificates."""
    T, pi = _metastable(5000, seed=5)
    monkeypatch.setenv('ENSPARA_TPU_EIG_ORTH', 'qr')
    vals, _, info = _solve(T, pi, 6, method='filtered')
    assert not info['fallback'] and info['residuals'].max() < 1e-9
    np.testing.assert_allclose(vals, _arpack_oracle(T, pi, 6), atol=1e-10)
    monkeypatch.delenv('ENSPARA_TPU_EIG_ORTH')

    C = sparse_metastable_counts(5000, n_blocks=25, seed=5).tolil()
    hubs = np.random.default_rng(0).choice(5000, 1500, replace=False)
    C[0, hubs] = 1e-3                 # one state touches 30% of the rest
    C[hubs, 0] = 1e-3
    _, T, pi = builders.transpose(C.tocsr())
    T, pi = scipy.sparse.csr_matrix(T), np.asarray(pi)
    before = ell_mod.ell_spmm_kernel.n_launches
    vals, _, info = _solve(T, pi, 6, method='filtered')
    assert info['stage1_w_padded'] == 0          # no ELL form
    assert ell_mod.ell_spmm_kernel.n_launches == before
    assert not info['fallback'] and info['residuals'].max() < 1e-9
    np.testing.assert_allclose(vals, _arpack_oracle(T, pi, 6), atol=1e-10)


def test_eigh_matches_jax():
    """'eigh' in fp32 on the device, from dense and from sparse T."""
    rng = np.random.default_rng(0)
    C = rng.integers(1, 50, size=(60, 60)).astype(float)
    _, T, pi = builders.mle(C)
    _, jT, jpi = jax_builders.mle(C)
    np.testing.assert_allclose(T, jT, atol=1e-12)
    for arg in (T, scipy.sparse.csr_matrix(T)):
        vals, vecs, info = _solve(arg, pi, 6, method='eigh')
        jvals, jvecs = jax_eigenspectrum_reversible(arg, pi=pi, n_eigs=6,
                                                    method='eigh')
        assert info['method'] == 'eigh'
        np.testing.assert_allclose(vals, jvals, atol=1e-4)
        np.testing.assert_allclose(vecs[:, 0], jvecs[:, 0], atol=1e-5)
        for i in range(1, 6):
            a, b = vecs[:, i], jvecs[:, i]
            np.testing.assert_allclose(np.sign(a @ b) * a, b, atol=1e-3)


def test_arpack_equals_jax_and_auto_picks_what_jax_picks_on_the_cpu():
    T, pi = _metastable(10_000, seed=3)
    vals, vecs, info = _solve(T, pi, 21, method='arpack')
    jvals, jvecs, jinfo = jax_eigenspectrum_reversible(
        T, pi=pi, n_eigs=21, method='arpack', return_info=True)
    # the same host ARPACK call on the same S: equal but for ARPACK's
    # random start vector
    np.testing.assert_allclose(vals, jvals, atol=1e-12)
    np.testing.assert_allclose(vecs[:, 0], jvecs[:, 0], atol=1e-9)
    assert info['method'] == jinfo['method'] == 'arpack'
    assert max(info['residuals'].max(), jinfo['residuals'].max()) < 1e-9

    small, small_pi = _metastable(1024, seed=3, n_blocks=8)
    for args, k in (((T, pi), 21), ((small, small_pi), 5),
                    ((small.toarray(), small_pi), 5)):
        method = _solve(*args, k, method='auto')[2]['method']
        jmethod = jax_eigenspectrum_reversible(
            *args, n_eigs=k, method='auto', return_info=True)[2]['method']
        assert method == jmethod
    assert _solve(T, pi, 21, method='auto')[2]['method'] == 'arpack'


def test_without_pi_the_host_solver_answers():
    T, pi = _metastable(500, seed=2, n_blocks=5)
    for p in (None, np.where(np.arange(500) == 7, 0.0, pi)):
        vals, _, info = _solve(T, p, 4, method='filtered')
        jvals = jax_eigenspectrum_reversible(T, pi=p, n_eigs=4)[0]
        assert info['method'] == 'host'
        np.testing.assert_allclose(vals, jvals, atol=1e-12)


@pytest.mark.parametrize('caller', ['eigen', 'qcp', 'distances'])
def test_tf32_setting_is_restored(caller, monkeypatch):
    """The filtered solver's, the QCP contractions' and the Gram
    distances' products run in full fp32 whatever the caller set
    (``util.device.full_fp32_matmul``), and the caller's setting comes
    back afterwards."""
    from enspara_tpu_torch.ops import distances, qcp

    seen = []

    def spy(fn):
        def wrapped(*args, **kwargs):
            seen.append(torch.backends.cuda.matmul.allow_tf32)
            return fn(*args, **kwargs)
        return wrapped
    saved = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        rng = np.random.default_rng(0)
        if caller == 'eigen':
            T, pi = _metastable(5000, seed=5)
            monkeypatch.setattr(eigen_device, '_orth',
                                spy(eigen_device._orth))
            _solve(T, pi, 6, method='filtered')
        elif caller == 'qcp':
            monkeypatch.setattr(torch, 'einsum', spy(torch.einsum))
            X = rng.normal(size=(20, 5, 3)).astype(np.float32)
            X -= X.mean(axis=1, keepdims=True)
            g = (X * X).sum((1, 2))
            qcp.qcp_rmsd_matrix(X, X[:3], g, g[:3])
        else:
            monkeypatch.setattr(torch, 'addmm', spy(torch.addmm))
            X = rng.normal(size=(20, 4)).astype(np.float32)
            distances.pairwise_euclidean(X, X[:3])
        assert seen and not any(seen)
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
