"""The port's sparse operands (``enspara_tpu_torch.ops.sparse`` and the
ELL SpMM of ``ops.ell_spmm``) held against the JAX package on the same
numpy inputs: ``ell_spmm`` against JAX's XLA ``ell_spmm`` and against the
Pallas ``ell_spmm_pallas`` in interpret mode, elementwise within
``2 w eps32 (|A| @ |X|)`` (two float32 sums of w products in other
orders); ``ell_from_sparse``, ``bucketed_ell_shape`` and
``dense_on_device`` exactly equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse
import torch

from enspara_tpu.msm.eigen_device import \
    bucketed_ell_shape as jax_bucketed_ell_shape
from enspara_tpu.ops.sparse import dense_on_device as jax_dense_on_device
from enspara_tpu.ops.sparse import ell_from_sparse as jax_ell_from_sparse
from enspara_tpu.ops.sparse import ell_spmm as jax_ell_spmm
from enspara_tpu.ops.spmm_pallas import ell_spmm_pallas

from enspara_tpu_torch.msm.eigen_device import bucketed_ell, bucketed_ell_shape
from enspara_tpu_torch.ops import ell_spmm as ell_mod
from enspara_tpu_torch.ops.sparse import (dense_on_device, ell_from_sparse,
                                          ell_spmm)


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


def _matrix(n, density, seed):
    """The sparse matrices of tests/test_spmm_pallas.py: random, plus
    0.5 on the diagonal so that no row is empty."""
    A = scipy.sparse.random(n, n, density=density, random_state=seed,
                            format='csr')
    return (A + scipy.sparse.eye(n) * 0.5).tocsr()


def _assert_within_sum_bar(Y, Y_ref, A, X, w):
    bar = 2 * w * np.finfo(np.float32).eps * (
        abs(A).astype(np.float64) @ np.abs(X.astype(np.float64)))
    err = np.abs(np.asarray(Y, np.float64) - np.asarray(Y_ref, np.float64))
    assert (err <= bar).all(), 'max excess %g' % (err - bar).max()


@pytest.mark.parametrize('n,k,density,seed', [(257, 21, 0.01, 0),
                                              (512, 64, 0.005, 1),
                                              (100, 130, 0.03, 2)])
def test_ell_spmm_matches_jax(n, k, density, seed):
    A = _matrix(n, density, seed)
    cols, vals = ell_from_sparse(A)
    jcols, jvals = jax_ell_from_sparse(A)
    np.testing.assert_array_equal(cols, jcols)
    np.testing.assert_array_equal(vals, jvals)
    X = np.random.default_rng(seed).normal(size=(n, k)).astype(np.float32)
    w = cols.shape[1]

    got = ell_spmm(torch.from_numpy(cols), torch.from_numpy(vals),
                   torch.from_numpy(X))
    assert got.dtype == torch.float32 and tuple(got.shape) == (n, k)
    got = got.numpy()
    xla = np.asarray(jax_ell_spmm(jnp.asarray(cols), jnp.asarray(vals),
                                  jnp.asarray(X)))
    pallas = np.asarray(ell_spmm_pallas(jnp.asarray(cols), jnp.asarray(vals),
                                        jnp.asarray(X)))
    for ref in (xla, pallas):
        _assert_within_sum_bar(got, ref, A, X, w)


def test_ell_spmm_shift_and_fp64_inputs():
    """``shift`` adds ``shift * X`` as JAX's ``ell_spmm`` does, and
    float64 operands are cast to the kernel's float32 as
    ``ell_spmm_pallas`` casts them."""
    A = _matrix(300, 0.02, 3)
    cols, vals = ell_from_sparse(A)
    X = np.random.default_rng(3).normal(size=(300, 17))
    w = cols.shape[1]
    got = ell_spmm(torch.from_numpy(cols), torch.from_numpy(vals),
                   torch.from_numpy(X), shift=-0.75)
    ref = np.asarray(jax_ell_spmm(jnp.asarray(cols), jnp.asarray(vals),
                                  jnp.asarray(X, jnp.float32), shift=-0.75))
    shifted = (A - 0.75 * scipy.sparse.eye(300)).tocsr()
    _assert_within_sum_bar(got.numpy(), ref, shifted, X, w + 1)

    got64 = ell_spmm(torch.from_numpy(cols), torch.from_numpy(
        vals.astype(np.float64)), torch.from_numpy(X))
    pallas = np.asarray(ell_spmm_pallas(jnp.asarray(cols),
                                        np.asarray(vals, np.float64),
                                        np.asarray(X)))
    assert got64.dtype == torch.float32
    _assert_within_sum_bar(got64.numpy(), pallas, A, X, w)


def test_bucketed_ell_equals_jax_padding():
    """The bucketed shapes equal JAX's, and the padded ELL arrays are
    the JAX solver's: padded rows index themselves with zero values."""
    for n, w in ((100_000, 33), (101_000, 38), (5000, 17), (1, 1), (257, 9)):
        assert bucketed_ell_shape(n, w) == jax_bucketed_ell_shape(n, w)
    A = _matrix(1000, 0.004, 4)
    cols, vals = bucketed_ell(A)
    assert cols.shape == jax_bucketed_ell_shape(*jax_ell_from_sparse(A)[0]
                                                .shape)
    jcols, jvals = jax_ell_from_sparse(A)
    np.testing.assert_array_equal(cols[:1000, :jcols.shape[1]], jcols)
    np.testing.assert_array_equal(vals[:1000, :jvals.shape[1]], jvals)
    np.testing.assert_array_equal(vals[1000:], 0)
    np.testing.assert_array_equal(
        cols[1000:], np.arange(1000, cols.shape[0])[:, None]
        .repeat(cols.shape[1], 1))


def test_dense_on_device_matches_jax():
    A = _matrix(80, 0.1, 5)
    A = scipy.sparse.coo_matrix((np.r_[A.tocoo().data, 1.5],
                                 (np.r_[A.tocoo().row, 3],
                                  np.r_[A.tocoo().col, 3])), shape=A.shape)
    rng = np.random.default_rng(5)
    r, c = rng.random(80) + 0.5, rng.random(80) + 0.5
    for kw in ({}, {'scale_rows': r, 'scale_cols': c}):
        got = dense_on_device(A, **kw)
        assert got.device.type == 'cpu' and got.dtype == torch.float32
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jax_dense_on_device(A, **kw)))


@pytest.mark.parametrize('bad', ['int64_cols', 'strided_x', 'rows',
                                 'meta'])
def test_ell_spmm_rejects_what_the_kernel_does_not_take(bad):
    cols, vals = ell_from_sparse(_matrix(64, 0.05, 6))
    cols, vals = torch.from_numpy(cols), torch.from_numpy(vals)
    X = torch.ones((64, 8))
    fn = ell_mod.ell_spmm_plain
    if bad == 'int64_cols':
        cols = cols.long()
    elif bad == 'strided_x':
        X = torch.ones((64, 16))[:, ::2]
    elif bad == 'rows':
        X = X[:63]
    else:
        # neither CPU nor CUDA: refused, not run some other way
        cols, vals, X = cols.to('meta'), vals.to('meta'), X.to('meta')
        fn = ell_spmm
    with pytest.raises(ValueError):
        fn(cols, vals, X)
    with pytest.raises(ValueError):
        ell_mod.ell_spmm_kernel(cols, vals, X)


def test_cpu_path_launches_no_kernel():
    cols, vals = ell_from_sparse(_matrix(64, 0.05, 7))
    before = ell_mod.ell_spmm_kernel.n_launches
    Y = ell_spmm(torch.from_numpy(cols), torch.from_numpy(vals),
                 torch.ones((64, 4)))
    assert torch.isfinite(Y).all()
    assert ell_mod.ell_spmm_kernel.n_launches == before
