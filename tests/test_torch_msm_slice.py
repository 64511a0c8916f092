"""The port's large-MSM slice end to end against the JAX package:
``implied_timescales_device`` on the same assignments, with the ``mle``
and ``transpose`` builders and with the non-reversible ``normalize``
fallback (tests/test_eigen_device.py:221, :391), and on KMC assignments
over 4,500 states where every lag goes through the filtered solver
(whose sparse products take the plain ELL SpMM here). Bar: rtol 1e-4
on the timescales."""

import numpy as np
import pytest
import scipy.sparse
import torch

from enspara_tpu.msm import builders as jax_builders
from enspara_tpu.msm.eigen_device import \
    implied_timescales_device as jax_implied_timescales_device

from enspara_tpu_torch.msm import builders, eigen_device
from enspara_tpu_torch.msm import implied_timescales_device
from enspara_tpu_torch.msm.synthetic_data import sparse_metastable_counts


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


@pytest.mark.parametrize('builder', ['mle', 'transpose'])
def test_implied_timescales_match_jax(builder):
    assigns = np.random.default_rng(1).integers(0, 5, size=(3, 400))
    got = implied_timescales_device(assigns, [1, 2, 4],
                                    getattr(builders, builder), n_times=2)
    ref = jax_implied_timescales_device(assigns, [1, 2, 4],
                                        getattr(jax_builders, builder),
                                        n_times=2)
    assert got.shape == (3, 2) and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=1e-4)


def test_nonreversible_builder_takes_the_host_solver():
    """builders.normalize gives a non-reversible T: the general host
    eigensolver answers, and negative eigenvalues give NaN, as in the
    JAX package."""
    rng = np.random.default_rng(2)
    a = np.zeros(600, dtype=int)
    state = 0
    for i in range(600):
        a[i] = state
        state = (state + 1) % 4 if rng.random() < 0.9 else rng.integers(4)
    got = implied_timescales_device(a[None], [1, 2], builders.normalize,
                                    n_times=2)
    ref = jax_implied_timescales_device(a[None], [1, 2],
                                        jax_builders.normalize, n_times=2)
    np.testing.assert_allclose(got, ref, rtol=1e-4, equal_nan=True)
    assert np.isnan(got).any()


def _kmc(T, n_chains, n_steps, n_wells, rng):
    """Vectorised kinetic Monte Carlo over sparse row-stochastic T, an
    equal share of the chains started in each well."""
    T = T.tocsr()
    cum = np.cumsum(T.data)
    before = np.concatenate([[0.0], cum])[T.indptr[:-1]]
    total = cum[T.indptr[1:] - 1] - before
    per_well = T.shape[0] // n_wells
    s = (np.arange(n_chains) % n_wells) * per_well \
        + rng.integers(0, per_well, n_chains)
    out = np.empty((n_chains, n_steps), np.int64)
    out[:, 0] = s
    for t in range(1, n_steps):
        idx = np.searchsorted(cum, before[s] + rng.random(n_chains)
                              * total[s], side='right')
        s = T.indices[np.minimum(idx, T.indptr[s + 1] - 1)]
        out[:, t] = s
    return out


def test_every_lag_through_the_filtered_solver(monkeypatch):
    """4,500 states in 3 wells, coupled strongly enough that the chains
    cross: the port's lags go through the filtered solver (which
    'auto' picks on the card; forced here on the CPU) and match the
    JAX package's host ARPACK at every lag."""
    n, wells = 4500, 3
    C = sparse_metastable_counts(n, n_blocks=wells, seed=7).tolil()
    rng = np.random.default_rng(7)
    for b in range(wells - 1):            # 40 extra links between wells
        s = b * 1500 + rng.integers(0, 1500, 40)
        d = (b + 1) * 1500 + rng.integers(0, 1500, 40)
        C[s, d] = 2.0
        C[d, s] = 2.0
    _, T, _ = builders.transpose(C.tocsr())
    assigns = _kmc(scipy.sparse.csr_matrix(T), 60, 4000, wells, rng)
    assert np.unique(assigns).size == n

    infos = []
    real = eigen_device.eigenspectrum_reversible

    def filtered(T, pi=None, n_eigs=None, method='auto', **kw):
        vals, vecs, info = real(T, pi=pi, n_eigs=n_eigs, method='filtered',
                                return_info=True, **kw)
        infos.append(info)
        return vals, vecs
    monkeypatch.setattr(eigen_device, 'eigenspectrum_reversible', filtered)
    got = implied_timescales_device(assigns, [1, 3], builders.transpose,
                                    n_times=5)
    ref = jax_implied_timescales_device(assigns, [1, 3],
                                        jax_builders.transpose, n_times=5)
    assert [i['method'] for i in infos] == ['filtered', 'filtered']
    assert not any(i['fallback'] for i in infos)
    assert np.isfinite(got).all() and (got > 0).all()
    np.testing.assert_allclose(got, ref, rtol=1e-4)
