"""The port's host MSM code held against the JAX package on the same
assignments: transition counting (exactly equal counts), ergodic
trimming, the ``transpose``, ``normalize`` and ``mle`` builders and the
equilibrium probabilities (1e-12), the synthetic counts generator and
the host KMC chain (exactly equal), and the native Prinz kernel the
port builds itself."""

import io

import numpy as np
import pytest
import scipy.sparse
import torch

from enspara_tpu.msm import builders as jax_builders
from enspara_tpu.msm import synthetic_data as jax_synthetic
from enspara_tpu.msm import transition_matrices as jax_tm
from enspara_tpu.ra import RaggedArray as JaxRaggedArray

from enspara_tpu_torch.exception import DataInvalid
from enspara_tpu_torch.msm import builders, synthetic_data
from enspara_tpu_torch.msm import transition_matrices as tm
from enspara_tpu_torch.msm.libmsm import _mle_prinz_dense_py
from enspara_tpu_torch.ra import RaggedArray


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


def _assigns(seed, n_states=9, gaps=False):
    rng = np.random.default_rng(seed)
    rows = [rng.integers(0, n_states, size=n) for n in (300, 211, 97)]
    if gaps:
        for r in rows:
            r[rng.random(r.size) < 0.1] = -1
    return rows


@pytest.mark.parametrize('case', ['ragged', 'gaps', 'strided', 'array',
                                  'max_n_states'])
def test_assigns_to_counts_matches_jax(case):
    rows = _assigns(0, gaps=case == 'gaps')
    lag, kw = 3, {}
    if case == 'strided':
        kw['sliding_window'] = False
    if case == 'max_n_states':
        kw['max_n_states'] = 12
    if case == 'array':
        port_in = jax_in = np.stack([r[:97] for r in rows])
    else:
        port_in, jax_in = RaggedArray(rows), JaxRaggedArray(rows)
    got = tm.assigns_to_counts(port_in, lag, **kw)
    ref = jax_tm.assigns_to_counts(jax_in, lag, **kw)
    assert scipy.sparse.issparse(got) and got.shape == ref.shape
    np.testing.assert_array_equal(got.toarray(), ref.toarray())
    assert got.sum() > 0


def test_assigns_to_counts_rejects_what_jax_rejects():
    for bad in ({'assigns': np.zeros(5, int), 'lag_time': 1},
                {'assigns': np.zeros((2, 5), int), 'lag_time': 0},
                {'assigns': np.zeros((2, 5), int), 'lag_time': 1.5}):
        with pytest.raises(DataInvalid):
            tm.assigns_to_counts(**bad)


def test_trim_disconnected_matches_jax():
    rng = np.random.default_rng(1)
    C = rng.integers(0, 4, size=(12, 12))
    C[:, 9:] = 0                      # states 9-11 cannot be reached
    C[9:, :] = rng.integers(0, 4, size=(3, 12))
    for kw in ({}, {'renumber_states': False}, {'threshold': 2}):
        m, trimmed = tm.trim_disconnected(scipy.sparse.coo_matrix(C), **kw)
        jm, jtrimmed = jax_tm.trim_disconnected(scipy.sparse.coo_matrix(C),
                                                **kw)
        assert m.to_original == jm.to_original
        np.testing.assert_array_equal(trimmed.toarray(), jtrimmed.toarray())
    buf = io.StringIO()
    m.write(buf)
    buf.seek(0)
    assert tm.TrimMapping.read(buf) == m


@pytest.mark.parametrize('builder', ['transpose', 'normalize', 'mle'])
def test_builders_match_jax(builder):
    rows = _assigns(2, n_states=7)
    C = tm.assigns_to_counts(RaggedArray(rows), 2)
    for prior in (None, 0.5):
        counts, T, pi = getattr(builders, builder)(C, prior_counts=prior)
        jcounts, jT, jpi = getattr(jax_builders, builder)(
            jax_tm.assigns_to_counts(JaxRaggedArray(rows), 2),
            prior_counts=prior)
        assert type(T) is type(jT)
        dense = (lambda M: M.toarray() if scipy.sparse.issparse(M)
                 else np.asarray(M))
        np.testing.assert_allclose(dense(counts), dense(jcounts), atol=1e-12)
        np.testing.assert_allclose(dense(T), dense(jT), atol=1e-12)
        np.testing.assert_allclose(pi, jpi, atol=1e-12)
        np.testing.assert_allclose(tm.eq_probs(T), jax_tm.eq_probs(jT),
                                   atol=1e-12)
        if builder == 'mle':
            # the port's native kernel against the Python mirror
            T_py, pi_py = _mle_prinz_dense_py(dense(C) + (prior or 0))
            np.testing.assert_allclose(dense(T), T_py, atol=1e-9)
            np.testing.assert_allclose(pi, pi_py, atol=1e-9)


def test_synthetic_data_matches_jax():
    C = synthetic_data.sparse_metastable_counts(2000, n_blocks=8, seed=4)
    jC = jax_synthetic.sparse_metastable_counts(2000, n_blocks=8, seed=4)
    assert (C != jC).nnz == 0 and C.shape == (2000, 2000)
    _, T, _ = builders.transpose(C[:200, :200])
    np.testing.assert_array_equal(
        synthetic_data.synthetic_trajectory(T, 3, 500, random_state=2),
        jax_synthetic.synthetic_trajectory(T, 3, 500, random_state=2))
