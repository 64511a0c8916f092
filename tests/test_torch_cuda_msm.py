"""enspara_tpu_torch's large-MSM slice on the card, and where host input
runs. Imports no jax: on the card machine, run with
``python -m pytest --noconftest -m cuda tests/test_torch_cuda_msm.py``.

The ``cuda`` tests skip without a card: kernel 6 (``csrc/ell_spmm.cu``)
equals its plain version bit for bit, and the filtered solve on the card
matches the same solve on the CPU to 1e-10.
"""

import numpy as np
import pytest
import scipy.sparse
import torch

from enspara_tpu_torch.cluster import engine
from enspara_tpu_torch.msm import builders, eigenspectrum_reversible
from enspara_tpu_torch.msm.eigen_device import bucketed_ell
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


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (torch.cuda.is_available() is '
                    'False)')
    return torch.device('cuda')


def _metastable(n, seed):
    C = sparse_metastable_counts(n, n_blocks=25, seed=seed)
    _, T, pi = builders.transpose(C)
    return scipy.sparse.csr_matrix(T), np.asarray(pi)


def test_host_input_goes_to_the_card(monkeypatch):
    """With no device named and no ``$ENSPARA_TPU_PLATFORM``, numpy input
    goes to the card: without one it raises the ``require_cuda`` error
    instead of running on the CPU."""
    monkeypatch.delenv('ENSPARA_TPU_PLATFORM')
    X = np.random.default_rng(0).normal(size=(300, 8, 3)).astype(np.float32)
    T, pi = _metastable(5000, seed=5)
    if not torch.cuda.is_available():
        for call in (lambda: engine.prepare_rmsd_frames(X),
                     lambda: eigenspectrum_reversible(T, pi=pi, n_eigs=6),
                     lambda: eigenspectrum_reversible(T, pi=pi, n_eigs=6,
                                                      method='arpack')):
            with pytest.raises(RuntimeError, match='CUDA device is required'):
                call()
        return
    assert engine.prepare_rmsd_frames(X).frames_r.is_cuda
    before = ell_mod.ell_spmm_kernel.n_launches
    info = eigenspectrum_reversible(T, pi=pi, n_eigs=6,
                                    return_info=True)[2]
    assert info['method'] == 'filtered'
    assert ell_mod.ell_spmm_kernel.n_launches > before


@pytest.mark.cuda
@pytest.mark.parametrize('shape', ['scale_point_like', 'odd', 'wide'])
def test_cuda_ell_spmm_equals_plain(cuda, shape):
    """Kernel 6 against its plain version on the card, bit for bit, with
    and without a shift, and with padded rows exactly zero."""
    rng = np.random.default_rng(1)
    if shape == 'scale_point_like':
        T, pi = _metastable(5000, seed=5)
        sq = np.sqrt(pi)
        S = scipy.sparse.diags(sq) @ T @ scipy.sparse.diags(1.0 / sq)
        cols, vals = bucketed_ell(((S + S.T) * 0.5).tocsr())
        k = 64
    elif shape == 'odd':
        n, w, k = 1000, 5, 21
        cols = rng.integers(0, n, (n, w)).astype(np.int32)
        vals = rng.normal(size=(n, w)).astype(np.float32)
    else:
        n, w, k = 777, 45, 512
        cols = rng.integers(0, n, (n, w)).astype(np.int32)
        vals = rng.normal(size=(n, w)).astype(np.float32)
    cols = torch.from_numpy(cols).to(cuda)
    vals = torch.from_numpy(vals).to(cuda)
    X = torch.from_numpy(rng.normal(size=(cols.shape[0], k))
                         .astype(np.float32)).to(cuda)
    if shape == 'scale_point_like':
        X[5000:] = 0.0                        # the solver's padded rows
    for shift in (0.0, -0.375):
        before = ell_mod.ell_spmm_kernel.n_launches
        Y = ell_mod.ell_spmm_kernel(cols, vals, X, shift)
        torch.cuda.synchronize()
        assert ell_mod.ell_spmm_kernel.n_launches == before + 1
        assert torch.equal(Y, ell_mod.ell_spmm_plain(cols, vals, X, shift))
        if shape == 'scale_point_like':
            assert torch.equal(Y[5000:], torch.zeros_like(Y[5000:]))


@pytest.mark.cuda
def test_cuda_filtered_solve_matches_cpu(cuda):
    """The filtered solve with its products on kernel 6 matches the same
    solve on the CPU (plain products) to 1e-10, both certified."""
    T, pi = _metastable(10_000, seed=11)
    out = {}
    for dev in ('cpu', cuda):
        before = ell_mod.ell_spmm_kernel.n_launches
        out[str(dev)] = eigenspectrum_reversible(
            T, pi=pi, n_eigs=21, method='filtered', return_info=True,
            device=dev) + (ell_mod.ell_spmm_kernel.n_launches - before,)
    (vc, uc, ic, lc), (vg, ug, ig, lg) = out.values()
    assert lc == 0 and lg > 0
    assert not ic['fallback'] and not ig['fallback']
    assert max(ic['residuals'].max(), ig['residuals'].max()) < 1e-9
    np.testing.assert_allclose(vg, vc, atol=1e-10)
    np.testing.assert_allclose(ug[:, 0], uc[:, 0], atol=1e-9)
