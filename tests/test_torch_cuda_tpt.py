"""enspara_tpu_torch's analysis path on the card. Imports no jax: on the
card machine, run with
``python -m pytest --noconftest -m cuda tests/test_torch_cuda_tpt.py``.

The ``cuda`` tests skip without a card: committors and mean first
passage times through the device LU with fp64 refinement match the host
engines of the CPU to 1e-10; ``mle_device`` on the card matches the
same solve on the CPU (fp32, 1e-5) and the host ``mle`` (5e-4); the KMC
on the card holds its contract.
"""

import numpy as np
import pytest
import scipy.sparse
import torch

from enspara_tpu_torch import tpt
from enspara_tpu_torch.msm import builders, synthetic_data
from enspara_tpu_torch.tpt import core


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


def ring(n, seed):
    """The BASELINE config-4 MSM (benchmarks/reference_configs.py:226) at
    ``n`` states."""
    rng = np.random.RandomState(seed)
    rows = np.concatenate([np.arange(n)] * 3)
    cols = np.concatenate([(np.arange(n) + 1) % n, (np.arange(n) - 1) % n,
                           rng.randint(0, n, n)])
    vals = np.concatenate([np.full(n, 0.45), np.full(n, 0.45),
                           np.full(n, 0.10)])
    C = scipy.sparse.coo_matrix((vals, (rows, cols)), (n, n)).tocsr()
    C = C + scipy.sparse.eye(n) * 0.05
    return (scipy.sparse.diags(1.0 / np.asarray(C.sum(axis=1)).ravel())
            @ C).tocsr()


@pytest.mark.cuda
def test_cuda_committors_and_mfpts_take_the_device_lu(cuda, monkeypatch):
    T = ring(2000, seed=3)
    ref_q = tpt.committors(T, [0], [1000], device='cpu')
    ref_m = tpt.mfpts(T, sinks=[1000], device='cpu')
    host = []
    real = core._large_sparse_absorbing_solve
    monkeypatch.setattr(core, '_large_sparse_absorbing_solve',
                        lambda *a: host.append(1) or real(*a))
    q = tpt.committors(T, [0], [1000], device=cuda)
    m = tpt.mfpts(T, sinks=[1000], device=cuda)
    qd = tpt.committors(T.toarray(), [0], [1000], device=cuda)
    assert host == []
    for got, ref in ((q, ref_q), (qd, ref_q), (m, ref_m)):
        np.testing.assert_allclose(got, ref, rtol=1e-10,
                                   atol=1e-10 * np.abs(ref).max())
    monkeypatch.delenv('ENSPARA_TPU_PLATFORM')     # the card by default
    np.testing.assert_allclose(tpt.committors(T, [0], [1000]), q, rtol=0,
                               atol=0)


@pytest.mark.cuda
def test_cuda_mle_device(cuda):
    C = np.random.default_rng(3).integers(1, 50, size=(64, 64)).astype(float)
    _, T, pi = builders.mle_device(C, device=cuda)
    _, T_cpu, pi_cpu = builders.mle_device(C, device='cpu')
    _, T_host, pi_host = builders.mle(C)
    np.testing.assert_allclose(T, T_cpu, rtol=0, atol=1e-5)
    np.testing.assert_allclose(pi, pi_cpu, rtol=0, atol=1e-5)
    np.testing.assert_allclose(T, T_host, rtol=0, atol=5e-4)
    np.testing.assert_allclose(pi, pi_host, rtol=0, atol=5e-4)


@pytest.mark.cuda
def test_cuda_kmc(cuda):
    T = ring(50, seed=1).toarray()
    start = np.arange(2000) % 50
    gen = torch.Generator(device=cuda).manual_seed(3)
    chains = synthetic_data.synthetic_trajectory_device(T, start, 500,
                                                        generator=gen)
    again = synthetic_data.synthetic_trajectory_device(
        T, start, 500, generator=torch.Generator(device=cuda).manual_seed(3))
    assert chains.shape == (2000, 500) and chains.dtype == np.int32
    assert np.array_equal(chains, again)
    assert np.array_equal(chains[:, 0], start)
    src, dst = chains[:, :-1].ravel(), chains[:, 1:].ravel()
    assert (T[src, dst] > 0).all()
    freq = np.zeros_like(T)
    np.add.at(freq, (src, dst), 1)
    visits = freq.sum(axis=1)
    emp = freq / visits[:, None]
    sigma = np.sqrt(T * (1 - T) / visits[:, None])
    assert (np.abs(emp - T) <= 5 * sigma + 1e-12).all()
