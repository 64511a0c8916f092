"""The port's transition path theory held against the JAX package on the
same seeded MSMs at 1e-10: ``committors``, ``mfpts`` (all-to-all and to
sinks, dense and sparse), ``reactive_fluxes``, ``net_fluxes``,
``reactive_populations``, ``top_path`` and ``paths``.

On the CPU both packages take the host engines. The device branch (the
fp32 LU with fp64 refinement) is reached here by asking for it:
``_refined_solve(device='cpu')`` against the JAX ``_refined_solve`` (run
in a subprocess: the JAX LU must not run in a test worker after
``tests/test_io.py``'s process pool, ROADMAP queue 3) and
``np.linalg.solve``; a stalled refinement returns None and the host path
takes over; a failure of the device raises."""

import os
import subprocess
import sys

import numpy as np
import pytest
import scipy.sparse
import scipy.sparse.linalg
import torch

from enspara_tpu import tpt as jax_tpt
from enspara_tpu.msm import builders as jax_builders
from enspara_tpu.msm.synthetic_data import sparse_metastable_counts

from enspara_tpu_torch import tpt
from enspara_tpu_torch.tpt import core

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def _close(a, b, tol=1e-10):
    a = a.toarray() if scipy.sparse.issparse(a) else np.asarray(a)
    b = b.toarray() if scipy.sparse.issparse(b) else np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=tol, atol=tol * np.abs(b).max())


def ring(n, seed, shortcut=0.10):
    """The BASELINE config-4 MSM (benchmarks/reference_configs.py:226)
    at ``n`` states: a ring with random directed shortcuts, row-normalized
    (not reversible)."""
    rng = np.random.RandomState(seed)
    rows = np.concatenate([np.arange(n)] * 3)
    cols = np.concatenate([(np.arange(n) + 1) % n, (np.arange(n) - 1) % n,
                           rng.randint(0, n, n)])
    vals = np.concatenate([np.full(n, 0.45), np.full(n, 0.45),
                           np.full(n, shortcut)])
    C = scipy.sparse.coo_matrix((vals, (rows, cols)), (n, n)).tocsr()
    C = C + scipy.sparse.eye(n) * 0.05
    return (scipy.sparse.diags(1.0 / np.asarray(C.sum(axis=1)).ravel())
            @ C).tocsr()


def reversible(n, seed):
    """(T, pi) of a metastable reversible MSM (the transpose builder)."""
    _, T, pi = jax_builders.transpose(
        sparse_metastable_counts(n, n_blocks=5, seed=seed))
    return scipy.sparse.csr_matrix(T), np.asarray(pi)


SMALL = np.array([[0.5, 0.4, 0.1, 0.],
                  [0.25, 0.5, 0.2, 0.05],
                  [0.1, 0.15, 0.5, 0.25],
                  [0., 0.1, 0.4, 0.5]])


@pytest.mark.parametrize('case', ['small', 'dense', 'sparse', 'reversible'])
def test_committors_match_jax(case):
    if case == 'small':
        for kind in (np.array, scipy.sparse.lil_matrix,
                     scipy.sparse.csr_matrix, scipy.sparse.coo_matrix):
            for src, snk in ((0, 3), ([0, 2], [3]), ([0], [3, 3])):
                _close(tpt.committors(kind(SMALL), src, snk),
                       jax_tpt.committors(kind(SMALL), src, snk))
        return
    if case == 'reversible':
        T, pi = reversible(2000, seed=4)
        for kw in ({}, {'pi': pi}):
            _close(tpt.committors(T, [0, 1], [1998, 1999], **kw),
                   jax_tpt.committors(T, [0, 1], [1998, 1999], **kw))
        return
    T = ring(300, seed=3)
    if case == 'dense':
        T = T.toarray()
    q = tpt.committors(T, [0], [150])
    _close(q, jax_tpt.committors(T, [0], [150]))
    assert q[0] == 0 and q[150] == 1


@pytest.mark.parametrize('case', ['all_to_all', 'sinks_dense',
                                  'sinks_sparse'])
def test_mfpts_match_jax(case):
    T = ring(120, seed=5)
    if case == 'all_to_all':
        for M in (T.toarray(), T):
            _close(tpt.mfpts(M, lagtime=2.0), jax_tpt.mfpts(M, lagtime=2.0))
        return
    if case == 'sinks_dense':
        T = T.toarray()
    _close(tpt.mfpts(T, sinks=[7, 60], lagtime=3.0),
           jax_tpt.mfpts(T, sinks=[7, 60], lagtime=3.0))
    Tr, pi = reversible(500, seed=2)
    _close(tpt.mfpts(Tr, sinks=[499], populations=pi),
           jax_tpt.mfpts(Tr, sinks=[499], populations=pi))


@pytest.mark.parametrize('sparse', [False, True])
def test_fluxes_and_populations_match_jax(sparse):
    T = ring(200, seed=6)
    if not sparse:
        T = T.toarray()
    pops = np.random.default_rng(1).random(200)
    pops /= pops.sum()
    for kw in ({}, {'populations': pops}):
        for fn in ('reactive_fluxes', 'net_fluxes', 'reactive_populations'):
            got = getattr(tpt, fn)(T, [0, 1], [100], **kw)
            ref = getattr(jax_tpt, fn)(T, [0, 1], [100], **kw)
            assert type(got) is type(ref)
            _close(got, ref)


@pytest.mark.parametrize('scheme', ['subtract', 'bottleneck'])
def test_paths_match_jax(scheme):
    T = ring(300, seed=7)
    net = tpt.net_fluxes(T, [0], [150])
    for flux in (net, net.toarray()):
        p, f = tpt.paths([0], [150], flux, remove_path=scheme, num_paths=10)
        p_ref, f_ref = jax_tpt.paths([0], [150], flux, remove_path=scheme,
                                     num_paths=10)
        assert len(p) == len(p_ref) >= 9
        assert all(np.array_equal(a, b) for a, b in zip(p, p_ref))
        _close(f, f_ref)
        path, top = tpt.top_path([0], [150], flux)
        path_ref, top_ref = jax_tpt.top_path([0], [150], flux)
        assert np.array_equal(path, path_ref) and top == top_ref
    # a custom remover gets the dense matrix, as in the reference
    p, f = tpt.paths([0], [150], net, remove_path=lambda m, path: m * 0.5,
                     num_paths=3)
    p_ref, f_ref = jax_tpt.paths([0], [150], net,
                                 remove_path=lambda m, path: m * 0.5,
                                 num_paths=3)
    assert all(np.array_equal(a, b) for a, b in zip(p, p_ref))
    _close(f, f_ref)


def _system(n=400):
    """tests/test_tpt.py :: test_refined_solve_matches_direct's system."""
    A = scipy.sparse.random(n, n, density=0.02, random_state=7)
    A = (scipy.sparse.eye(n) + 0.5 * A / np.abs(A).sum(axis=1).max()).tocsr()
    b = np.random.default_rng(5).normal(size=(n, 2))
    return A, b


_JAX_REFINED = '''
import sys
import numpy as np
import scipy.sparse
from enspara_tpu.tpt import core
sys.path.insert(0, sys.argv[2])
from test_torch_tpt import _system
A, b = _system()
np.save(sys.argv[1], core._refined_solve(A.toarray(), b, A_exact=A))
'''


def test_refined_solve_matches_jax_and_numpy(tmp_path):
    A, b = _system()
    x = core._refined_solve(A.toarray(), b, A_exact=A, device='cpu')
    x1 = core._refined_solve(core.dense_on_device(A, device='cpu'),
                             b[:, 0], A_exact=A)
    assert x is not None and x1 is not None and x.shape == b.shape
    x_np = np.linalg.solve(A.toarray(), b)
    np.testing.assert_allclose(x, x_np, rtol=1e-9, atol=1e-10)
    np.testing.assert_allclose(x1, x_np[:, 0], rtol=1e-9, atol=1e-10)
    out = str(tmp_path / 'x.npy')
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS='cpu')
    proc = subprocess.run(
        [sys.executable, '-c', _JAX_REFINED, out,
         os.path.join(REPO, 'tests')], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    np.testing.assert_allclose(x, np.load(out), rtol=1e-9, atol=1e-10)


def _on_the_device_branch(monkeypatch):
    """Make the CPU take the device branch, and record the host engines
    called."""
    monkeypatch.setattr(core, '_device_lu', lambda device: True)
    host = []
    real = core._large_sparse_absorbing_solve

    def recording(*a):
        host.append(a[1].shape)
        return real(*a)
    monkeypatch.setattr(core, '_large_sparse_absorbing_solve', recording)
    return host


def test_a_stalled_refinement_hands_over_to_the_host(monkeypatch):
    # fp32 cannot factor a system this ill-conditioned well enough to
    # contract the residual: the refinement stalls
    rng = np.random.default_rng(3)
    U, _ = np.linalg.qr(rng.normal(size=(80, 80)))
    A = U @ np.diag(np.logspace(0, 9, 80)) @ U.T
    assert core._refined_solve(A, rng.normal(size=80), device='cpu') is None

    host = _on_the_device_branch(monkeypatch)
    T = ring(300, seed=8)
    q_dev = tpt.committors(T, [0], [150])
    assert host == []                          # the device LU converged
    monkeypatch.setattr(core, '_refined_solve', lambda *a, **kw: None)
    q = tpt.committors(T, [0], [150])
    mf = tpt.mfpts(T, sinks=[150])
    assert host == [(300, 300), (300, 300)]
    _close(q, jax_tpt.committors(T, [0], [150]))
    _close(q_dev, q)
    _close(mf, jax_tpt.mfpts(T, sinks=[150]))
    # dense input: the host dense solve
    _close(tpt.committors(T.toarray(), [0], [150]), q)


def test_a_device_failure_raises(monkeypatch):
    host = _on_the_device_branch(monkeypatch)

    def failing(A):
        raise torch.OutOfMemoryError('CUDA out of memory (simulated)')
    monkeypatch.setattr(torch.linalg, 'lu_factor', failing)
    T = ring(300, seed=9)
    for call in (lambda: tpt.committors(T, [0], [150]),
                 lambda: tpt.committors(T.toarray(), [0], [150]),
                 lambda: tpt.mfpts(T, sinks=[150]),
                 lambda: tpt.mfpts(T.toarray(), sinks=[150]),
                 lambda: tpt.net_fluxes(T, [0], [150])):
        with pytest.raises(torch.OutOfMemoryError, match='simulated'):
            call()
    assert host == []
