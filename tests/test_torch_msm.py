"""enspara_tpu_torch.msm held against the JAX package: masked lag
counting (exactly equal counts) and the transpose-builder tail
(eigenvalues to 1e-4, pi to 1e-5, eigenvectors to 1e-3 up to sign)."""

import numpy as np
import pytest
import torch

from enspara_tpu.exception import DataInvalid as JaxDataInvalid
from enspara_tpu.msm.eigen_device import \
    transpose_timescales_device as jax_tail
from enspara_tpu.msm.transition_matrices import \
    assigns_to_counts_device as jax_counts

from enspara_tpu_torch.exception import DataInvalid
from enspara_tpu_torch.msm import (assigns_to_counts_device,
                                   transpose_timescales_device)


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


def _assigns(rng, n_traj=5, length=300, n_states=7):
    a = rng.integers(0, n_states, size=(n_traj, length))
    return a, np.ones_like(a, dtype=bool)


@pytest.mark.parametrize('case', ['plain', 'gaps', 'padded_rows',
                                  'strided', 'tensor_input'])
def test_counts_match_jax(case):
    rng = np.random.default_rng(0)
    a, mask = _assigns(rng)
    lag, sliding = 3, True
    if case == 'gaps':
        a[rng.random(a.shape) < 0.1] = -1
    elif case == 'padded_rows':
        for r, n in enumerate((300, 120, 50, 7, 2)):
            mask[r, n:] = False
            a[r, n:] = 99                    # masked-out padding values
    elif case == 'strided':
        sliding = False
    ref = np.asarray(jax_counts(a, mask, lag, 7, sliding_window=sliding))
    arg = torch.from_numpy(a) if case == 'tensor_input' else a
    got = assigns_to_counts_device(arg, mask, lag, 7,
                                   sliding_window=sliding)
    assert got.dtype == torch.int32 and tuple(got.shape) == (7, 7)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert got.numpy().sum() > 0


def test_counts_validation_matches_jax():
    a = np.array([[0, 1, 7, 2]])
    mask = np.ones_like(a, dtype=bool)
    for fn, error in ((jax_counts, JaxDataInvalid),
                      (assigns_to_counts_device, DataInvalid)):
        with pytest.raises(error):
            fn(a, mask, 1, 7)                # state 7 >= n_states
        with pytest.raises(error):
            fn(a, mask, 0, 8)                # lag must be >= 1
    mask[0, 2] = False                       # out of range but masked out
    np.testing.assert_array_equal(
        assigns_to_counts_device(a, mask, 1, 7).numpy(),
        np.asarray(jax_counts(a, mask, 1, 7)))


def test_counts_tensor_input_drops_out_of_range_states():
    """A tensor input is not checked on the host (that would read it
    back from the card): a state >= n_states drops its pairs, as a
    masked-out cell does, instead of counting into another pair's bin or
    indexing past the counts (a device-side assert on the card)."""
    a = np.array([[0, 1, 7, 2, 3], [2, 2, 1, 0, 9]])
    mask = np.ones_like(a, dtype=bool)
    got = assigns_to_counts_device(torch.from_numpy(a), mask, 1, 7)
    inside = mask & (a < 7)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_counts(a, inside, 1, 7)))
    assert got.numpy().sum() == 5


def _compare_tail(C, k):
    ts, w, v = transpose_timescales_device(torch.from_numpy(C), k,
                                           lag_time=2)
    jts, jw, jv = jax_tail(C, n_eigs=k, lag_time=2)
    jw, jv = np.asarray(jw), np.asarray(jv)
    assert w.shape == (k,) and v.shape == (C.shape[0], k)
    np.testing.assert_allclose(w, jw, atol=1e-4)
    np.testing.assert_allclose(v[:, 0], jv[:, 0], atol=1e-5)  # pi
    for i in range(1, k):
        sign = np.sign(v[:, i] @ jv[:, i])
        np.testing.assert_allclose(sign * v[:, i], jv[:, i], atol=1e-3)
    np.testing.assert_allclose(ts, np.asarray(jts), rtol=1e-3)
    return w, v


def test_transpose_tail_matches_jax():
    rng = np.random.default_rng(1)
    # a metastable 3-block chain: well-separated leading eigenvalues
    n = 30
    C = rng.integers(0, 3, size=(n, n)).astype(np.float64)
    for b in range(3):
        s = slice(10 * b, 10 * b + 10)
        C[s, s] += rng.integers(20, 60, size=(10, 10))
    w, v = _compare_tail(C, 5)
    assert abs(w[0] - 1.0) < 1e-5 and np.isclose(v[:, 0].sum(), 1.0)


def test_transpose_tail_zero_count_state():
    """A zero-count state (max_n_states padding) keeps the spectrum
    finite, as in tests/test_eigen_device.py."""
    C = np.array([[5, 2, 0], [1, 4, 0], [0, 0, 0]], dtype=np.float64)
    ts, w, v = transpose_timescales_device(C, 2)
    assert np.isfinite(w).all() and np.isfinite(ts).all()
    _compare_tail(C, 2)
