"""The port's north-star slice end to end against the JAX pipeline, at
a small size: 4,096 frames x 16 atoms (the bench.py generator, numpy
seed) -> 64 k-centers states -> lag-5 counts -> 8 transpose-builder
eigenpairs. Each package ingests the coordinates itself; the JAX side
runs its Pallas path in interpret mode.

Bars: centers and assignments exactly equal (tie-free data), counts
exactly equal, eigenvalues 1e-4, pi 1e-5, eigenvectors 1e-3 up to sign.
"""

import numpy as np
import pytest
import torch

from enspara_tpu.cluster import engine as jengine
from enspara_tpu.msm.eigen_device import \
    transpose_timescales_device as jax_tail
from enspara_tpu.msm.transition_matrices import \
    assigns_to_counts_device as jax_counts

from enspara_tpu_torch.cluster import engine
from enspara_tpu_torch.msm import (assigns_to_counts_device,
                                   transpose_timescales_device)

from test_torch_port import assert_rmsd_close


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

N, ATOMS, K, LAG, EIGS = 4096, 16, 64, 5, 8


def random_walk(rng):
    """Frames around one structure with a per-frame scalar drift and
    noise, centered (bench.py:169-177)."""
    base = rng.normal(size=(ATOMS, 3)).astype(np.float32)
    drift = rng.normal(size=(N, 1, 1)).astype(np.float32)
    noise = rng.normal(size=(N, ATOMS, 3)).astype(np.float32)
    frames = base[None] + 0.3 * drift * base[None] + 0.1 * noise
    return frames - frames.mean(axis=1, keepdims=True)


def test_north_star_slice_matches_jax():
    X = random_walk(np.random.default_rng(42))
    mask = np.ones((4, N // 4), dtype=bool)

    jprep = jengine.prepare_rmsd_frames(X, tile=128)
    jres = jengine.kcenters_device_fused(jprep, n_clusters=K,
                                         interpret=True)
    ja = jres.assignments.reshape(4, -1)
    jc = np.asarray(jax_counts(ja, mask, LAG, K))
    _, jw, jv = jax_tail(jc, n_eigs=EIGS, lag_time=LAG)

    res = engine.kcenters_device_fused(X, n_clusters=K)
    a = res.assignments.reshape(4, -1)
    counts = assigns_to_counts_device(a, mask, LAG, K)
    _, w, v = transpose_timescales_device(counts, EIGS, lag_time=LAG)

    assert res.n_found == jres.n_found == K
    np.testing.assert_array_equal(res.center_indices, jres.center_indices)
    np.testing.assert_array_equal(res.assignments, jres.assignments)
    assert_rmsd_close(res.distances, jres.distances,
                      2 * float(np.max(np.asarray(jprep.g))), ATOMS)
    np.testing.assert_array_equal(counts.numpy(), jc)
    jw, jv = np.asarray(jw), np.asarray(jv)
    np.testing.assert_allclose(w, jw, atol=1e-4)
    np.testing.assert_allclose(v[:, 0], jv[:, 0], atol=1e-5)
    for i in range(1, EIGS):
        sign = np.sign(v[:, i] @ jv[:, i])
        np.testing.assert_allclose(sign * v[:, i], jv[:, i], atol=1e-3)
