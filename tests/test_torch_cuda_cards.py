"""The port's CARDS chain on the card against its plain versions. Imports
no jax: on the card machine, run with
``python -m pytest --noconftest -m cuda tests/test_torch_cuda_cards.py``.

The ``cuda`` tests skip without a card. They hold the joint counts on
the card (one device, across chunks, a 2-shard mesh of the card) exactly
equal to the host bincount, the hysteresis scan equal to the host
``_rotamers`` column by column, the device label painter and
``weighted_mi`` to their host and CPU results, and show that the card
path runs with every host plain version made to raise.
"""

import importlib

import numpy as np
import pytest
import torch

from enspara_tpu_torch.cards import cards_matrices, disorder
from enspara_tpu_torch.geometry import rotamer
from enspara_tpu_torch.info_theory import libinfo, mutual_info
from enspara_tpu_torch.io import Topology, Trajectory
from enspara_tpu_torch.parallel import FrameMesh

from chip_smoke import lys_peptide, lys_topology, lys_torsions

cards_mod = importlib.import_module('enspara_tpu_torch.cards.cards')


@pytest.fixture(autouse=True)
def _cpu_platform(monkeypatch):
    """Host inputs run on the CPU in these tests unless a test names the
    card. Torch runs on one thread: the tier-1 run puts several test
    workers on one host's cores."""
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
    return torch.device('cuda', 0)


def _labels(rng, T, F, n, dwell=50):
    hidden = np.cumsum(rng.random((T, F)) < 1 / dwell, axis=0) % n
    return hidden.astype(np.int16)


@pytest.mark.cuda
def test_cuda_joint_counts_match_plain(cuda, monkeypatch):
    rng = np.random.default_rng(0)
    X = _labels(rng, 300_000, 40, 3)
    Y = _labels(rng, 300_000, 25, 2)
    ref = libinfo.matrix_bincount2d_np(X, Y, 3, 2)
    X_dev, Y_dev = torch.from_numpy(X).to(cuda), torch.from_numpy(Y).to(cuda)
    np.testing.assert_array_equal(libinfo.matrix_bincount2d(X_dev, Y_dev, 3,
                                                            2), ref)
    np.testing.assert_array_equal(
        libinfo.matrix_bincount2d(X, Y, 3, 2, device=cuda), ref)
    np.testing.assert_array_equal(
        libinfo.matrix_bincount2d(X_dev, Y_dev, 3, 2,
                                  mesh=FrameMesh((cuda,) * 2)), ref)
    monkeypatch.setattr(libinfo, '_CHUNK_ELEMENTS', 185 * 37_001)
    np.testing.assert_array_equal(libinfo.matrix_bincount2d(X_dev, Y_dev, 3,
                                                            2), ref)
    same = libinfo.matrix_bincount2d(X_dev, X_dev, 3, 3)
    np.testing.assert_array_equal(same,
                                  libinfo.matrix_bincount2d_np(X, X, 3, 3))
    assert same.dtype == np.uint32 and same.max() > 2 ** 16


@pytest.mark.cuda
@pytest.mark.parametrize('chunk', [1000, 1 << 16])
def test_cuda_rotamer_scan_equals_host(cuda, chunk):
    rng = np.random.default_rng(chunk)
    for hb in ([0, 180, 360], [0, 120, 240, 360]):
        centers = (np.array(hb[:-1]) + np.array(hb[1:])) / 2
        hidden = _labels(rng, 100_000, 12, len(centers), dwell=200)
        ang = np.minimum(np.remainder(
            centers[hidden] + 12 * rng.normal(size=hidden.shape), 360),
            359.5)
        got = rotamer.rotamer_states(torch.from_numpy(ang).to(cuda), hb,
                                     15, chunk=chunk)
        assert got.device.type == 'cuda' and got.dtype == torch.int16
        got = got.cpu().numpy()
        for j in range(ang.shape[1]):
            np.testing.assert_array_equal(got[:, j],
                                          rotamer._rotamers(ang[:, j], hb,
                                                            15))


@pytest.mark.cuda
def test_cuda_labels_and_weighted_mi_match_host(cuda):
    rng = np.random.default_rng(2)
    trajs = [_labels(rng, 50_000, 30, 3, dwell=d) for d in (20, 400)]
    host, _ = disorder.assign_order_disorder(trajs)
    dev, _ = cards_mod._disorder_labels(
        [torch.from_numpy(t).to(cuda) for t in trajs], cuda)
    for a, b in zip(dev, host):
        assert a.device.type == 'cuda'
        np.testing.assert_array_equal(a.cpu().numpy(), b)
    X = rng.random((20_000, 40)) < 0.4
    w = rng.random(20_000)
    np.testing.assert_allclose(
        mutual_info.weighted_mi(X, w, device=cuda),
        mutual_info.weighted_mi(X, w, device='cpu'), rtol=0, atol=1e-12)


@pytest.mark.cuda
def test_cuda_path_takes_no_host_fallback(cuda, monkeypatch):
    """cards_matrices and all_rotamers on the card equal their CPU runs
    with the host plain versions (bincount, _rotamers, the host painter)
    made to raise."""
    rng = np.random.default_rng(3)
    trajs = [_labels(rng, 40_000, 20, 3, dwell=d) for d in (30, 300)]
    n_states = np.full(20, 3, dtype=np.int16)
    cpu = cards_matrices(trajs, n_states, device='cpu')
    traj = Trajectory(lys_peptide(lys_torsions(20_000, 6, 1), 'cpu'),
                      lys_topology(Topology, 6))
    cpu_states = rotamer.all_rotamers(traj, device='cpu')[0]

    def refuse(*a, **k):
        raise AssertionError('a host plain version ran on the card path')
    for mod, name in ((libinfo, 'matrix_bincount2d_np'),
                      (libinfo, 'bincount2d'), (rotamer, '_rotamers'),
                      (disorder, '_paint_labels')):
        monkeypatch.setattr(mod, name, refuse)
    monkeypatch.setenv('ENSPARA_TPU_PLATFORM', 'cuda')
    for a, b in zip(cards_matrices(trajs, n_states), cpu):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(rotamer.all_rotamers(traj)[0], cpu_states)
