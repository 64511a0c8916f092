"""The port's structure-analysis path on the card against its CPU runs.
Imports no jax: on the card machine, run with
``python -m pytest --noconftest -m cuda tests/test_torch_cuda_geometry.py``.

The ``cuda`` tests skip without a card. They hold ``shrake_rupley`` on
the card (neighbor list, dense, a 3-shard mesh of the card) equal to the
CPU run, the exposon labels and MI to the CPU run, the dye-cloud
histograms to the CPU counts, and show that a failure on the card raises
instead of falling back to the host.
"""

import numpy as np
import pytest
import torch

from enspara_tpu_torch.geometry import dyes_from_expt_dist as dyes
from enspara_tpu_torch.geometry import sasa
from enspara_tpu_torch.info_theory import exposons
from enspara_tpu_torch.io import Topology, Trajectory
from enspara_tpu_torch.parallel import FrameMesh

from chip_smoke import globule, globule_frames, label_sites, lys_topology

pytestmark = pytest.mark.cuda


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


def centers(n_res=40, n_frames=24):
    xyz, _, groups = globule_frames(globule(n_res, seed=21), n_frames,
                                    seed=22, planted=(2, 4, 0.6))
    return Trajectory(xyz, lys_topology(Topology, n_res)), groups


@pytest.mark.parametrize('n_neighbors', ['auto', None])
def test_cuda_sasa_equals_the_cpu_run(cuda, n_neighbors):
    traj, _ = centers()
    kw = dict(probe_radius=0.28, n_neighbors=n_neighbors)
    card = sasa.shrake_rupley(traj, device=cuda, **kw)
    host = sasa.shrake_rupley(traj, device='cpu', **kw)
    assert np.abs(card - host).max() <= 1e-6
    mesh = sasa.shrake_rupley(traj, mesh=FrameMesh([cuda] * 3), **kw)
    np.testing.assert_array_equal(mesh, card)
    tensor = sasa.shrake_rupley((torch.as_tensor(traj.xyz, device=cuda),
                                 sasa._radii_from_top(traj.top)), **kw)
    np.testing.assert_array_equal(tensor, card)


def test_cuda_exposons_equal_the_cpu_run(cuda):
    traj, _ = centers()
    mi, labels = exposons.exposons(traj, 0.9, device=cuda)
    cmi, clabels = exposons.exposons(traj, 0.9, device='cpu')
    assert np.abs(mi - cmi).max() <= 1e-12
    np.testing.assert_array_equal(labels, clabels)


def test_cuda_dye_histograms_equal_the_cpu_counts(cuda):
    traj, groups = centers(n_frames=8)
    d1, d2 = dyes.load_dye('SF488'), dyes.load_dye('SF594')
    for pair in label_sites(traj, 2, np.concatenate(groups)):
        card = dyes.dye_distance_distribution(traj, d1, d2, pair,
                                              device=cuda, n_procs=4)
        host = dyes.dye_distance_distribution(traj, d1, d2, pair,
                                              device='cpu')
        for g, h in zip(card, host):
            for a, b in zip(g, h):
                np.testing.assert_array_equal(a, b)


def test_cuda_failure_raises_instead_of_falling_back(cuda, monkeypatch):
    traj, _ = centers(n_frames=2)

    def broken(*args, **kwargs):
        raise RuntimeError('planted device failure')
    monkeypatch.setattr(sasa, '_sum_sq_diff', broken)
    monkeypatch.setattr(sasa, 'shrake_rupley_np', broken)
    with pytest.raises(RuntimeError, match='planted device failure'):
        sasa.shrake_rupley(traj, device=cuda)
    monkeypatch.setattr(dyes, '_cdist', broken)
    with pytest.raises(RuntimeError, match='planted device failure'):
        dyes.pairwise_distance_distribution(np.zeros((3, 3)),
                                            np.ones((2, 3)), device=cuda)
