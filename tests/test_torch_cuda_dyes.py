"""The port's explicit-dye route on the card against its CPU runs. Imports
no jax: on the card machine, run with
``python -m pytest --noconftest -m cuda tests/test_torch_cuda_dyes.py``.

The ``cuda`` tests skip without a card. They hold the clash test on the
card (the float64 screen and the exact re-test of near ties) equal to the
CPU's counts, the alias tables built on the card to their rows, the
lockstep Monte Carlo on the card to the exact absorbing chain, and
``calc_lifetimes`` of every center on the card to the CPU's kept states.
"""

import numpy as np
import pytest
import torch

from enspara_tpu_torch import io as port_io
from enspara_tpu_torch.geometry import dye_lifetimes as dl
from enspara_tpu_torch.geometry import explicit_r0_calc as r0c
from enspara_tpu_torch.io import Topology, Trajectory
from enspara_tpu_torch.msm import builders

from chip_smoke import (exact_outcomes, explicit_dye_library, globule,
                        globule_frames, label_sites, lys_topology)

pytestmark = pytest.mark.cuda

N_RES, N_DYE, N_CENTERS = 40, 60, 6


@pytest.fixture(scope='module')
def library(tmp_path_factory):
    path = str(tmp_path_factory.mktemp('dyes'))
    return path, explicit_dye_library(path, 0, n_frames=N_DYE)


@pytest.fixture(autouse=True)
def _cpu_platform(monkeypatch, library):
    """Host inputs run on the CPU in these tests unless a test names the
    card; the dye library is the synthetic one. Torch runs on one thread:
    the tier-1 run puts several test workers on one host's cores."""
    monkeypatch.setenv('ENSPARA_TPU_PLATFORM', 'cpu')
    monkeypatch.setenv('ENSPARA_TPU_DYE_DIR', library[0])
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


def system(library):
    xyz, _, groups = globule_frames(globule(N_RES, seed=21), N_CENTERS,
                                    seed=22, planted=(2, 4, 0.6))
    traj = Trajectory(xyz, lys_topology(Topology, N_RES))
    (dn, ddcd, dpdb, dc), (an, adcd, apdb, ac) = library[1].values()
    return (traj, label_sites(traj, 1, np.concatenate(groups))[0], [dn, an],
            [port_io.load(ddcd, top=dpdb), port_io.load(adcd, top=apdb)],
            [np.load(dc), np.load(ac)])


def test_cuda_clash_test_equals_the_cpu(cuda, library, monkeypatch):
    traj, pair, names, dyes, _ = system(library)
    lib = r0c.load_library()
    for k in range(2):
        card = r0c._place_and_prune(traj, dyes[k], int(pair[k]), names[k],
                                    lib, n_procs=4, device=cuda)
        host = r0c._place_and_prune(traj, dyes[k], int(pair[k]), names[k],
                                    lib, n_procs=4, device='cpu')
        np.testing.assert_array_equal(card[0], host[0])
        assert all(np.array_equal(a, b) for a, b in zip(card[1], host[1]))
    # near ties: dye atoms on their clearance to the last bit
    rng = np.random.default_rng(3)
    prot = rng.normal(0, 1.0, (2, 80, 3)).astype(np.float32)
    j = rng.permutation(80)[:40]
    dirs = rng.normal(size=(2, 40, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    pts = (prot[:, j] + 0.2 * dirs).astype(np.float32)
    d = np.sqrt(((pts.astype(np.float64)
                  - prot[:, j].astype(np.float64)) ** 2).sum(-1))[0]
    clearance = np.full(80, 0.01)
    clearance[j] = np.where(np.arange(40) % 2, d, np.nextafter(d, 0))
    dye = pts.reshape(2, 4, 10, 3)
    host = r0c._clear_atoms(dye, prot, clearance, torch.device('cpu'))
    np.testing.assert_array_equal(
        r0c._clear_atoms(dye, prot, clearance, cuda), host)
    monkeypatch.setattr(r0c.dyefs, '_CHUNK_ELEMS', 1 << 10)
    np.testing.assert_array_equal(
        r0c._clear_atoms(dye, prot, clearance, cuda), host)


def test_cuda_alias_tables_reproduce_their_rows(cuda):
    rng = np.random.default_rng(0)
    P = rng.random((2000, 97)) * (rng.random((2000, 97)) < 0.3)
    P[5] = 0
    prob, alias = dl._alias_tables(torch.as_tensor(P, device=cuda))
    prob, alias = prob.cpu().numpy(), alias.cpu().numpy()
    n = P.shape[1]
    got = prob / n
    for r in range(len(P)):
        np.add.at(got[r], alias[r], (1 - prob[r]) / n)
    mass = P.sum(1, keepdims=True)
    live = mass[:, 0] > 0
    assert np.abs(got[live] - P[live] / mass[live]).max() < 1e-13


def test_cuda_lockstep_matches_the_exact_chain(cuda, library):
    """60 x 60 dye states, 200,000 photons on the card: outcome fractions
    and mean steps within 5 standard errors of the exact chain (solved in
    float64 on the card)."""
    traj, pair, names, dyes, counts = system(library)
    lib = r0c.load_library()
    far = dyes[1].copy()
    far.xyz = far.xyz + np.float32([7.5, 0.0, 0.0])
    (_, dT, deq), (_, aT, aeq) = (builders.normalize(c) for c in counts)
    params = r0c.get_dye_overlap(*names)
    lag, n = 0.02, 200_000
    probs = dl._pair_rate_tables(*names, dyes[0], far, params, lag, lib)
    frac, mean, _ = exact_outcomes(probs, dT, aT, deq, aeq, cuda)
    steps, out = dl.resolve_excitations_device(
        *names, dT, aT, deq, aeq, dyes[0], far, params, lag, lib,
        n_samples=n, rng_seed=5, device=cuda)
    for c, ch in enumerate(('radiative', 'non_radiative',
                            'energy_transfer')):
        f = (out == ch).mean()
        assert abs(f - frac[c]) <= 5 * np.sqrt(frac[c] * (1 - frac[c]) / n)
    assert abs(steps.mean() - mean) <= 5 * steps.std() / np.sqrt(n)


def test_cuda_calc_lifetimes_of_every_center(cuda, library):
    traj, pair, names, dyes, counts = system(library)
    events, info = dl._calc_lifetimes_all(
        traj, dyes[0], counts[0], dyes[1], counts[1], pair, names, 0.002,
        n_samples=256, dye_treatment='Monte-carlo-device', rng_seed=2,
        n_procs=4, device=cuda)
    _, host = dl._calc_lifetimes_all(
        traj, dyes[0], counts[0], dyes[1], counts[1], pair, names, 0.002,
        n_samples=8, dye_treatment='static', rng_seed=2, device='cpu')
    for k in range(2):
        assert all(np.array_equal(a, b)
                   for a, b in zip(info['kept'][k], host['kept'][k]))
    assert len(events) == N_CENTERS and info['lockstep_steps'] > 0
    for lt, oc in events:
        assert len(lt) in (0, 256) and len(lt) == len(oc)
        assert set(oc) <= {'radiative', 'non_radiative', 'energy_transfer'}
