"""The port's smFRET point-cloud route held against the JAX package's on
the CPU: the dye library's resolution and its files byte for byte against
the JAX copies, the cloud pruning and dye-dye histograms (the distances
in torch ops, counted by numpy's histogram rule) equal to the JAX
package's scipy/numpy ones, ``sample_FRET_histograms`` equal for a fixed
``random_state``, and the ``smFRET_point_clouds`` CLI's three subcommands
run on both packages in temporary directories on the builtin dyes, with
equal outputs (``calc_FRET`` through the ``enspara`` dispatcher).
"""

import filecmp
import functools
import logging
import os

import numpy as np
import pytest
import scipy.sparse
import torch

import enspara_tpu.data as jax_data
from enspara_tpu import io as jax_io
from enspara_tpu.apps import smFRET_point_clouds as jax_app
from enspara_tpu.geometry import dyes_from_expt_dist as jax_dyes
from enspara_tpu.io import Topology as JaxTopology

from enspara_tpu_torch import data
from enspara_tpu_torch.apps import main as main_app
from enspara_tpu_torch.exception import MissingData
from enspara_tpu_torch.geometry import dyes_from_expt_dist as dyes
from enspara_tpu_torch.io import Topology, Trajectory
from enspara_tpu_torch.msm import sparse_metastable_counts

from chip_smoke import globule, globule_frames, label_sites, lys_topology

BUILTIN = os.path.join(os.path.dirname(data.__file__), 'dyes_builtin')
JAX_BUILTIN = os.path.join(os.path.dirname(jax_data.__file__),
                           'dyes_builtin')
N_RES = 30


@pytest.fixture(autouse=True)
def _cpu_platform(monkeypatch):
    """Host inputs run on the CPU in these tests: with no device named,
    the port sends them to the card. Torch runs on one thread: the
    tier-1 run puts several test workers on one host's cores."""
    monkeypatch.setenv('ENSPARA_TPU_PLATFORM', 'cpu')
    monkeypatch.delenv('ENSPARA_TPU_DYE_DIR', raising=False)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def centers(n_frames=6):
    """Frames of a globule (port and JAX Trajectory) and two label pairs
    of outward-facing surface residues."""
    xyz, _, groups = globule_frames(globule(N_RES, seed=8), n_frames,
                                    seed=9, planted=(1, 2, 0.4))
    port = Trajectory(xyz, lys_topology(Topology, N_RES))
    jax = jax_io.Trajectory(xyz, lys_topology(JaxTopology, N_RES))
    return port, jax, label_sites(port, 2, np.concatenate(groups))


def cloud(name):
    return (dyes.load_dye(os.path.join(BUILTIN, 'point-clouds', name)),
            jax_dyes.load_dye(os.path.join(JAX_BUILTIN, 'point-clouds',
                                           name)))


def test_dye_library_resolves_as_jax_does(monkeypatch, tmp_path, caplog):
    cmp = filecmp.dircmp(BUILTIN, JAX_BUILTIN, ignore=['__pycache__'])
    assert not (cmp.left_only or cmp.right_only or cmp.diff_files)
    for sub in ('R0', 'point-clouds'):
        names = sorted(os.listdir(os.path.join(BUILTIN, sub)))
        assert names == sorted(os.listdir(os.path.join(JAX_BUILTIN, sub)))
        _, mismatch, errors = filecmp.cmpfiles(
            os.path.join(BUILTIN, sub), os.path.join(JAX_BUILTIN, sub),
            names, shallow=False)
        assert not mismatch and not errors
    monkeypatch.setattr(data.dye_library_path, '_warned_builtin', False,
                        raising=False)
    with caplog.at_level(logging.WARNING):
        assert data.dye_library_path() == BUILTIN
        assert data.dye_library_path() == BUILTIN
    assert sum('SYNTHETIC' in r.message for r in caplog.records) == 1
    np.testing.assert_array_equal(dyes.load_dye('SF488').xyz,
                                  cloud('SF488.pdb')[1].xyz)
    monkeypatch.setenv('ENSPARA_TPU_DYE_DIR', str(tmp_path))
    assert data.dye_library_path() == str(tmp_path)
    monkeypatch.setattr(data, '_candidates', lambda: [''])
    assert data.dye_library_path(required=False) is None
    with pytest.raises(MissingData, match='ENSPARA_TPU_DYE_DIR'):
        data.dye_library_path()


def test_cloud_distances_match_jax():
    port, jax, pairs = centers(n_frames=2)
    (d1, j1), (d2, j2) = cloud('SF488.pdb'), cloud('SF594.pdb')
    frame = port[0]
    pts = dyes.align_dye_to_res(frame, d1.xyz[0], int(pairs[0, 0]))
    jpts = jax_dyes.align_dye_to_res(jax[0], j1.xyz[0], int(pairs[0, 0]))
    np.testing.assert_array_equal(pts, jpts)
    kept = dyes.remove_touches_protein(pts, frame, probe_radius=0.2)
    np.testing.assert_array_equal(
        kept, jax_dyes.remove_touches_protein(jpts, jax[0],
                                              probe_radius=0.2))
    assert 0 < len(kept) < len(pts)
    other = dyes.align_dye_to_res(frame, d2.xyz[0], int(pairs[0, 1]))
    for a, b in zip(dyes.pairwise_distance_distribution(kept, other),
                    jax_dyes.pairwise_distance_distribution(kept, other)):
        np.testing.assert_array_equal(a, b)
    # a batch of clouds of other sizes, far from the origin (the padding)
    rng = np.random.default_rng(4)
    batch = [(rng.random((n1, 3)) + 40, rng.random((n2, 3)) + 40.3)
             for n1, n2 in ((5, 7), (9, 3), (1, 1))]
    for (a, b), got in zip(batch, dyes._pair_histograms(
            batch, 0.1, torch.device('cpu'))):
        for g, w in zip(got, jax_dyes.pairwise_distance_distribution(a, b)):
            np.testing.assert_array_equal(g, w)
    for a, b in zip(dyes.bincount_dists(np.array([0.0, 0.1, 0.25, 0.3])),
                    jax_dyes.bincount_dists(np.array([0.0, 0.1, 0.25,
                                                      0.3]))):
        np.testing.assert_array_equal(a, b)


def test_dye_distance_distribution_matches_jax():
    port, jax, pairs = centers()
    (d1, j1), (d2, j2) = cloud('SF488.pdb'), cloud('SF594.pdb')
    for pair in pairs:
        got = dyes.dye_distance_distribution(port, d1, d2, pair, n_procs=2)
        want = jax_dyes.dye_distance_distribution(jax, j1, j2, pair,
                                                  n_procs=2)
        for g, w in zip(got, want):
            assert len(g) == len(w) == len(port)
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)


def test_sample_fret_histograms_match_jax():
    n = 16
    C = sparse_metastable_counts(n, n_blocks=2, seed=1)
    rows = np.asarray(C.sum(1)).ravel()
    T = scipy.sparse.diags(1 / rows) @ C
    pops = rows / rows.sum()
    rng = np.random.default_rng(3)
    dist = dyes.make_distribution(
        [rng.random(40) for _ in range(n)],
        [np.linspace(0, 4, 41) for _ in range(n)])
    times = [rng.exponential(0.5, int(k)) for k in rng.integers(5, 30, 12)]
    frames = dyes.convert_photon_times(times, 10.0, 2)
    jframes = jax_dyes.convert_photon_times(times, 10.0, 2)
    for a, b in zip(frames, jframes):
        np.testing.assert_array_equal(a, b)
    kw = dict(n_procs=3, n_photon_std=3, random_state=5)
    fe, trajs = dyes.sample_FRET_histograms(T, pops, dist, frames, 5.4, **kw)
    jfe, jtrajs = jax_dyes.sample_FRET_histograms(T, pops, dist, frames, 5.4,
                                                  **kw)
    np.testing.assert_array_equal(np.asarray(fe, float),
                                  np.asarray(jfe, float))
    for a, b in zip(trajs, jtrajs):
        np.testing.assert_array_equal(a, b)


def run_cli(main, out, centers_xtc, pdb, pairs_txt, dye_dir, expt,
            photons, eq, tprobs):
    """model_dyes, calc_FRET (through ``main`` as given) and fit_FRET
    into ``out``."""
    model = os.path.join(out, 'model')
    fit = os.path.join(out, 'fit')
    assert main(['smFRET', 'model_dyes', centers_xtc, pdb, pairs_txt,
                 '--FRETdye1', os.path.join(dye_dir, 'SF488.pdb'),
                 '--FRETdye2', os.path.join(dye_dir, 'SF594.pdb'),
                 '--n_procs', '2', '--output_dir', model]) == 0
    for factor in ('1', '3'):
        assert main(['smFRET', 'calc_FRET', eq, tprobs, '100', model,
                     pairs_txt, '--photon_times', photons, '--time_factor',
                     factor, '--n_chunks', '2', '--output_dir', out]) == 0
    conf = os.path.join(out, 'conf.txt')
    with open(conf, 'w') as f:
        for _ in range(2):
            f.write('%s %s\n' % (expt, out))
    assert main(['smFRET', 'fit_FRET', conf, pairs_txt, '--method',
                 'sum_sq_residuals', '--output_dir', fit]) == 0
    return sorted(os.listdir(model)), sorted(
        f for f in os.listdir(out) if f.endswith('.npy')), sorted(
            os.listdir(fit))


def test_cli_subcommands_match_jax(tmp_path, monkeypatch):
    # calc_FRET seeds its bursts from the OS; seed both packages' alike
    for mod in (dyes, jax_dyes):
        monkeypatch.setattr(mod, 'sample_FRET_histograms', functools.partial(
            mod.sample_FRET_histograms, random_state=0))
    port, jax, pairs = centers(n_frames=5)
    pdb, xtc = str(tmp_path / 'glob.pdb'), str(tmp_path / 'centers.xtc')
    jax_io.write_pdb(pdb, jax[0])
    jax_io.write_xtc(xtc, jax)
    pairs_txt = str(tmp_path / 'pairs.txt')
    np.savetxt(pairs_txt, pairs, fmt='%d')
    rng = np.random.default_rng(11)
    T = rng.random((5, 5)) + 2 * np.eye(5)
    T /= T.sum(1, keepdims=True)
    eq, tprobs = str(tmp_path / 'eq.npy'), str(tmp_path / 't.npy')
    np.save(eq, np.full(5, 0.2))
    np.save(tprobs, T)
    photons = str(tmp_path / 'photons.npy')
    np.save(photons, np.array([rng.exponential(20.0, int(k))
                               for k in rng.integers(8, 20, 6)],
                              dtype=object), allow_pickle=True)
    expt = str(tmp_path / 'expt.txt')
    np.savetxt(expt, np.stack([np.linspace(0.05, 0.95, 10),
                               rng.integers(1, 50, 10)], 1))

    def dispatched(argv):
        return main_app.main(['enspara', 'smfret-clouds'] + argv[1:])
    outs = {}
    for tag, main in (('port', dispatched), ('jax', jax_app.main)):
        out = tmp_path / tag
        out.mkdir()
        outs[tag] = run_cli(main, str(out), xtc, pdb, pairs_txt,
                            os.path.join(BUILTIN, 'point-clouds'), expt,
                            photons, eq, tprobs)
    assert outs['port'] == outs['jax']
    listing, fe_files, fit_files = outs['port']
    assert len(listing) == 4 and len(fe_files) == 4 and fit_files
    from enspara_tpu import ra as jax_ra
    from enspara_tpu_torch import ra
    for name in listing:
        got = ra.load(str(tmp_path / 'port' / 'model' / name))
        want = jax_ra.load(str(tmp_path / 'jax' / 'model' / name))
        np.testing.assert_array_equal(np.asarray(got._data),
                                      np.asarray(want._data))
    for sub, names in (('', fe_files), ('fit', fit_files)):
        for name in names:
            got = np.load(str(tmp_path / 'port' / sub / name),
                          allow_pickle=True)
            want = np.load(str(tmp_path / 'jax' / sub / name),
                           allow_pickle=True)
            np.testing.assert_array_equal(np.asarray(got, float),
                                          np.asarray(want, float))
