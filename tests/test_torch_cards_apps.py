"""The port's ``collect_cards`` and ``shannon_entropy`` CLIs held against
the JAX package's on the same trajectory files, on the CPU.

Fixtures are a poly-LYS peptide (``chip_smoke.lys_peptide``) written to
``tmp_path`` with ``enspara_tpu.io.write_pdb`` and ``write_xtc``. Both
packages read the same files under ``ENSPARA_TPU_PLATFORM=cpu``: the
pickle's four matrices, the indices CSV and the entropy CSV agree within
1e-12, and the port's pickle holds numpy arrays.
"""

import pickle

import numpy as np
import pytest
import torch

from enspara_tpu.apps import collect_cards as jax_collect
from enspara_tpu.apps import shannon_entropy as jax_entropy_app
from enspara_tpu.cards import featurizers as jax_feat
from enspara_tpu import exception as jax_exception
from enspara_tpu.io import Topology, Trajectory, write_pdb, write_xtc

from enspara_tpu_torch.apps import collect_cards, shannon_entropy
from enspara_tpu_torch.apps import main as main_app
from enspara_tpu_torch.cards import featurizers
from enspara_tpu_torch.exception import ImproperlyConfigured
from enspara_tpu_torch.io import Trajectory as PortTrajectory
from enspara_tpu_torch.io import load as port_load

from chip_smoke import lys_peptide, lys_topology, lys_torsions

N_RES, N_FRAMES, N_FILES = 5, 300, 3


@pytest.fixture(autouse=True)
def _cpu_platform(monkeypatch):
    """Host inputs run on the CPU in these tests: with no device named,
    the port sends them to the card. Torch runs on one thread: the
    tier-1 run puts several test workers on one host's cores. The JAX
    apps' compile cache stays off."""
    monkeypatch.setenv('ENSPARA_TPU_PLATFORM', 'cpu')
    monkeypatch.setenv('ENSPARA_TPU_CACHE_DIR', '0')
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def write_peptide(d, seed=11):
    """A PDB topology and N_FILES XTC files of N_FRAMES frames; returns
    ``(pdb, xtc paths)``."""
    xyz = lys_peptide(lys_torsions(N_FILES * N_FRAMES, N_RES, seed,
                                   dwell=30), 'cpu')
    top = lys_topology(Topology, N_RES)
    pdb = str(d / 'pep.pdb')
    write_pdb(pdb, Trajectory(xyz[:1], top))
    trjs = []
    for i in range(N_FILES):
        trjs.append(str(d / ('pep%d.xtc' % i)))
        write_xtc(trjs[-1], Trajectory(xyz[i * N_FRAMES:(i + 1) * N_FRAMES],
                                       top))
    return pdb, trjs


def test_collect_cards_matches_jax(tmp_path):
    pdb, trjs = write_peptide(tmp_path)
    out = {}
    for tag, app in (('jax', jax_collect.main),
                     ('port', main_app.main)):
        argv = ['cards', '--trajectories', *trjs, '--topology', pdb,
                '--matrices', str(tmp_path / ('%s.pkl' % tag)),
                '--indices', str(tmp_path / ('%s.csv' % tag)),
                '--buffer-size', '20']
        assert app(['enspara'] + argv if tag == 'port' else argv) == 0
        with open(tmp_path / ('%s.pkl' % tag), 'rb') as f:
            out[tag] = (pickle.load(f),
                        np.loadtxt(tmp_path / ('%s.csv' % tag),
                                   delimiter=','))
    (port, inds), (ref, ref_inds) = out['port'], out['jax']
    assert list(port) == list(ref) == [
        'Struc_struc_MI', 'Disorder_disorder_MI', 'Struc_disorder_MI',
        'Disorder_struc_MI']
    for k in port:
        assert type(port[k]) is np.ndarray
        np.testing.assert_allclose(port[k], np.asarray(ref[k]), rtol=0,
                                   atol=1e-12, err_msg=k)
    np.testing.assert_array_equal(inds, ref_inds)
    assert inds.shape == (2 * (N_RES - 1) + 4 * N_RES, 4)


def test_shannon_entropy_matches_jax(tmp_path):
    pdb, trjs = write_peptide(tmp_path, seed=12)
    tables = {}
    for tag, app in (('jax', jax_entropy_app.main),
                     ('port', main_app.main)):
        path = str(tmp_path / ('%s.csv' % tag))
        argv = ['entropy', '--trajectories', *trjs, '--topology', pdb,
                '--entropies', path]
        assert app(['enspara'] + argv if tag == 'port' else argv) == 0
        tables[tag] = np.loadtxt(path, delimiter=',')
    assert tables['port'].shape == (N_RES, 2)
    np.testing.assert_allclose(tables['port'], tables['jax'], rtol=0,
                               atol=1e-12)
    assert ((tables['port'][:, 1] >= 0) & (tables['port'][:, 1] <= 1)).all()


def test_entropy_parity_functions_match_jax(tmp_path):
    """The reference-parity functions on a topology whose residue numbers
    start at 7 and skip one (keyed by residue.index, not resSeq)."""
    xyz = lys_peptide(lys_torsions(400, N_RES, 13, dwell=30), 'cpu')
    top = Topology()
    chain = top.add_chain()
    for i, seq in enumerate((7, 8, 10, 11, 12)):
        res = top.add_residue('LYS', chain, seq)
        for atom in lys_topology(Topology, 1).atoms:
            top.add_atom(atom.name, atom.element, res)
    pdb = str(tmp_path / 'gaps.pdb')
    write_pdb(pdb, Trajectory(xyz[:1], top))
    port_traj = PortTrajectory(xyz, port_load(pdb).top)
    rot = featurizers.RotamerFeaturizer(15).fit([port_traj, port_traj[:150]])
    jrot = jax_feat.RotamerFeaturizer(15).fit(
        [Trajectory(xyz, top), Trajectory(xyz[:150], top)])
    counts = shannon_entropy.compute_rotamer_counts(rot)
    np.testing.assert_array_equal(counts,
                                  jax_entropy_app.compute_rotamer_counts(jrot))
    h = shannon_entropy.compute_dihedral_shannon_entropy(counts)
    np.testing.assert_allclose(
        h, jax_entropy_app.compute_dihedral_shannon_entropy(counts),
        atol=1e-12)
    ent, resi = shannon_entropy.compute_residue_shannon_entropies(
        h, pdb, rot.atom_indices_, rot.n_feature_states_)
    jent, jresi = jax_entropy_app.compute_residue_shannon_entropies(
        h, pdb, jrot.atom_indices_, jrot.n_feature_states_)
    np.testing.assert_allclose(ent, jent, atol=1e-12)
    np.testing.assert_array_equal(resi, [7, 8, 10, 11, 12])
    np.testing.assert_array_equal(resi, jresi)
    ids = np.array([0, 0, 2, 4, 9])
    np.testing.assert_allclose(
        shannon_entropy.sum_dihedral_entropies(h[:5], ids, 5),
        jax_entropy_app.sum_dihedral_entropies(h[:5], ids, 5), atol=1e-12)
    np.testing.assert_allclose(
        shannon_entropy.compute_channel_capacities([2, 3, 3, 2, 3], ids, 5),
        jax_entropy_app.compute_channel_capacities([2, 3, 3, 2, 3], ids, 5),
        atol=1e-12)


@pytest.mark.parametrize('bad', ['buffer_cards', 'buffer_entropy',
                                 'two_groups'])
def test_cli_checks_match_jax(bad, tmp_path):
    out = ['--matrices', str(tmp_path / 'm.pkl'), '--indices',
           str(tmp_path / 'i.csv')]
    if bad == 'buffer_cards':
        argv = ['cards', '--trajectories', 'a.xtc', '--topology', 'a.pdb',
                '--buffer-size', '360'] + out
        mains = (collect_cards.main, jax_collect.main)
        match = 'buffer size'
    elif bad == 'buffer_entropy':
        argv = ['entropy', '--trajectories', 'a.xtc', '--topology', 'a.pdb',
                '--buffer-size', '0', '--entropies',
                str(tmp_path / 'e.csv')]
        mains = (shannon_entropy.main, jax_entropy_app.main)
        match = 'Buffer size'
    else:
        argv = ['cards', '--trajectories', 'a.xtc', '--topology', 'a.pdb',
                '--trajectories', 'b.xtc', '--topology', 'b.pdb'] + out
        mains = (collect_cards.main, jax_collect.main)
        match = 'exactly one'
    for main, error in zip(mains, (ImproperlyConfigured,
                                   jax_exception.ImproperlyConfigured)):
        with pytest.raises(error, match=match):
            main(list(argv))
