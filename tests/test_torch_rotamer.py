"""The port's dihedrals and rotamer states (``enspara_tpu_torch.geometry``)
held against the JAX package's on the same numpy inputs, on the CPU:
dihedrals within 1e-5 rad (modulo 2 pi), atom quartets equal, rotamer
states exactly equal to ``_rotamers`` and ``rotamers_device`` on tie-free
data, and, on a planted angle within float32 rounding of a gate, equal
to ``rotamers_device`` (float32 gates), not to the float64 host loop.

The test peptide is poly-LYS, placed by NeRF from hidden basin chains
(``chip_smoke.lys_peptide``), a few residues and frames.
"""

import numpy as np
import pytest
import torch

from enspara_tpu.geometry import dihedrals as jax_dih
from enspara_tpu.geometry import rotamer as jax_rot
from enspara_tpu.io import Topology as JaxTopology
from enspara_tpu.io import Trajectory as JaxTrajectory

from enspara_tpu_torch.exception import DataInvalid
from enspara_tpu_torch.geometry import dihedrals, rotamer
from enspara_tpu_torch.io import Topology, Trajectory

from chip_smoke import lys_peptide, lys_topology, lys_torsions

KINDS = ('phi', 'psi', 'chi1', 'chi2', 'chi3', 'chi4')
BOUNDARIES = ([0, 180, 360], [0, 160, 360], [0, 120, 240, 360])


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


def peptide(n_res=6, n_frames=600, seed=3):
    """The same poly-LYS frames as a port and a JAX Trajectory."""
    xyz = lys_peptide(lys_torsions(n_frames, n_res, seed, dwell=40),
                      'cpu')
    return (Trajectory(xyz, lys_topology(Topology, n_res)),
            JaxTrajectory(xyz, lys_topology(JaxTopology, n_res)))


def basin_angles(rng, T, F, hb, dwell=30, noise=12.0):
    """(T, F) float64 degrees hopping between the basins of ``hb``, with
    no angle within 0.01 degrees of a gate or a boundary (tie-free)."""
    hb = np.asarray(hb, float)
    centers = (hb[:-1] + hb[1:]) / 2
    hidden = np.cumsum(rng.random((T, F)) < 1 / dwell, axis=0) \
        % len(centers)
    ang = np.remainder(centers[hidden] + noise * rng.normal(size=(T, F)),
                       360.0)
    marks = np.array(sorted({g for s in range(len(hb) - 1) for g in
                             jax_rot.get_gates(s, list(hb), 15)}
                            | set(hb)))
    near = np.abs(ang[..., None] - marks).min(-1) < 0.01
    ang[near] += 0.05
    return np.minimum(ang, 359.5)


@pytest.mark.parametrize('kind', KINDS)
def test_dihedrals_match_jax(kind):
    port, jax_traj = peptide()
    q, rad = getattr(dihedrals, 'compute_' + kind)(port)
    jq, jrad = getattr(jax_dih, 'compute_' + kind)(jax_traj)
    np.testing.assert_array_equal(q, jq)
    assert rad.dtype == jrad.dtype == np.float32 and len(q)
    diff = np.remainder(rad.astype(float) - jrad + np.pi, 2 * np.pi) - np.pi
    assert np.abs(diff).max() < 1e-5
    deg, dq = rotamer.dihedral_angles(port, kind)
    jdeg, _ = jax_rot.dihedral_angles(jax_traj, kind)
    np.testing.assert_array_equal(dq, jq)
    assert deg.dtype == np.float64
    d = np.remainder(deg - jdeg + 180, 360) - 180
    assert np.abs(d).max() < np.rad2deg(1e-5)


def test_quartets_on_a_second_chain_and_unknown_kinds():
    top, jtop = Topology(), JaxTopology()
    for t in (top, jtop):
        for _ in range(2):
            chain = t.add_chain()
            for i, name in enumerate(('ALA', 'SER', 'LYS')):
                res = t.add_residue(name, chain, i + 1)
                for atom in (('N', 'CA', 'C', 'O', 'CB') + {
                        'ALA': (), 'SER': ('OG',),
                        'LYS': ('CG', 'CD', 'CE', 'NZ')}[name]):
                    t.add_atom(atom, atom[0], res)
    for kind in KINDS:
        np.testing.assert_array_equal(dihedrals.atom_quartets(top, kind),
                                      jax_dih.atom_quartets(jtop, kind))
    with pytest.raises(ValueError):
        dihedrals.atom_quartets(top, 'omega')
    assert rotamer.dihedral_angles(None, 'omega') == (None, None)


@pytest.mark.parametrize('hb', BOUNDARIES, ids=['phi', 'psi', 'chi'])
def test_host_rotamers_equal_jax(hb):
    """The port's _rotamers (walked from crossing to crossing) equals the
    JAX package's frame-by-frame loop, buffer widths 0 to 30."""
    rng = np.random.default_rng(len(hb))
    ang = basin_angles(rng, 1500, 4, hb)
    for bw in (0, 15, 30):
        for j in range(ang.shape[1]):
            np.testing.assert_array_equal(
                rotamer._rotamers(ang[:, j], hb, bw),
                jax_rot._rotamers(ang[:, j], hb, bw))


@pytest.mark.parametrize('chunk', [7, 1 << 16])
def test_scan_equals_jax(chunk):
    """The doubling scan (chunked, the state carried) against the JAX
    rotamers_device and the host _rotamers, column by column."""
    rng = np.random.default_rng(chunk)
    for hb in BOUNDARIES:
        ang = basin_angles(rng, 2000, 9, hb)
        got = rotamer.rotamers_device(ang, hb, 15, chunk=chunk)
        assert got.dtype == np.int16
        np.testing.assert_array_equal(
            got, jax_rot.rotamers_device(ang, hb, 15))
        for j in range(ang.shape[1]):
            np.testing.assert_array_equal(got[:, j],
                                          jax_rot._rotamers(ang[:, j], hb,
                                                            15))
        assert (np.diff(got, axis=0) != 0).sum() > 50


def test_planted_near_gate_angle_follows_the_float32_gates():
    """Basin 0 of [0, 120, 240, 360] is left at 135 degrees and above
    (its gates, with a 15-degree buffer). 135 - 1e-10 stays in it for the
    float64 host loop and rounds to the float32 gate 135 for
    rotamers_device and the port, which leave it."""
    hb = [0, 120, 240, 360]
    ang = np.full((6, 2), 60.0)
    ang[3:, 0] = 135.0 - 1e-10
    ang[3:, 1] = 134.99
    host = np.stack([jax_rot._rotamers(ang[:, j], hb, 15)
                     for j in range(2)], axis=1)
    dev = jax_rot.rotamers_device(ang, hb, 15)
    got = rotamer.rotamers_device(ang, hb, 15)
    assert host[3:, 0].tolist() == [0] * 3 and dev[3:, 0].tolist() == [1] * 3
    np.testing.assert_array_equal(got, dev)
    np.testing.assert_array_equal(got[:, 1], host[:, 1])
    np.testing.assert_array_equal(rotamer._rotamers(ang[:, 0], hb, 15),
                                  host[:, 0])


def test_all_rotamers_match_jax():
    port, jax_traj = peptide(n_res=7, n_frames=900, seed=5)
    states, inds, ns = rotamer.all_rotamers(port)
    jstates, jinds, jns = jax_rot.all_rotamers(jax_traj)
    assert states.dtype == np.int16 and ns.dtype == jns.dtype
    np.testing.assert_array_equal(inds, jinds)
    np.testing.assert_array_equal(ns, jns)
    np.testing.assert_array_equal(states, jstates)
    assert states.shape == (900, 6 + 6 + 28)
    assert (np.diff(states, axis=0) != 0).sum() > 100
    for family, jfamily in ((rotamer.psi_rotamers, jax_rot.psi_rotamers),
                            (rotamer.chi_rotamers, jax_rot.chi_rotamers)):
        for a, b in zip(family(port, buffer_width=25),
                        jfamily(jax_traj, buffer_width=25)):
            np.testing.assert_array_equal(a, b)


def test_gate_helpers_and_validation_match_jax():
    for hb in BOUNDARIES:
        for s in range(len(hb) - 1):
            assert rotamer.get_gates(s, hb, 15) == jax_rot.get_gates(s, hb,
                                                                     15)
            for a in np.linspace(0, 359.5, 73):
                assert rotamer.is_buffered_transition(s, a, hb, 15) == \
                    jax_rot.is_buffered_transition(s, a, hb, 15)
    for bad_hb, bw in (([0, 120, 240, 360], 120), ([10, 180, 360], 15)):
        with pytest.raises(DataInvalid):
            rotamer._rotamers(np.zeros(3), bad_hb, bw)
        with pytest.raises(DataInvalid):
            rotamer.rotamers_device(np.zeros((3, 2)), bad_hb, bw)
    empty = rotamer.rotamer_states(np.zeros((0, 3)), [0, 180, 360])
    assert empty.shape == (0, 3) and empty.dtype == torch.int16
