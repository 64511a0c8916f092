"""The port's host geometry modules held against the JAX package's on the
same numpy inputs: ``rmsf_calc`` (per atom, per residue, weighted), the
helix functions on an ideal alpha helix and ``ImproperlyConfigured``,
and LIGSITE pockets (grid, touches, ranked cells, clusters and
``get_pockets`` on a globule with a planted cavity), equal to JAX.
"""

import numpy as np
import pytest
import torch

from enspara_tpu.geometry import helix as jax_helix
from enspara_tpu.geometry import pockets as jax_pockets
from enspara_tpu.geometry import rmsf as jax_rmsf
from enspara_tpu.io import Topology as JaxTopology
from enspara_tpu.io import Trajectory as JaxTrajectory

from enspara_tpu_torch.exception import ImproperlyConfigured
from enspara_tpu_torch.geometry import helix, pockets, rmsf
from enspara_tpu_torch.io import Topology, Trajectory

from chip_smoke import (globule, globule_frames, helix_torsions, lys_peptide,
                        lys_topology, screw_axis)


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


def both(xyz, n_res):
    """The frames as a port and a JAX Trajectory of a poly-LYS topology."""
    return (Trajectory(xyz, lys_topology(Topology, n_res)),
            JaxTrajectory(xyz, lys_topology(JaxTopology, n_res)))


@pytest.mark.parametrize('kw', [dict(per_residue=False), dict(),
                                dict(populations='dirichlet', ref_frame=3,
                                     atom_indices=np.arange(0, 90, 2))])
def test_rmsf_matches_jax(kw):
    n_res = 10
    xyz, _, _ = globule_frames(globule(n_res, seed=4), 12, seed=5,
                               planted=(1, 2, 0.4))
    port, jax = both(xyz, n_res)
    if kw.get('populations') == 'dirichlet':
        kw = dict(kw, populations=np.random.default_rng(1).dirichlet(
            np.ones(12)))
    got = rmsf.rmsf_calc(port, **kw)
    want = jax_rmsf.rmsf_calc(jax, **kw)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)
    if got.size == n_res:
        np.testing.assert_array_equal(
            rmsf._bfactors_from_rmsfs(port, want),
            jax_rmsf._bfactors_from_rmsfs(jax, want))


def test_helix_functions_match_jax():
    n_res = 20
    port, jax = both(lys_peptide(np.repeat(helix_torsions(n_res), 3, 0)
                                 + np.random.default_rng(2).normal(
                                     0, 2, (3, 6 * n_res)).astype(np.float32),
                                 'cpu'), n_res)
    got = helix.calculate_summary_helix_vectors(port, [4, 8, 12],
                                                helix_start=2, helix_end=18)
    want = jax_helix.calculate_summary_helix_vectors(
        jax, [4, 8, 12], helix_start=2, helix_end=18)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    vec, cen = helix.calculate_piecewise_helix_vectors(
        port, helix_resnums=np.arange(3, 15)[::-1])
    jvec, jcen = jax_helix.calculate_piecewise_helix_vectors(
        jax, helix_resnums=np.arange(3, 15)[::-1])
    np.testing.assert_array_equal(vec, jvec)
    np.testing.assert_array_equal(cen, jcen)
    ref, cross = got[1][:, 0], got[2][:, 0]
    for deg in (True, False):
        for g, w in zip(helix.angles_from_plane_projection(ref, ref[0],
                                                           cross[0], deg),
                        jax_helix.angles_from_plane_projection(
                            ref, ref[0], cross[0], deg)):
            np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(helix.angles_from_vecs(ref, to=1),
                                  jax_helix.angles_from_vecs(ref, to=1))
    with pytest.raises(ImproperlyConfigured, match='helix_start'):
        helix.calculate_piecewise_helix_vectors(port, helix_start=2)


def test_ideal_helix_axis_near_its_screw_axis():
    """On an ideal alpha helix the windowed axis (the reference's
    estimator, 4-residue windows over a 3.6-residue turn) lies within
    0.02 rad of the exact screw axis."""
    n_res = 20
    xyz = lys_peptide(helix_torsions(n_res), 'cpu')
    port, _ = both(xyz, n_res)
    axis, _ = helix.calculate_piecewise_helix_vectors(port, helix_start=1,
                                                      helix_end=n_res)
    true = screw_axis(xyz[0].astype(np.float64), n_res)
    a = axis[0].astype(np.float64)
    assert np.arctan2(np.linalg.norm(np.cross(a, true)), a @ true) < 0.02


def cavity(n_res=40, radius=0.5, n_frames=2):
    """Frames of a globule with its atoms inside a sphere about the center
    removed, as a port and a JAX Trajectory."""
    base = globule(n_res, seed=6)
    keep = np.flatnonzero(np.linalg.norm(base, axis=1) > radius)
    xyz = (base[None, keep] + np.random.default_rng(7).normal(
        0, 0.02, (n_frames, len(keep), 3))).astype(np.float32)
    tops = [lys_topology(cls, n_res).subset(keep)
            for cls in (Topology, JaxTopology)]
    return Trajectory(xyz, tops[0]), JaxTrajectory(xyz, tops[1])


def test_pocket_cells_and_clusters_match_jax():
    port, jax = cavity(n_frames=1)
    grid = pockets.create_grid(port, 0.1, padding=1)
    np.testing.assert_array_equal(grid, jax_pockets.create_grid(jax, 0.1,
                                                                padding=1))
    np.testing.assert_array_equal(
        pockets.determine_touches_protein(port, grid, 0.14),
        jax_pockets.determine_touches_protein(jax, grid, 0.14))
    cells = pockets.get_pocket_cells(port, probe_radius=0.14, min_rank=5)
    np.testing.assert_array_equal(
        cells, jax_pockets.get_pocket_cells(jax, probe_radius=0.14,
                                            min_rank=5))
    assert len(cells) > 10
    for size in (0, 3):
        got = pockets.cluster_pocket_cells(cells, min_cluster_size=size)
        want = jax_pockets.cluster_pocket_cells(cells,
                                                min_cluster_size=size)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    for g, w in zip(pockets.cluster_pocket_cells(np.zeros((0, 3))),
                    jax_pockets.cluster_pocket_cells(np.zeros((0, 3)))):
        assert g.size == w.size == 0
    assert pockets.xyz_to_mdtraj is pockets.xyz_to_traj
    assert pockets.xyz_to_traj(np.zeros((0, 3))) is None


def test_get_pockets_finds_the_planted_cavity_as_jax_does():
    port, jax = cavity()
    got = pockets.get_pockets(port, n_procs=2)
    want = jax_pockets.get_pockets(jax, n_procs=2)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.xyz, w.xyz)
        assert ([a.residue.index for a in g.top.atoms]
                == [a.residue.index for a in w.top.atoms])
        first = g.xyz[0][[a.index for a in g.top.atoms
                          if a.residue.index == 0]]
        assert np.linalg.norm(first.mean(0)) < 0.2
    helper = pockets._get_pockets_helper(port[0], 0.1, 0.14, 5, 0)
    np.testing.assert_array_equal(helper.xyz, got[0].xyz)
