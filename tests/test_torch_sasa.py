"""The port's Shrake-Rupley SASA (``enspara_tpu_torch.geometry.sasa``) held
against the JAX package's on the same numpy inputs, on the CPU: the dense,
'auto' and fixed-K neighbor-list paths at probes 0.14 and 0.28 nm, the
per-residue mode, the neighbor list against the dense path, a 3-shard CPU
mesh, and the float64 host oracle. Where the two packages may round a
squared distance differently, the inputs keep every shell point farther
than 1e-5 (relative) from its cover boundary, and the test asserts that
margin in float64. Also the deprecated ``util.array`` alias.
"""

import importlib
import warnings

import numpy as np
import pytest
import torch

from enspara_tpu.geometry import sasa as jax_sasa
from enspara_tpu.io import Topology as JaxTopology
from enspara_tpu.io import Trajectory as JaxTrajectory

from enspara_tpu_torch.geometry import sasa
from enspara_tpu_torch.io import Topology, Trajectory
from enspara_tpu_torch.parallel import FrameMesh

MARGIN = 1e-5
N_POINTS = 100


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


def cloud(seed=3, n_frames=3, n_atoms=120, box=2.2):
    """Random atoms in a box (seeded) with vdW radii of N, O, C and S."""
    rng = np.random.default_rng(seed)
    xyz = (rng.random((n_frames, n_atoms, 3)) * box).astype(np.float32)
    radii = rng.choice([0.152, 0.155, 0.17, 0.18], n_atoms)
    return xyz, radii.astype(np.float32)


def cover_margin(xyz, radii, probe, n_points):
    """The least relative distance, over every frame, atom and shell
    point, of the deciding squared distance from its cover boundary:
    ``|min_j (d2_j - R_j^2) / R_j^2|``, the atom itself left out; float64."""
    pts = sasa.sphere_points(n_points).astype(np.float64)
    R = np.asarray(radii, np.float64) + probe
    out = np.inf
    for X in np.asarray(xyz, np.float64):
        shell = X[:, None] + R[:, None, None] * pts
        rel = (((shell[:, :, None] - X[None, None]) ** 2).sum(-1)
               - R ** 2) / R ** 2
        rel[np.arange(len(X)), :, np.arange(len(X))] = np.inf
        out = min(out, float(np.abs(rel.min(-1)).min()))
    return out


@pytest.mark.parametrize('probe', [0.14, 0.28])
@pytest.mark.parametrize('n_neighbors', [None, 'auto', 24])
def test_shrake_rupley_matches_jax(probe, n_neighbors):
    xyz, radii = cloud()
    assert cover_margin(xyz, radii, probe, N_POINTS) > MARGIN
    kw = dict(probe_radius=probe, n_sphere_points=N_POINTS,
              n_neighbors=n_neighbors)
    got = sasa.shrake_rupley((xyz, radii), **kw)
    want = np.asarray(jax_sasa.shrake_rupley((xyz, radii), **kw))
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-6
    # the same accessible points: areas differ by rounding only
    area = 4 * np.pi * (radii + probe) ** 2 / N_POINTS
    assert np.array_equal(np.rint(got / area), np.rint(want / area))


@pytest.mark.parametrize('probe', [0.14, 0.28])
def test_neighbor_list_equals_the_dense_path(probe):
    xyz, radii = cloud(seed=5, n_frames=4)
    dense = sasa.shrake_rupley((xyz, radii), probe_radius=probe,
                               n_sphere_points=N_POINTS, n_neighbors=None)
    auto = sasa.shrake_rupley((xyz, radii), probe_radius=probe,
                              n_sphere_points=N_POINTS, atom_block=16)
    need = int(sasa._max_neighbor_count(
        torch.as_tensor(xyz), torch.as_tensor(radii + np.float32(probe)),
        16))
    assert sasa._pick_n_neighbors(need, xyz.shape[1]) is not None
    assert np.array_equal(auto, dense)


def test_residue_mode_matches_jax():
    xyz, _ = cloud(seed=3, n_frames=2, n_atoms=120)
    tops = []
    for cls in (Topology, JaxTopology):
        top = cls()
        chain = top.add_chain()
        for r in range(30):
            res = top.add_residue('ALA', chain, r + 1)
            for name in ('N', 'CA', 'C', 'O'):
                top.add_atom(name, name[0], res)
        tops.append(top)
    radii = sasa._radii_from_top(tops[0])
    assert cover_margin(xyz, radii, 0.14, N_POINTS) > MARGIN
    got = sasa.shrake_rupley(Trajectory(xyz, tops[0]), mode='residue',
                             n_sphere_points=N_POINTS)
    want = jax_sasa.shrake_rupley(JaxTrajectory(xyz, tops[1]),
                                  mode='residue', n_sphere_points=N_POINTS)
    assert got.shape == (2, 30)
    assert np.abs(got - want).max() <= 4e-6
    with pytest.raises(ValueError, match='topology'):
        sasa.shrake_rupley((xyz, radii), mode='residue')


def test_mesh_equals_one_device():
    """7 frames over 3 CPU shards (a padded last shard) equal one device,
    bit for bit; the padding frames do not enter the neighbor count."""
    xyz, radii = cloud(seed=6, n_frames=7)
    one = sasa.shrake_rupley((xyz, radii), n_sphere_points=N_POINTS)
    mesh = sasa.shrake_rupley((xyz, radii), n_sphere_points=N_POINTS,
                              mesh=FrameMesh(['cpu'] * 3))
    assert mesh.shape == (7, 120) and np.array_equal(mesh, one)
    with pytest.raises(ValueError, match='not both'):
        sasa.shrake_rupley((xyz, radii), mesh=FrameMesh(['cpu']),
                           device='cpu')


def test_tensor_input_and_host_oracle_match_jax():
    xyz, radii = cloud(seed=3, n_frames=2, n_atoms=40, box=1.2)
    np.testing.assert_array_equal(sasa.sphere_points(960),
                                  jax_sasa.sphere_points(960))
    oracle = sasa.shrake_rupley_np(xyz, radii, 0.14, N_POINTS)
    np.testing.assert_array_equal(
        oracle, jax_sasa.shrake_rupley_np(xyz, radii, 0.14, N_POINTS))
    got = sasa.shrake_rupley((torch.as_tensor(xyz), radii),
                             n_sphere_points=N_POINTS)
    assert np.abs(got - oracle).max() <= 1e-5


def test_util_array_is_a_deprecated_alias_of_ra():
    import enspara_tpu_torch.ra.ra as ra_mod
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        mod = importlib.reload(
            importlib.import_module('enspara_tpu_torch.util.array'))
    assert any(issubclass(w.category, PendingDeprecationWarning)
               for w in caught)
    for name in ('RaggedArray', 'save', 'load', 'where', 'zeros_like',
                 'partition_list', 'partition_indices'):
        assert getattr(mod, name) is getattr(ra_mod, name)
