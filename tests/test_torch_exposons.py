"""The port's exposons (``enspara_tpu_torch.info_theory.exposons``) held
against the JAX package's on the CPU: its own affinity propagation
against sklearn's (through the JAX ``exposons_from_sasas`` and directly),
labels equal and the MI within 1e-12, on seeded MI matrices, one that
does not converge, equal similarities and a single sample; the
condensation bit for bit with its ``DataInvalid`` paths; ``exposons``
end to end on a small globule; and the reference names of the modules
this slice ports (``tests/test_api_surface_parity.py :: SURFACE``).
"""

import importlib
import warnings

import numpy as np
import pytest
import torch
from sklearn.cluster import AffinityPropagation
from sklearn.exceptions import ConvergenceWarning as SkConvergenceWarning

from enspara_tpu.info_theory import exposons as jax_exposons
from enspara_tpu.io import Topology as JaxTopology
from enspara_tpu.io import Trajectory as JaxTrajectory

from enspara_tpu_torch import info_theory
from enspara_tpu_torch.exception import ConvergenceWarning, DataInvalid
from enspara_tpu_torch.info_theory import exposons
from enspara_tpu_torch.info_theory._affinity import affinity_propagation
from enspara_tpu_torch.io import Topology, Trajectory

from chip_smoke import globule, globule_frames, lys_topology
from test_api_surface_parity import SURFACE


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


def planted_sasas(seed, n_frames=300, n_res=40, n_groups=4):
    """Side-chain SASAs whose exposure switches by hidden group labels,
    with noise residues, float32 (n_frames, n_res)."""
    rng = np.random.default_rng(seed)
    group = rng.integers(0, n_groups + 1, n_res)
    hidden = rng.random((n_frames, n_groups + 1)) < 0.5
    hidden[:, n_groups] = rng.random(n_frames) < 0.5
    flip = rng.random((n_frames, n_res)) < 0.1
    exposed = hidden[:, group] ^ flip
    return np.where(exposed, rng.uniform(0.05, 1.0, exposed.shape),
                    rng.uniform(0.0, 0.015, exposed.shape)).astype(
                        np.float32)


@pytest.mark.parametrize('seed,damping', [(0, 0.9), (1, 0.9), (2, 0.5),
                                          (3, 0.7)])
def test_exposons_from_sasas_match_jax(seed, damping):
    sasas = planted_sasas(seed)
    w = np.random.default_rng(seed).random(len(sasas))
    mi, labels = exposons.exposons_from_sasas(sasas, damping, w, 0.02)
    jmi, jlabels = jax_exposons.exposons_from_sasas(sasas, damping, w, 0.02)
    assert np.abs(mi - jmi).max() <= 1e-12
    np.testing.assert_array_equal(labels, jlabels)
    assert labels.max() >= 1


def test_weighted_joint_does_not_depend_on_the_order_of_frames():
    """The card sums in another order than the CPU: the joint
    distribution behind the exposon MI is the same bits whatever the
    order, and within 1e-13 of a float64 einsum."""
    from enspara_tpu_torch.info_theory import mutual_info
    rng = np.random.default_rng(5)
    X = rng.random((3000, 40)) < 0.3
    X[:, :5] = True
    w = rng.random(3000)
    w /= w.sum()
    P = mutual_info.weighted_joint(X, w, 2)
    perm = rng.permutation(3000)
    np.testing.assert_array_equal(
        mutual_info.weighted_joint(X[perm], w[perm], 2), P)
    oh = np.stack([X == u for u in range(2)], -1)
    assert np.abs(P - np.einsum('tiu,t,tjv->uvij', oh, w, oh)).max() <= 1e-13


def sklearn_labels(S, **kw):
    return AffinityPropagation(affinity='precomputed', random_state=0,
                               **kw).fit_predict(S)


@pytest.mark.parametrize('case', ['no_exemplar', 'max_iter', 'equal',
                                  'single'])
def test_affinity_propagation_edge_cases_match_sklearn(case):
    rng = np.random.default_rng(4)
    X = rng.normal(size=(30, 3))
    S = -((X[:, None] - X[None]) ** 2).sum(-1)
    kw = dict(damping=0.5, preference=None, max_iter=200)
    if case == 'no_exemplar':
        # one sweep: no exemplar yet, labels all -1
        kw['max_iter'] = 1
    elif case == 'max_iter':
        # stops at max_iter with exemplars: labels, and the warning
        kw['max_iter'] = 20
    elif case == 'equal':
        S = np.ones((6, 6))
        kw['preference'] = 2.0
    else:
        S = np.array([[0.3]])
        kw['preference'] = 0
    with warnings.catch_warnings(record=True) as mine:
        warnings.simplefilter('always')
        got = affinity_propagation(S, **kw)
    with warnings.catch_warnings(record=True) as theirs:
        warnings.simplefilter('always')
        want = sklearn_labels(S, **kw)
    np.testing.assert_array_equal(got, want)
    assert (any(issubclass(w.category, ConvergenceWarning) for w in mine)
            == any(issubclass(w.category, SkConvergenceWarning)
                   for w in theirs))
    if case == 'no_exemplar':
        assert (got == -1).all()
    if case == 'equal':
        np.testing.assert_array_equal(got, np.arange(6))


def test_affinity_propagation_rejects_what_sklearn_rejects():
    with pytest.raises(ValueError, match='square'):
        affinity_propagation(np.zeros((3, 4)))
    with pytest.raises(ValueError, match='NaN'):
        affinity_propagation(np.full((3, 3), np.nan))
    with pytest.raises(ValueError, match='damping'):
        affinity_propagation(np.eye(3), damping=1.0)


def test_condensation_matches_jax_bit_for_bit():
    n_res = 6
    top, jtop = lys_topology(Topology, n_res), lys_topology(JaxTopology,
                                                            n_res)
    # a C-terminal carboxylate oxygen: backbone, not side chain
    for t in (top, jtop):
        t.add_atom('OC1', 'O', list(t.residues)[-1])
    rng = np.random.default_rng(7)
    atomic = rng.random((50, 9 * n_res + 1)).astype(np.float32)
    got = exposons.condense_sidechain_sasas(atomic, top)
    np.testing.assert_array_equal(
        got, jax_exposons.condense_sidechain_sasas(atomic, jtop))
    assert got.dtype == np.float32 and got.shape == (50, n_res)
    assert [ids.tolist() for ids in exposons.get_sidechain_atom_ids(top)] \
        == [ids.tolist() for ids in jax_exposons.get_sidechain_atom_ids(jtop)]
    with pytest.raises(DataInvalid, match='one SASA column per'):
        exposons.condense_sidechain_sasas(atomic[:, :-1], top)
    with pytest.raises(DataInvalid, match='more than one residue'):
        exposons.condense_sidechain_sasas(atomic[:, :9],
                                          lys_topology(Topology, 1))


def test_exposons_end_to_end_match_jax():
    n_res = 16
    xyz, _, _ = globule_frames(globule(n_res, seed=2), 16, seed=3,
                               planted=(2, 3, 0.5))
    port = Trajectory(xyz, lys_topology(Topology, n_res))
    jax = JaxTrajectory(xyz, lys_topology(JaxTopology, n_res))
    mi, labels = exposons.exposons(port, 0.9)
    jmi, jlabels = jax_exposons.exposons(jax, 0.9)
    assert mi.shape == (n_res, n_res)
    assert np.abs(mi - jmi).max() <= 1e-12
    np.testing.assert_array_equal(labels, jlabels)


def test_ported_modules_export_the_reference_names():
    for ref in ('info_theory/exposons.py', 'geometry/pockets.py',
                'geometry/rmsf.py', 'geometry/dyes_from_expt_dist.py'):
        jax_name, names = SURFACE[ref]
        mod = importlib.import_module(
            jax_name.replace('enspara_tpu.', 'enspara_tpu_torch.', 1))
        missing = [n for n in names.split() if not hasattr(mod, n)]
        assert not missing, (ref, missing)
    assert info_theory.compute_exposons is exposons.exposons
    assert info_theory.exposons_from_sasas is exposons.exposons_from_sasas
    geometry = importlib.import_module('enspara_tpu_torch.geometry')
    for name in ('sasa', 'rmsf', 'helix', 'pockets', 'shrake_rupley',
                 'rmsf_calc', 'get_pockets', 'dyes_from_expt_dist'):
        assert hasattr(geometry, name), name
    for name in ('explicit_r0_calc', 'dye_lifetimes'):
        mod = getattr(geometry, name)
        assert mod is importlib.import_module(
            'enspara_tpu_torch.geometry.' + name)
        ref = importlib.import_module('enspara_tpu.geometry.' + name)
        assert set(mod.__all__) == set(ref.__all__)
