"""The port's photon Monte Carlo (``geometry/dye_lifetimes.py``) held
against the JAX package's on the CPU, on the synthetic dye library of
``chip_smoke.explicit_dye_library`` in a temporary directory: the pruned
dye MSMs, the host per-photon walk and the static and isotropic
treatments bit for bit on a seed, the lockstep Monte Carlo in its
statistics (against the JAX lockstep at n = 500 and against the exact
absorbing chain of ``chip_smoke.exact_outcomes``), its alias tables, the
burst sampling, the protein-MSM rebuild and the fits.
"""

import os

import numpy as np
import pytest
import torch

from enspara_tpu import io as jax_io
from enspara_tpu.exception import DataInvalid as JaxDataInvalid
from enspara_tpu.geometry import dye_lifetimes as jax_dl
from enspara_tpu.geometry import explicit_r0_calc as jax_r0c
from enspara_tpu.io import Topology as JaxTopology
from enspara_tpu.io import Trajectory as JaxTrajectory
from enspara_tpu.msm import builders as jax_builders

from enspara_tpu_torch import io as port_io
from enspara_tpu_torch.exception import DataInvalid, ImproperlyConfigured
from enspara_tpu_torch.geometry import dye_lifetimes as dl
from enspara_tpu_torch.geometry import explicit_r0_calc as r0c
from enspara_tpu_torch.io import Topology, Trajectory
from enspara_tpu_torch.msm import builders

from chip_smoke import (exact_outcomes, explicit_dye_library, globule,
                        globule_frames, label_sites, lys_topology)

N_RES, N_DYE, N_CENTERS, LAG = 30, 40, 3, 0.002
# the lag of the statistical checks: ~100 steps a photon, not ~1,000
MC_LAG = 0.02


@pytest.fixture(scope='module')
def library(tmp_path_factory):
    path = str(tmp_path_factory.mktemp('dyes'))
    return path, explicit_dye_library(path, 0, n_frames=N_DYE)


@pytest.fixture(autouse=True)
def _cpu_platform(monkeypatch, library):
    """Host inputs run on the CPU in these tests: with no device named,
    the port sends them to the card. Both packages read the synthetic
    library. Torch runs on one thread: the tier-1 run puts several test
    workers on one host's cores."""
    monkeypatch.setenv('ENSPARA_TPU_PLATFORM', 'cpu')
    monkeypatch.setenv('ENSPARA_TPU_DYE_DIR', library[0])
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def system(library):
    """Both packages' inputs: proteins, dye trajectories and counts, label
    pairs, dye names."""
    xyz, _, groups = globule_frames(globule(N_RES, seed=8), N_CENTERS,
                                    seed=9, planted=(1, 2, 0.4))
    port = Trajectory(xyz, lys_topology(Topology, N_RES))
    jax = JaxTrajectory(xyz, lys_topology(JaxTopology, N_RES))
    (dn, ddcd, dpdb, dc), (an, adcd, apdb, ac) = library[1].values()
    return dict(
        port=port, jax=jax, names=[dn, an],
        pairs=label_sites(port, 2, np.concatenate(groups)),
        port_dyes=(port_io.load(ddcd, top=dpdb),
                   port_io.load(adcd, top=apdb)),
        jax_dyes=(jax_io.load(ddcd, top=dpdb), jax_io.load(adcd, top=apdb)),
        counts=(np.load(dc), np.load(ac)))


def free_pair(s, n=None, offset=(7.5, 0.0, 0.0)):
    """Dye MSMs with no protein (every state kept) and the acceptor's
    conformations moved ``offset`` nm away, so that no outcome dominates:
    (port centers, JAX centers, tprobs, eqs) for donor and acceptor."""
    out = []
    for k in range(2):
        pd_, jd = s['port_dyes'][k], s['jax_dyes'][k]
        if n is not None:
            pd_, jd = pd_[:n], jd[:n]
        pd_, jd = pd_.copy(), jd.copy()
        if k == 1:
            pd_.xyz = pd_.xyz + np.float32(offset)
            jd.xyz = pd_.xyz.copy()
        c = s['counts'][k]
        c = c[:len(pd_), :len(pd_)]
        _, T, eq = builders.normalize(c)
        out.append((pd_, jd, T, eq))
    return out


def test_make_dye_msm_equals_jax(library):
    s = system(library)
    lib, jlib = r0c.load_library(), jax_r0c.load_library()
    for k in range(2):
        for c in range(N_CENTERS):
            res = int(s['pairs'][0, k])
            ours = dl.make_dye_msm(s['port_dyes'][k], s['counts'][k],
                                   s['port'][c], res, s['names'][k], lib,
                                   center_n=c)
            ref = jax_dl.make_dye_msm(s['jax_dyes'][k], s['counts'][k],
                                      s['jax'][c], res, s['names'][k], jlib,
                                      center_n=c)
            np.testing.assert_array_equal(ours[2], ref[2])
            np.testing.assert_array_equal(ours[0], ref[0])
            np.testing.assert_allclose(ours[1], ref[1], rtol=1e-12,
                                       atol=1e-16)
            gone = np.setdiff1d(np.arange(N_DYE), ours[2])
            assert len(gone) and (ours[1][gone] == 0).all()


def test_eq_probs_of_a_pruned_chain_take_the_fast_path(library):
    """A reversible chain with empty states (zero row and column) gets
    pi = 0 there and the spanning-tree pi elsewhere, within the JAX
    package's eigenvector's rounding (1e-11 relative); one live state gets
    pi = 1; a zero row with incoming counts takes no fast path."""
    s = system(library)
    gone = np.arange(0, N_DYE, 3)
    pruned = r0c.remove_bad_states(gone, s['counts'][0])
    from enspara_tpu_torch.msm import transition_matrices as tm
    _, T, _ = builders.normalize(pruned, calculate_eq_probs=False)
    pi = tm._eq_probs_with_empty_states(T)
    ref = jax_builders.normalize(pruned)[2]
    assert pi is not None and (pi[gone] == 0).all()
    np.testing.assert_allclose(pi, ref, rtol=1e-11, atol=1e-16)
    one = r0c.remove_bad_states(np.arange(1, N_DYE), s['counts'][0])
    np.testing.assert_array_equal(builders.normalize(one)[2],
                                  np.eye(N_DYE)[0])
    leaky = T.copy()
    leaky[gone[0]] = 0
    leaky[1, gone[0]] = 0.5
    assert tm._eq_probs_with_empty_states(leaky) is None


@pytest.mark.parametrize('treatment', ['Monte-carlo', 'static',
                                       'isotropic'])
def test_host_treatments_equal_jax_bit_for_bit(library, tmp_path,
                                               treatment):
    s = system(library)
    res = s['pairs'][0]
    kw = dict(n_samples=25, dye_treatment=treatment, rng_seed=3,
              save_dye_msm=True, save_k2_r2=True,
              save_dye_trj=treatment == 'Monte-carlo')
    for c in range(2):
        for d in ('port', 'jax'):
            os.makedirs(tmp_path / d, exist_ok=True)
        ours = dl.calc_lifetimes(
            (s['port'][c], c), *s['port_dyes'][:1], s['counts'][0],
            s['port_dyes'][1], s['counts'][1], res, s['names'], LAG,
            outdir=str(tmp_path / 'port'), **kw)
        ref = jax_dl.calc_lifetimes(
            (s['jax'][c], c), *s['jax_dyes'][:1], s['counts'][0],
            s['jax_dyes'][1], s['counts'][1], res, s['names'], LAG,
            outdir=str(tmp_path / 'jax'), **kw)
        np.testing.assert_array_equal(np.asarray(ours[0]),
                                      np.asarray(ref[0]))
        np.testing.assert_array_equal(np.asarray(ours[1]),
                                      np.asarray(ref[1]))
        assert len(ours[0]) == 25
    files = sorted(os.listdir(tmp_path / 'jax'))
    assert files == sorted(os.listdir(tmp_path / 'port')) and files
    for f in files:
        a = np.load(tmp_path / 'port' / f, allow_pickle=True)
        b = np.load(tmp_path / 'jax' / f, allow_pickle=True)
        if f.endswith('eqs.npy'):
            # equilibrium probabilities: the port's spanning-tree pi
            # against the JAX package's eigenvector
            np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-16)
        elif a.dtype == object:
            assert all(np.array_equal(x, y) for x, y in zip(a, b)), f
        else:
            np.testing.assert_array_equal(a, b)


def test_lockstep_mc_matches_the_jax_lockstep(library):
    """n = 500 each: mean lifetime within 15%, outcome fractions within 10
    points, as tests/test_smfret.py holds the JAX lockstep to the host
    walk."""
    s = system(library)
    (pd_, jd, dT, deq), (pa, ja, aT, aeq) = free_pair(s)
    params = r0c.get_dye_overlap(*s['names'])
    lib = r0c.load_library()
    steps, out = dl.resolve_excitations_device(
        *s['names'], dT, aT, deq, aeq, pd_, pa, params, MC_LAG, lib,
        n_samples=500, rng_seed=7)
    j_steps, j_out = jax_dl.resolve_excitations_device(
        *s['names'], dT, aT, deq, aeq, jd, ja, params, MC_LAG,
        jax_r0c.load_library(), n_samples=500, rng_seed=7)
    assert steps.shape == (500,) and steps.dtype == np.int32
    assert out.dtype == j_out.dtype and not (out == 'excited').any()
    assert abs(steps.mean() - j_steps.mean()) < 0.15 * j_steps.mean()
    fractions = []
    for ch in ('radiative', 'non_radiative', 'energy_transfer'):
        assert abs((out == ch).mean() - (j_out == ch).mean()) < 0.10, ch
        fractions.append((out == ch).mean())
    # no outcome dominates on this pair
    assert max(fractions) < 0.9 and min(fractions) > 0.005


def test_lockstep_mc_matches_the_exact_chain(library):
    """A 5 x 5 dye pair, 20,000 photons: outcome fractions and the mean
    step count within 5 standard errors of the exact absorbing chain."""
    s = system(library)
    (pd_, _, dT, deq), (pa, _, aT, aeq) = free_pair(s, n=5)
    params = r0c.get_dye_overlap(*s['names'])
    lib = r0c.load_library()
    probs = dl._pair_rate_tables(*s['names'], pd_, pa, params, MC_LAG, lib)
    frac, mean, _ = exact_outcomes(probs, dT, aT, deq, aeq, 'cpu')
    n = 20_000
    steps, out = dl.resolve_excitations_device(
        *s['names'], dT, aT, deq, aeq, pd_, pa, params, MC_LAG, lib,
        n_samples=n, generator=torch.Generator().manual_seed(11))
    for c, ch in enumerate(('radiative', 'non_radiative',
                            'energy_transfer')):
        f = (out == ch).mean()
        assert abs(f - frac[c]) <= 5 * np.sqrt(frac[c] * (1 - frac[c]) / n)
    assert abs(steps.mean() - mean) <= 5 * steps.std() / np.sqrt(n)
    assert min(frac) > 0.01


def test_alias_tables_reproduce_their_rows():
    rng = np.random.default_rng(0)
    P = rng.random((300, 37)) * (rng.random((300, 37)) < 0.3)
    P[5] = 0
    P[7] = 0
    P[7, 3] = 2.0
    P[9] = 1.0
    prob, alias = dl._alias_tables(torch.as_tensor(P))
    prob, alias = prob.numpy(), alias.numpy()
    n = P.shape[1]
    got = prob / n
    for r in range(len(P)):
        np.add.at(got[r], alias[r], (1 - prob[r]) / n)
    mass = P.sum(1, keepdims=True)
    live = mass[:, 0] > 0
    assert np.abs(got[live] - P[live] / mass[live]).max() < 1e-14
    assert (prob >= 0).all() and (prob <= 1).all()
    np.testing.assert_array_equal(prob[5], 1.0)
    x = torch.tensor([0.0, 0.5, 0.999999])
    row = torch.tensor([7, 7, 7])
    assert (dl._draw(torch.as_tensor(prob), torch.as_tensor(alias), row, x,
                     n) == 3).all()


def test_device_treatment_through_calc_lifetimes(library, tmp_path):
    s = system(library)
    args = ((s['port'][0], 0), s['port_dyes'][0], s['counts'][0],
            s['port_dyes'][1], s['counts'][1], s['pairs'][0], s['names'],
            LAG)
    with pytest.raises(ImproperlyConfigured, match='save_dye_trj'):
        dl.calc_lifetimes(*args, dye_treatment='Monte-carlo-device',
                          save_dye_trj=True)
    with pytest.raises(ValueError, match='Unknown dye_treatment'):
        dl.calc_lifetimes(*args, dye_treatment='other')
    one = dl.calc_lifetimes(*args, dye_treatment='Monte-carlo-device',
                            n_samples=64, rng_seed=4)
    assert one[0].dtype == float and one[0].shape == (64,)
    assert set(one[1]) <= {'radiative', 'non_radiative', 'energy_transfer'}
    np.testing.assert_allclose(one[0] / LAG, np.round(one[0] / LAG))
    # every center in one lockstep loop: the same photons a center
    events, info = dl._calc_lifetimes_all(
        s['port'], s['port_dyes'][0], s['counts'][0], s['port_dyes'][1],
        s['counts'][1], s['pairs'][0], s['names'], LAG, n_samples=64,
        dye_treatment='Monte-carlo-device', rng_seed=4, n_procs=2)
    assert len(events) == N_CENTERS
    assert all(len(e[0]) == 64 and len(e[1]) == 64 for e in events)
    assert info['lockstep_steps'] >= max(e[0].max() for e in events) / LAG
    assert info['photon_steps'] == round(sum(e[0].sum() for e in events)
                                         / LAG)


def test_guaranteed_photons_equal_jax(library):
    rng = np.random.default_rng(1)
    n = 6
    C = rng.integers(1, 20, (n, n))
    C = C + C.T
    _, T, eqs = builders.normalize(C)
    lifetimes = np.array([rng.random(8) for _ in range(n)], dtype=object)
    outcomes = np.array([rng.choice(['radiative', 'non_radiative',
                                     'energy_transfer'], 8)
                         for _ in range(n)], dtype=object)
    frames = np.cumsum(rng.integers(1, 4, 30))
    ours = dl.sample_lifetimes_guarenteed_photon(frames, T, eqs, lifetimes,
                                                 outcomes, rng_seed=9)
    ref = jax_dl.sample_lifetimes_guarenteed_photon(
        frames, T, eqs, lifetimes, outcomes, rng_seed=9)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)
    outcomes[ours[2][0]] = np.array(['non_radiative'] * 8, dtype=object)
    for mod, err in ((dl, DataInvalid), (jax_dl, JaxDataInvalid)):
        with pytest.raises(err, match='only non-radiative'):
            mod.sample_lifetimes_guarenteed_photon(
                frames, T, eqs, lifetimes, outcomes, rng_seed=9)


def test_burst_mc_and_protein_msm_equal_jax(library, tmp_path):
    rng = np.random.default_rng(2)
    n = 8
    C = rng.integers(1, 30, (n, n))
    C = C + C.T
    eqs = C.sum(1) / C.sum()
    events = [(rng.random(20) * 5, rng.choice(
        ['radiative', 'non_radiative', 'energy_transfer'], 20))
        for _ in range(n)]
    events[3] = ([], [])
    events = np.array(events, dtype='O')
    res, names = (4, 9), ['SimFluor 488D C1R', 'SimFluor 594A C1R']
    frames = [np.cumsum(rng.integers(1, 4, k)) for k in (9, 14, 5)]
    out = {}
    for tag, mod in (('port', dl), ('jax', jax_dl)):
        d = tmp_path / tag
        os.makedirs(d / 'MSMs')
        np.save(d / 'events-4-9.npy', events)
        mod.remake_msms(res, C, str(d), names, eqs, str(d))
        out[tag] = mod.run_mc(res, C, names, frames, str(d), str(d), 7,
                              save_burst_frames=True, rng_seed=5)
    for a, b in zip(out['port'], out['jax']):
        if a.dtype == object:
            assert all(np.array_equal(x, y) for x, y in zip(a, b))
        else:
            np.testing.assert_array_equal(a, b)
    for sub in ('MSMs', 'FEs', 'Lifetimes', 'protein-trajs'):
        assert (sorted(os.listdir(tmp_path / 'port' / sub))
                == sorted(os.listdir(tmp_path / 'jax' / sub)))
    for f in os.listdir(tmp_path / 'jax' / 'MSMs'):
        np.testing.assert_allclose(
            np.load(tmp_path / 'port' / 'MSMs' / f),
            np.load(tmp_path / 'jax' / 'MSMs' / f), rtol=1e-12, atol=1e-16)
    np.testing.assert_array_equal(dl.calc_per_state_FE(events),
                                  jax_dl.calc_per_state_FE(events))


def test_a_split_protein_msm_fails_as_in_the_jax_package(tmp_path):
    """Open fault, shared with the JAX package: labels that no center of
    a bridge can take split the protein MSM, the detailed-balance path
    declines, and the eigenvector of the degenerate eigenvalue 1 comes out
    with negative entries (the same bits in both packages), so `run_burst`
    stops in numpy's ``choice``. A fix changes this test."""
    from scipy.sparse.csgraph import connected_components
    from enspara_tpu_torch.msm.synthetic_data import sparse_metastable_counts
    C = sparse_metastable_counts(200, n_blocks=25, seed=17).toarray()
    rng = np.random.default_rng(1)
    empty = rng.random(len(C)) < 0.3
    events = np.array([([], []) if e else (np.ones(4), np.array(
        ['radiative'] * 4)) for e in empty], dtype='O')
    res, names = (4, 9), ['SimFluor 488D C1R', 'SimFluor 594A C1R']
    live = np.flatnonzero(~empty)
    assert connected_components(C[np.ix_(live, live)] > 0)[0] > 1
    eqs = {}
    for tag, mod in (('port', dl), ('jax', jax_dl)):
        d = tmp_path / tag
        os.makedirs(d / 'MSMs')
        np.save(d / 'events-4-9.npy', events)
        eqs[tag] = mod.remake_msms(res, C, str(d), names,
                                   C.sum(1) / C.sum(), str(d))[1]
        with pytest.raises(ValueError, match='non-negative'):
            mod.run_mc(res, C, names, [np.arange(1, 6)], str(d), str(d), 1,
                       rng_seed=0)
    np.testing.assert_array_equal(eqs['port'], eqs['jax'])
    assert (eqs['port'] < 0).any()


def test_lifetime_fits_equal_jax(library):
    rng = np.random.default_rng(4)
    lts = np.concatenate([rng.exponential(1.5, 4000),
                          rng.exponential(4.0, 2000)])
    name = 'SimFluor 488D C1R'
    for ours, ref in (
            (dl.fit_lifetimes_single_exp(lts, name),
             jax_dl.fit_lifetimes_single_exp(lts, name)),
            (dl.fit_lifetimes_double_exp(lts),
             jax_dl.fit_lifetimes_double_exp(lts)),
            (dl.fit_lifetimes_single_exp_high_throughput(lts),
             jax_dl.fit_lifetimes_single_exp_high_throughput(lts))):
        assert len(ours) == len(ref)
        for a, b in zip(ours, ref):
            np.testing.assert_array_equal(a, b)
