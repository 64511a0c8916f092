"""The port's ``smFRET_dye_MC`` app (``enspara smfret-dyes``) against the
JAX package's on the CPU: ``calc_lifetimes`` with each host treatment
writes the same event files and saved MSMs and tables, the device
treatment the same layout, and ``run_burst`` on the same events the same
burst files; the dispatcher routes ``smfret-dyes`` to the port's app, and
``python -m enspara_tpu_torch.apps.main smfret-dyes`` runs both
subcommands end to end. The protein centers, the dye library and the
photon times are synthetic (``chip_smoke`` generators) and written to
temporary directories.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from enspara_tpu.apps import smFRET_dye_MC as jax_app

from enspara_tpu_torch.apps import main as main_app
from enspara_tpu_torch.apps import smFRET_dye_MC as app
from enspara_tpu_torch.io import (Topology, Trajectory, load, write_dcd,
                                  write_pdb)

from chip_smoke import (explicit_dye_library, globule, globule_frames,
                        label_sites, lys_topology)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_RES, N_DYE, N_CENTERS, N_SAMPLES = 30, 40, 5, 20


@pytest.fixture(scope='module')
def inputs(tmp_path_factory):
    """The dye library and the CLI's input files: protein centers (DCD and
    PDB), dye centers and counts, the residue pair, a protein MSM and
    inter-photon times."""
    root = tmp_path_factory.mktemp('smfret')
    lib = explicit_dye_library(str(root / 'dyes'), 0, n_frames=N_DYE)
    xyz, _, groups = globule_frames(globule(N_RES, seed=8), N_CENTERS,
                                    seed=9, planted=(1, 2, 0.4))
    prot = Trajectory(xyz, lys_topology(Topology, N_RES))
    write_dcd(str(root / 'centers.dcd'), prot)
    write_pdb(str(root / 'prot.pdb'), prot[0])
    pair = label_sites(prot, 1, np.concatenate(groups))
    np.savetxt(root / 'pairs.txt', pair, fmt='%d')
    rng = np.random.default_rng(6)
    C = rng.integers(1, 40, (N_CENTERS, N_CENTERS))
    C = C + C.T
    np.save(root / 'prot_counts.npy', C)
    np.save(root / 'prot_eqs.npy', C.sum(1) / C.sum())
    times = np.array([rng.exponential(0.5, k) for k in (6, 11, 9, 4)],
                     dtype=object)
    np.save(root / 'photons.npy', times, allow_pickle=True)
    (dn, ddcd, dpdb, dc), (an, adcd, apdb, ac) = lib.values()
    calc = ['calc_lifetimes', '--donor_name', dn, '--donor_centers', ddcd,
            '--donor_top', dpdb, '--donor_tcounts', dc, '--acceptor_name',
            an, '--acceptor_centers', adcd, '--acceptor_top', apdb,
            '--acceptor_tcounts', ac, '--dye_lagtime', '0.002',
            '--prot_top', str(root / 'prot.pdb'), '--prot_centers',
            str(root / 'centers.dcd'), '--resid_pairs',
            str(root / 'pairs.txt'), '--n_samples', str(N_SAMPLES),
            '--rng_seed', '5', '--n_procs', '2']
    burst = ['run_burst', '--eq_probs', str(root / 'prot_eqs.npy'),
             '--t_counts', str(root / 'prot_counts.npy'), '--donor_name',
             dn, '--acceptor_name', an, '--lagtime', '1', '--resid_pairs',
             str(root / 'pairs.txt'), '--photon_times',
             str(root / 'photons.npy'), '--correction_factor', '1', '2']
    return dict(root=root, dyes=str(root / 'dyes'), calc=calc, burst=burst,
                pair=pair[0])


@pytest.fixture(autouse=True)
def _cpu_platform(monkeypatch, inputs):
    """Host inputs run on the CPU in these tests: with no device named,
    the port sends them to the card. Both packages read the synthetic
    library. Torch runs on one thread: the tier-1 run puts several test
    workers on one host's cores."""
    monkeypatch.setenv('ENSPARA_TPU_PLATFORM', 'cpu')
    monkeypatch.setenv('ENSPARA_TPU_DYE_DIR', inputs['dyes'])
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _InThisThread:
    """A stand-in for ``ThreadPoolExecutor`` that maps in the calling
    thread. The JAX app's workers call pandas' CSV reader, which can
    crash (SIGSEGV in pyarrow's string arrays) off the main thread."""

    def __init__(self, max_workers=None):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def map(self, fn, *its):
        return list(map(fn, *its))


def run_both(tmp_path, argv, monkeypatch):
    """Run ``argv`` through both apps, each into its own output directory
    (the JAX app's centers in the calling thread); returns the two
    directories."""
    monkeypatch.setattr(jax_app, 'ThreadPoolExecutor', _InThisThread)
    out = {}
    for tag, mod in (('port', app), ('jax', jax_app)):
        d = tmp_path / tag
        os.makedirs(d, exist_ok=True)
        assert mod.main(['smFRET'] + argv + ['--output_dir', str(d)]) == 0
        out[tag] = d
    return out['port'], out['jax']


def same_tree(a, b, close=('eqs.npy', 'eqs-', 't_prbs')):
    """Every file under ``b`` is under ``a`` with the same contents: bit for
    bit, but the equilibrium probabilities (the port's spanning-tree pi
    against the JAX eigenvector) within 1e-12."""
    names = sorted(os.path.relpath(os.path.join(r, f), b)
                   for r, _, fs in os.walk(b) for f in fs)
    assert names == sorted(os.path.relpath(os.path.join(r, f), a)
                           for r, _, fs in os.walk(a) for f in fs)
    for name in names:
        if name.endswith('.xtc'):
            np.testing.assert_array_equal(
                load(os.path.join(a, name)).xyz,
                load(os.path.join(b, name)).xyz)
            continue
        x = np.load(os.path.join(a, name), allow_pickle=True)
        y = np.load(os.path.join(b, name), allow_pickle=True)
        assert x.shape == y.shape and x.dtype == y.dtype, name
        if any(c in name for c in close) and x.dtype != object:
            np.testing.assert_allclose(x, y, rtol=1e-12, atol=1e-16)
        elif x.dtype == object:
            for u, v in zip(x.ravel(), y.ravel()):
                np.testing.assert_array_equal(np.asarray(u), np.asarray(v))
        else:
            np.testing.assert_array_equal(x, y)
    return names


def test_dispatcher_routes_smfret_dyes():
    args = main_app.identify_app(['enspara', 'smfret-dyes', '--help'])
    assert args.main is app.main and args.appargs == ['--help']
    with pytest.raises(SystemExit) as err:
        args.main(['smfret-dyes'] + args.appargs)
    assert err.value.code == 0


@pytest.mark.parametrize('treatment', ['Monte-carlo', 'static',
                                       'isotropic'])
def test_calc_lifetimes_equals_jax(inputs, tmp_path, treatment,
                                   monkeypatch):
    extra = ['--dye_treatment', treatment, '--save_dmsm']
    if treatment == 'isotropic':
        extra.append('--save_k2_r2')
    if treatment == 'Monte-carlo':
        extra += ['--save_dtrj', '--save_dye_centers']
    port, jax = run_both(tmp_path, inputs['calc'] + extra, monkeypatch)
    names = same_tree(port, jax)
    assert 'events-%d-%d.npy' % tuple(inputs['pair']) in names
    ev = np.load(port / ('events-%d-%d.npy' % tuple(inputs['pair'])),
                 allow_pickle=True)
    assert len(ev) == N_CENTERS
    assert any(len(e[0]) == N_SAMPLES for e in ev)
    if treatment == 'Monte-carlo':
        assert any(n.endswith('.xtc') for n in names)


def test_calc_lifetimes_on_the_device_treatment(inputs, tmp_path,
                                                monkeypatch):
    """The lockstep treatment: the same event layout as the JAX app's
    (a center's lifetimes in ns a multiple of the lag, its outcomes in the
    three channels), and the same centers left without a dye."""
    port, jax = run_both(tmp_path, inputs['calc']
                         + ['--dye_treatment', 'Monte-carlo-device'],
                         monkeypatch)
    name = 'events-%d-%d.npy' % tuple(inputs['pair'])
    ours = np.load(port / name, allow_pickle=True)
    ref = np.load(jax / name, allow_pickle=True)
    assert ours.shape == ref.shape and ours.dtype == ref.dtype == object
    for a, b in zip(ours, ref):
        assert len(a[0]) == len(b[0])
        if len(a[0]):
            lt = np.asarray(a[0], float)
            np.testing.assert_allclose(lt / 0.002, np.round(lt / 0.002))
            assert set(np.asarray(a[1])) <= {'radiative', 'non_radiative',
                                             'energy_transfer'}
            assert type(a[1][0]) is type(b[1][0])
    with pytest.raises(Exception, match='save_dye_trj'):
        app.main(['smFRET'] + inputs['calc']
                 + ['--dye_treatment', 'Monte-carlo-device', '--save_dtrj',
                    '--output_dir', str(tmp_path / 'bad')])


def test_run_burst_equals_jax(inputs, tmp_path, monkeypatch):
    """run_burst of both apps on the same events (the JAX app's static
    treatment): the same MSMs, efficiencies and lifetimes. Both apps seed
    their bursts from fresh entropy (``run_mc(rng_seed=None)``): the test
    gives both the same seed."""
    import functools
    from enspara_tpu.geometry import dye_lifetimes as jax_dl
    from enspara_tpu_torch.geometry import dye_lifetimes as dl
    for mod in (dl, jax_dl):
        monkeypatch.setattr(mod, 'run_mc',
                            functools.partial(mod.run_mc, rng_seed=12))
    events = tmp_path / 'events'
    os.makedirs(events)
    monkeypatch.setattr(jax_app, 'ThreadPoolExecutor', _InThisThread)
    jax_app.main(['smFRET'] + inputs['calc']
                 + ['--dye_treatment', 'static', '--output_dir',
                    str(events)])
    port, jax = run_both(tmp_path, inputs['burst']
                         + ['--lifetimes_dir', str(events),
                            '--save_burst_frames'], monkeypatch)
    names = same_tree(port, jax)
    assert len([n for n in names if n.startswith('FEs')]) == 2
    fe = np.load(port / 'FEs' / ('FE-%d-%d-1.npy' % tuple(inputs['pair'])),
                 allow_pickle=True)
    assert fe.shape == (4,) and ((fe >= 0) & (fe <= 1)).all()


def test_dispatcher_runs_both_subcommands(inputs, tmp_path):
    env = dict(os.environ, ENSPARA_TPU_PLATFORM='cpu',
               ENSPARA_TPU_DYE_DIR=inputs['dyes'],
               PYTHONPATH=ROOT + os.pathsep + os.environ.get('PYTHONPATH',
                                                             ''))
    out = tmp_path / 'cli'
    for argv in (inputs['calc'] + ['--dye_treatment', 'Monte-carlo-device'],
                 inputs['burst'] + ['--lifetimes_dir', str(out)]):
        run = subprocess.run(
            [sys.executable, '-m', 'enspara_tpu_torch.apps.main',
             'smfret-dyes'] + argv + ['--output_dir', str(out)], env=env,
            cwd=ROOT, capture_output=True, text=True, timeout=600)
        assert run.returncode == 0, run.stderr
    fe = np.load(out / 'FEs' / ('FE-%d-%d-2.npy' % tuple(inputs['pair'])),
                 allow_pickle=True)
    assert fe.shape == (4,) and np.isfinite(fe).all()
