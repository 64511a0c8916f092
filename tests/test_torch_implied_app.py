"""The port's ``implied_timescales`` CLI held against the JAX package's
on the same ``.h5`` assignments: ``main`` for every ``--symmetrization``,
with and without ``--trim``, and with ``--trj-ids``, compared through
``--out`` at rtol 1e-10; the ``--timestep`` / ``--infer-timestep``
errors; and the batched route, taken when the device check reports CUDA
(patched here so that the batched solve runs on the CPU), held to the
JAX ``implied_timescales_batched`` at the fp32 eigenvalue bar (1e-4 on
``exp(-lag / ts)``, ``bench.py:356``)."""

import os

import numpy as np
import pytest
import torch

from enspara_tpu import ra as jax_ra
from enspara_tpu.apps import implied_timescales as jax_app
from enspara_tpu.io import Topology, Trajectory, write_xtc
from enspara_tpu.msm.eigen_device import \
    implied_timescales_batched as jax_batched

from enspara_tpu_torch.apps import implied_timescales as app
from enspara_tpu_torch.exception import ImproperlyConfigured


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


def _assignments(tmp_path, dangling=True, gaps=False):
    """Five ragged trajectories of a sticky walk over 7 states (seed 0),
    written with the JAX package's ``ra.save``; with ``dangling`` one
    ends in a state never left, with ``gaps`` some frames are -1."""
    rng = np.random.default_rng(0)
    rows = []
    for n in (300, 260, 340, 200, 280):
        r = np.empty(n, np.int64)
        r[0] = rng.integers(0, 7)
        for t in range(1, n):
            r[t] = rng.integers(0, 7) if rng.random() < 0.3 else r[t - 1]
        rows.append(r)
    if dangling:
        rows[1][-1] = 7
    if gaps:
        rows[0][rng.random(300) < 0.05] = -1
    path = str(tmp_path / 'assig.h5')
    jax_ra.save(path, jax_ra.RaggedArray(rows))
    return path


def _run_both(tmp_path, afile, *flags):
    outs = []
    for name, main in (('port', app.main), ('jax', jax_app.main)):
        out = str(tmp_path / ('%s.npy' % name))
        assert main(['implied', '--assignments', afile, '--lag-times',
                     '1:12:3', '--n-eigenvalues', '3', '--out', out,
                     *flags]) == 0
        outs.append(np.load(out))
    return outs


@pytest.mark.parametrize('trim', [False, True])
@pytest.mark.parametrize('sym', ['transpose', 'row_normalize',
                                 'prior_counts'])
def test_main_matches_jax(tmp_path, sym, trim):
    afile = _assignments(tmp_path)
    flags = ['--symmetrization', sym] + (['--trim'] if trim else [])
    got, ref = _run_both(tmp_path, afile, *flags)
    assert got.shape == (4, 3)
    np.testing.assert_allclose(got, ref, rtol=1e-10)


def test_trj_ids_processes_and_plot(tmp_path):
    afile = _assignments(tmp_path, dangling=False)
    plot = str(tmp_path / 'its.png')
    got, ref = _run_both(tmp_path, afile, '--trj-ids', '1:4', '--processes',
                         '2', '--plot', plot, '--logscale', '--timestep',
                         '10')
    np.testing.assert_allclose(got, ref, rtol=1e-10)
    assert os.path.getsize(plot) > 0
    sub = np.asarray(jax_ra.load(afile)[1:4]._data)
    assert int(sub.max()) == 6


def _xtc(tmp_path, name, times):
    top = Topology()
    chain = top.add_chain()
    top.add_atom('CA', 'C', top.add_residue('ALA', chain, 1))
    xyz = np.zeros((len(times), 1, 3), np.float32)
    path = str(tmp_path / name)
    write_xtc(path, Trajectory(xyz, top, time=np.asarray(times, float)))
    return path


def test_timestep_errors(tmp_path):
    steady = _xtc(tmp_path, 'steady.xtc', np.arange(12) * 2.0)
    wobbly = _xtc(tmp_path, 'wobbly.xtc', [0.0, 2.0, 4.0, 7.0, 9.0])
    single = _xtc(tmp_path, 'single.xtc', [0.0])
    for fn in (app.process_units, jax_app.process_units):
        assert fn() == (1, 'frames')
        assert fn(timestep=10) == (10, 'ns')
        assert fn(infer_timestep=steady) == (500.0, 'ns')
        for kw in ({'timestep': 10, 'infer_timestep': steady},
                   {'infer_timestep': wobbly}, {'infer_timestep': single},
                   {'infer_timestep': str(tmp_path / 'missing.xtc')}):
            with pytest.raises(Exception) as err:
                fn(**kw)
            assert type(err.value).__name__ == 'ImproperlyConfigured'
    with pytest.raises(ImproperlyConfigured, match='Only one of'):
        app.main(['implied', '--assignments', _assignments(tmp_path),
                  '--lag-times', '1:3:1', '--n-eigenvalues', '2',
                  '--timestep', '10', '--infer-timestep', steady])
    C = np.array([[7, 1, 3], [1, 8, 3], [0, 7, 9]])
    assert np.array_equal(np.asarray(app.prior_counts(C)[1]),
                          np.asarray(jax_app.prior_counts(C)[1]))


@pytest.mark.parametrize('case', ['batched', 'trim', 'row_normalize',
                                  'gaps'])
def test_batched_route_when_the_device_is_cuda(tmp_path, monkeypatch, case):
    """With the device check reporting CUDA, the transpose builder
    without --trim on gap-free data takes the batched solve; --trim,
    another builder or a -1 frame takes the host fan-out."""
    afile = _assignments(tmp_path, dangling=False, gaps=case == 'gaps')
    monkeypatch.setattr(app, '_batched_device', lambda device: True)
    taken = []

    def recording(name, fn):
        def wrapped(*a, **kw):
            taken.append(name)
            return fn(*a, **kw)
        monkeypatch.setattr(app, name, wrapped)
    recording('implied_timescales_batched', app.implied_timescales_batched)
    recording('implied_timescales', app.implied_timescales)
    flags = {'trim': ['--trim'], 'row_normalize': ['--symmetrization',
                                                  'row_normalize']}
    out = str(tmp_path / 'its.npy')
    app.main(['implied', '--assignments', afile, '--lag-times', '1:12:3',
              '--n-eigenvalues', '3', '--out', out, *flags.get(case, [])])
    got = np.load(out)
    if case != 'batched':
        assert taken == ['implied_timescales']
        return
    assert taken == ['implied_timescales_batched']
    lags = np.arange(1, 12, 3)[:, None]
    ref = jax_batched(jax_ra.load(afile), range(1, 12, 3), n_times=3,
                      sliding_window=True)
    assert got.shape == ref.shape == (4, 3)
    np.testing.assert_allclose(np.exp(-lags / got), np.exp(-lags / ref),
                               rtol=0, atol=1e-4)
