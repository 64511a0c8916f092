"""The port's ``cluster`` and ``reassign`` CLIs held against the JAX
package's on the same trajectory files.

Fixtures are written to ``tmp_path`` with ``enspara_tpu.io.write_pdb``
and ``write_xtc``: metastable-basin frames of 2 atoms per residue, of
which ``--atoms 'name CA'`` selects one. Both packages run under
``ENSPARA_TPU_PLATFORM=cpu`` (JAX pins the CPU, the port takes its
plain kernel versions) and read the same files, so they cluster the
same numbers. Outputs are loaded with ``enspara_tpu.ra.load``:
assignments, center indices and center structures are equal;
distances are held on the msd bar of test_torch_port.py.
"""

import os
import pickle

import numpy as np
import pytest
import torch

from enspara_tpu import ra
from enspara_tpu.apps import cluster as jax_cluster
from enspara_tpu.apps import reassign as jax_reassign
from enspara_tpu.io import Topology, Trajectory, load, write_pdb, write_xtc

from enspara_tpu_torch.apps import cluster, reassign
from enspara_tpu_torch.exception import ImproperlyConfigured
from enspara_tpu_torch.ops.qcp import kabsch_rmsd_np

from test_torch_port import assert_rmsd_close, basin_data


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

N_TRJ, N_FRAMES, N_RES = 3, 90, 11


def write_fixture(d, seed=0, lengths=(N_FRAMES,) * N_TRJ):
    """XTC trajectories of ``lengths`` frames and a PDB topology under
    ``d``; returns ``(topology path, trajectory paths, CA
    coordinates)``."""
    rng = np.random.default_rng(seed)
    X = basin_data(rng, sum(lengths), 2 * N_RES, n_basins=12,
                   dwell=16) + 2.0
    top = Topology()
    chain = top.add_chain()
    for i in range(N_RES):
        res = top.add_residue('ALA', chain, i + 1)
        top.add_atom('CA', 'C', res)
        top.add_atom('CB', 'C', res)
    pdb = str(d / 'top.pdb')
    write_pdb(pdb, Trajectory(X[:1], top))
    trjs = []
    for t, lo in enumerate(np.cumsum((0,) + tuple(lengths))[:-1]):
        trjs.append(str(d / ('trj%d.xtc' % t)))
        write_xtc(trjs[-1], Trajectory(X[lo:lo + lengths[t]], top))
    return pdb, trjs, X[:, ::2]


@pytest.fixture
def cpu_env(monkeypatch):
    monkeypatch.setenv('ENSPARA_TPU_CACHE_DIR', '0')


def _outputs(d, tag):
    return {k: str(d / ('%s_%s' % (tag, v))) for k, v in (
        ('--distances', 'dist.h5'), ('--assignments', 'assig.h5'),
        ('--center-features', 'centers.pkl'),
        ('--center-indices', 'inds.npy'))}


def _cluster_argv(pdb, trjs, out, algorithm, subsample):
    argv = ['cluster', '--trajectories', *trjs, '--topology', pdb,
            '--atoms', 'name CA', '--algorithm', algorithm,
            '--cluster-number', '7', '--subsample', str(subsample),
            '--random-state', '3']
    if algorithm != 'kcenters':
        argv += ['--cluster-iterations', '2']
    for k, v in out.items():
        argv += [k, v]
    return argv


def _load(path):
    """An ``.h5`` output as ``(flat values, row lengths)``."""
    arr = ra.load(path)
    if isinstance(arr, ra.RaggedArray):
        return arr._data, list(arr.lengths)
    arr = np.asarray(arr)
    return arr.reshape(-1), [arr.shape[1]] * arr.shape[0]


def _assert_same_outputs(port, ref, X):
    gsum = 2 * float(((X - X.mean(1, keepdims=True)) ** 2)
                     .sum((1, 2)).max())
    (pa, pl), (ra_, rl) = (_load(o['--assignments']) for o in (port, ref))
    assert pl == rl
    np.testing.assert_array_equal(pa, ra_)
    assert_rmsd_close(_load(port['--distances'])[0],
                      _load(ref['--distances'])[0], gsum, N_RES)
    if '--center-indices' in port:
        np.testing.assert_array_equal(np.load(port['--center-indices']),
                                      np.load(ref['--center-indices']))
    if '--center-features' in port:
        with open(port['--center-features'], 'rb') as f:
            pc = pickle.load(f)
        with open(ref['--center-features'], 'rb') as f:
            rc = pickle.load(f)
        assert len(pc) == len(rc) == 7
        for a, b in zip(pc, rc):
            np.testing.assert_array_equal(a.xyz, b.xyz)


@pytest.mark.parametrize('subsample', [1, 3])
@pytest.mark.parametrize('algorithm', ['kcenters', 'khybrid', 'kmedoids'])
def test_cluster_cli_matches_jax(tmp_path, cpu_env, algorithm, subsample):
    pdb, trjs, X = write_fixture(tmp_path)
    ref, port = _outputs(tmp_path, 'jax'), _outputs(tmp_path, 'port')
    assert jax_cluster.main(_cluster_argv(pdb, trjs, ref, algorithm,
                                          subsample)) == 0
    assert cluster.main(_cluster_argv(pdb, trjs, port, algorithm,
                                      subsample)) == 0
    _assert_same_outputs(port, ref, X)
    assig = ra.load(port['--assignments'])
    assert np.asarray(assig).shape == (N_TRJ, N_FRAMES)


@pytest.mark.parametrize('lengths', [(N_FRAMES,) * N_TRJ, (70, 90, 33)],
                         ids=['uniform', 'ragged'])
def test_reassign_cli_matches_jax(tmp_path, cpu_env, lengths):
    pdb, trjs, X = write_fixture(tmp_path, seed=1, lengths=lengths)
    first = _outputs(tmp_path, 'first')
    assert cluster.main(_cluster_argv(pdb, trjs, first, 'khybrid', 4)) == 0
    outs = {}
    for tag, app in (('jax', jax_reassign), ('port', reassign)):
        outs[tag] = {'--distances': str(tmp_path / (tag + '_rd.h5')),
                     '--assignments': str(tmp_path / (tag + '_ra.h5'))}
        argv = ['reassign', '--centers', first['--center-features'],
                '--trajectories', *trjs, '--topology', pdb,
                '--atoms', 'name CA']
        for k, v in outs[tag].items():
            argv += [k, v]
        assert app.main(argv) == 0
    _assert_same_outputs(outs['port'], outs['jax'], X)
    # the cluster app's own reassignment of the subsampled run
    _assert_same_outputs(outs['port'], {
        '--assignments': first['--assignments'],
        '--distances': first['--distances']}, X)
    assert _load(outs['port']['--assignments'])[1] == list(lengths)


@pytest.mark.parametrize('flag,step', [
    (['--precision', 'bf16'], None),
    (['--locality-sort'], None),
    (['--checkpoint', 'ckpt'], 'only implemented for kmedoids'),
], ids=['bf16', 'locality_sort', 'checkpoint'])
def test_cluster_cli_unported_options_raise(tmp_path, cpu_env, flag, step):
    """--precision bf16 and --locality-sort run (kcenters by rmsd) and
    their outputs read back as a clustering of the fixture: each center
    its own frame's cluster, each distance the RMSD of the frame to its
    center's structure (within the frames' bf16 rounding for bf16). A
    --checkpoint that holds a manifest warm-starts only kmedoids, as in
    the JAX package."""
    pdb, trjs, _ = write_fixture(tmp_path)
    out = _outputs(tmp_path, 'x')
    argv = _cluster_argv(pdb, trjs, out, 'kcenters', 1)
    if step is not None:
        flag = ['--checkpoint', str(tmp_path / 'ckpt')]
        (tmp_path / 'ckpt').mkdir()
        (tmp_path / 'ckpt' / 'manifest.json').write_text('{}')
        with pytest.raises(ImproperlyConfigured, match=step):
            cluster.process_command_line(argv + flag)
        return
    assert cluster.main(argv + flag) == 0
    assig, lengths = _load(out['--assignments'])
    dist = _load(out['--distances'])[0]
    assert lengths == [N_FRAMES] * N_TRJ and set(assig) == set(range(7))
    ctr = [t * N_FRAMES + i for t, i in np.load(out['--center-indices'])]
    np.testing.assert_array_equal(assig[ctr], np.arange(7))
    assert (dist[ctr] < 1e-2).all() and np.isfinite(dist).all()
    with open(out['--center-features'], 'rb') as f:
        C = np.concatenate([c.xyz for c in pickle.load(f)])[:, ::2]
    # the frames as the app read them (XTC precision, the CA atoms)
    Y = np.concatenate([load(t, top=pdb).xyz[:, ::2] for t in trjs])
    np.testing.assert_array_equal(C, Y[ctr])
    Yc, Cc = (Z - Z.mean(1, keepdims=True) for Z in (Y, C))
    ref = np.array([kabsch_rmsd_np(y, Cc[j]) for y, j in zip(Yc, assig)])
    # the fp32 msd bar of assert_rmsd_close, as a bar on the RMSD
    gsum = 2 * float((Yc.astype(np.float64) ** 2).sum((1, 2)).max())
    slack = np.sqrt(1e-5 * ref ** 2
                    + 16 * np.finfo(np.float32).eps * gsum / N_RES)
    if flag[0] == '--precision':
        def rounding(Z):
            d = torch.from_numpy(Z).bfloat16().float().numpy() - Z
            return np.sqrt((d.astype(np.float64) ** 2).sum((1, 2)) / N_RES)
        slack = slack + rounding(Yc) + rounding(Cc)[assig]
        assert np.abs(dist - ref).max() > 1e-5, 'bf16 must round'
    assert (np.abs(dist - ref) <= slack).all()


def test_cluster_cli_features_and_multihost_raise(tmp_path, cpu_env,
                                                  monkeypatch):
    out = _outputs(tmp_path, 'x')
    argv = ['cluster', '--features', str(tmp_path / 'f.h5'),
            '--algorithm', 'kcenters', '--cluster-number', '3']
    for k, v in out.items():
        argv += [k, v]
    # --features takes a feature distance, as in the JAX package
    with pytest.raises(ImproperlyConfigured, match='not compatible'):
        cluster.process_command_line(argv + ['--cluster-distance', 'rmsd'])
    argv += ['--cluster-distance', 'euclidean']
    # multi-process mode needs the whole variable triple
    monkeypatch.setenv('ENSPARA_TPU_COORDINATOR', 'localhost:1234')
    monkeypatch.delenv('ENSPARA_TPU_NUM_PROCESSES', raising=False)
    monkeypatch.setenv('ENSPARA_TPU_PROCESS_ID', '0')
    with pytest.raises(ImproperlyConfigured,
                       match='also needs ENSPARA_TPU_NUM_PROCESSES'):
        cluster.main(argv)


def _fresh_native(tmp_path, monkeypatch):
    """The port's native codecs with an empty build directory, as on a
    fresh checkout, and the XTC binding not yet loaded."""
    from enspara_tpu_torch import native
    from enspara_tpu_torch.io import xtc

    monkeypatch.setattr(native, 'BUILD_DIR', str(tmp_path / 'build'))
    monkeypatch.setattr(xtc, '_lib', None)
    monkeypatch.setattr(xtc, '_checked', False)
    return native, xtc


def test_loaders_build_the_xtc_codec_before_their_threads(tmp_path,
                                                          monkeypatch):
    """On a checkout where the native XTC codec is not built yet, the
    port's loaders build it on the calling thread before the loader
    threads start, so that the threads load one library instead of each
    compiling it."""
    import threading

    from enspara_tpu_torch.cluster import util

    pdb, trjs, X = write_fixture(tmp_path)
    native, xtc = _fresh_native(tmp_path, monkeypatch)
    builders = []
    real = native.load_library

    def recording(name):
        if not os.path.exists(native.lib_path(name)[1]):
            builders.append(threading.current_thread())
        return real(name)
    monkeypatch.setattr(native, 'load_library', recording)
    monkeypatch.setattr(xtc, 'load_library', recording)

    lengths, xyz, _ = util.load_trajectories(
        [pdb], [trjs], ['name CA'], stride=1, processes=8)
    assert builders == [threading.main_thread()]
    assert lengths == [N_FRAMES] * N_TRJ
    np.testing.assert_allclose(xyz, X, atol=1e-3)


def test_native_build_survives_racing_threads(tmp_path, monkeypatch):
    """Threads that race to build the codec on a fresh checkout each load
    a whole library: every build writes a private file and renames it
    into place, and no temporary file is left behind."""
    from concurrent.futures import ThreadPoolExecutor

    native, _ = _fresh_native(tmp_path, monkeypatch)
    with ThreadPoolExecutor(4) as ex:
        futures = [ex.submit(native.load_library, 'xdr') for _ in range(4)]
        libs = [f.result(timeout=300) for f in futures]
    assert all(lib is not None and lib.xtc_scan for lib in libs)
    assert os.listdir(tmp_path / 'build') == [
        os.path.basename(native.lib_path('xdr')[1])]
