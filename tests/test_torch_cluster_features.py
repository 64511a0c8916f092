"""The port's ``cluster --features`` CLI, ``--checkpoint``,
``util/checkpoint.py``, ``cluster/save_states.py`` and the ``enspara``
dispatcher (``apps/main.py``) held against the JAX package.

Feature files (``.npy`` per trajectory, or one ``.h5`` RaggedArray) are
written to ``tmp_path`` from a seed; both CLIs run under
``ENSPARA_TPU_PLATFORM=cpu`` on the same files. Assignments, center
indices and center features are equal; distances within rtol 1e-5 (the
k-centers loop's difference form, manhattan) or on the Gram bar of
``assert_gram_close`` (a euclidean reassignment or PAM). Validation
messages are the JAX package's word for word. Checkpoints cross between
the packages in both directions.
"""

import os

import numpy as np
import pytest
import torch

from enspara_tpu import ra
from enspara_tpu.apps import cluster as jax_cluster
from enspara_tpu.cluster import kcenters as jax_kcenters
from enspara_tpu.cluster.save_states import save_states as jax_save_states
from enspara_tpu.exception import ImproperlyConfigured as JaxImproperly
from enspara_tpu.util import checkpoint as jax_checkpoint

from enspara_tpu_torch.apps import cluster, main as main_app
from enspara_tpu_torch.apps import (collect_cards, implied_timescales,
                                    reassign, shannon_entropy,
                                    smFRET_dye_MC, smFRET_point_clouds)
from enspara_tpu_torch.cluster import kcenters
from enspara_tpu_torch.cluster.save_states import save_states
from enspara_tpu_torch.exception import ImproperlyConfigured
from enspara_tpu_torch.util import checkpoint

from test_torch_apps import write_fixture
from test_torch_port import assert_gram_close


@pytest.fixture(autouse=True)
def _cpu_platform(monkeypatch):
    """Host inputs run on the CPU in these tests: with no device named,
    the port sends them to the card. Torch runs on one thread: the
    tier-1 run puts several test workers on one host's cores."""
    monkeypatch.setenv('ENSPARA_TPU_PLATFORM', 'cpu')
    monkeypatch.setenv('ENSPARA_TPU_CACHE_DIR', '0')
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _features(lengths=(60, 45, 75), d=5, seed=0):
    """Per-trajectory float32 blob features, small enough in magnitude
    that a frame's Gram self-distance passes kmedoids' 1e-3 gate."""
    rng = np.random.RandomState(seed)
    blobs = 0.3 * rng.normal(size=(9, d))
    return [(blobs[rng.randint(0, 9, n)] + 0.04 * rng.normal(size=(n, d)))
            .astype(np.float32) for n in lengths]


def write_features(d, fmt, rows):
    """The rows as one ``.npy`` file each, or one ``.h5`` RaggedArray."""
    if fmt == 'h5':
        fn = str(d / 'feats.h5')
        ra.save(fn, ra.RaggedArray(rows))
        return [fn]
    files = []
    for i, r in enumerate(rows):
        files.append(str(d / ('f%d.npy' % i)))
        np.save(files[-1], r)
    return files


def _outputs(d, tag):
    return {k: str(d / ('%s_%s' % (tag, v))) for k, v in (
        ('--distances', 'dist.h5'), ('--assignments', 'assig.h5'),
        ('--center-features', 'centers.npy'),
        ('--center-indices', 'inds.npy'))}


def _argv(files, out, *flags):
    argv = ['cluster', '--features', *files, '--random-state', '3', *flags]
    for k, v in out.items():
        argv += [k, v]
    return argv


def _flat(path):
    arr = ra.load(path)
    if isinstance(arr, ra.RaggedArray):
        return arr._data, list(arr.lengths)
    arr = np.asarray(arr)
    return arr.reshape(-1), [arr.shape[1]] * arr.shape[0]


@pytest.mark.parametrize('fmt,flags,gram', [
    ('npy', ('--algorithm', 'khybrid', '--cluster-number', '6',
             '--cluster-distance', 'euclidean', '--subsample', '2',
             '--cluster-iterations', '2'), True),
    ('npy', ('--algorithm', 'kcenters', '--cluster-number', '7',
             '--cluster-distance', 'manhattan'), False),
    ('h5', ('--algorithm', 'kmedoids', '--cluster-number', '5',
            '--cluster-distance', 'euclidean', '--cluster-iterations', '2'),
     True),
], ids=['khybrid_euclidean_npy', 'kcenters_manhattan_npy',
        'kmedoids_euclidean_h5'])
def test_feature_cli_matches_jax(tmp_path, fmt, flags, gram):
    """The port's CLI (the first case through the dispatcher) writes the
    JAX CLI's outputs."""
    rows = _features()
    files = write_features(tmp_path, fmt, rows)
    ref, port = _outputs(tmp_path, 'jax'), _outputs(tmp_path, 'port')
    assert jax_cluster.main(_argv(files, ref, *flags)) == 0
    if flags[1] == 'khybrid':
        assert main_app.main(['enspara'] + _argv(files, port, *flags)) == 0
    else:
        assert cluster.main(_argv(files, port, *flags)) == 0
    (pa, pl), (ja, jl) = _flat(port['--assignments']), \
        _flat(ref['--assignments'])
    assert pl == jl == [len(r) for r in rows]
    np.testing.assert_array_equal(pa, ja)
    pc, jc = np.load(port['--center-features']), \
        np.load(ref['--center-features'])
    np.testing.assert_array_equal(pc, jc)
    np.testing.assert_array_equal(np.load(port['--center-indices']),
                                  np.load(ref['--center-indices']))
    pd, jd = _flat(port['--distances'])[0], _flat(ref['--distances'])[0]
    if gram:
        assert_gram_close(pd, jd, np.concatenate(rows), jc)
    else:
        np.testing.assert_allclose(pd, jd, rtol=1e-5)


_BAD = {
    'rmsd_distance': ('npy', ['--cluster-distance', 'rmsd']),
    'h5_subsample': ('h5', ['--subsample', '2']),
    'topology': ('npy', ['--topology', 'top.pdb']),
    'atoms': ('npy', ['--atoms', 'name CA']),
    'bf16': ('npy', ['--precision', 'bf16']),
    'locality_sort': ('npy', ['--locality-sort']),
    'checkpoint_khybrid': ('npy', ['--checkpoint', 'CKPT']),
    'checkpoint_and_init': ('npy', ['--checkpoint', 'CKPT',
                                    '--init-center-inds', 'i.npy']),
}


@pytest.mark.parametrize('case', sorted(_BAD))
def test_feature_cli_messages_match_jax(tmp_path, case):
    fmt, extra = _BAD[case]
    files = write_features(tmp_path, fmt, _features())
    algo = 'kmedoids' if case == 'checkpoint_and_init' else 'khybrid'
    flags = ['--algorithm', algo, '--cluster-number', '4']
    if '--cluster-distance' not in extra:
        flags += ['--cluster-distance', 'euclidean']
    if 'CKPT' in extra:
        ck = tmp_path / 'ck'
        ck.mkdir()
        (ck / 'manifest.json').write_text('{}')
        extra = [str(ck) if a == 'CKPT' else a for a in extra]
    argv = _argv(files, _outputs(tmp_path, 'x'), *flags, *extra)
    with pytest.raises(JaxImproperly) as ref:
        jax_cluster.process_command_line(list(argv))
    with pytest.raises(ImproperlyConfigured) as port:
        cluster.process_command_line(list(argv))
    assert str(port.value) == str(ref.value)


def test_checkpoint_save_and_kmedoids_warm_start(tmp_path):
    """``--checkpoint`` saves the clustering in the JAX format; a kmedoids
    run given it warm-starts from it, as the JAX CLI does, and does not
    raise the cost."""
    rows = _features(seed=1)
    files = write_features(tmp_path, 'npy', rows)
    for tag, app in (('jax', jax_cluster), ('port', cluster)):
        ck = str(tmp_path / (tag + '_ck'))
        first = ['--algorithm', 'khybrid', '--cluster-number', '6',
                 '--cluster-distance', 'euclidean', '--checkpoint', ck]
        assert app.main(_argv(files, _outputs(tmp_path, tag + '1'),
                              *first)) == 0
        assert sorted(os.listdir(ck)) == [
            'assignments.npy', 'center_indices.npy', 'distances.npy',
            'manifest.json']
        before = checkpoint.load_clustering_checkpoint(ck)
        assert before['metadata'] == {'algorithm': 'khybrid',
                                      'subsample': 1}
        warm = ['--algorithm', 'kmedoids', '--cluster-number', '6',
                '--cluster-iterations', '1', '--cluster-distance',
                'euclidean', '--checkpoint', ck]
        assert app.main(_argv(files, _outputs(tmp_path, tag + '2'),
                              *warm)) == 0
        after = checkpoint.load_clustering_checkpoint(ck)
        assert after['metadata']['algorithm'] == 'kmedoids'
        assert np.mean(after['distances'] ** 2) <= \
            np.mean(before['distances'] ** 2) + 1e-7
    for name in ('center_indices', 'assignments'):
        np.testing.assert_array_equal(np.load(tmp_path / 'port_ck' /
                                              (name + '.npy')),
                                      np.load(tmp_path / 'jax_ck' /
                                              (name + '.npy')))


def test_checkpoints_cross_between_the_packages(tmp_path):
    """A checkpoint the JAX package wrote, resumed by the port, equals
    the JAX uninterrupted run; and the reverse."""
    X = np.concatenate(_features(lengths=(150, 90), d=4, seed=2))
    full = jax_kcenters(X, 'euclidean', n_clusters=12)
    for tag, save, resume, half in (
            ('jax', jax_checkpoint.save_clustering_checkpoint,
             checkpoint.resume_kcenters, jax_kcenters),
            ('port', checkpoint.save_clustering_checkpoint,
             jax_checkpoint.resume_kcenters, kcenters)):
        h = half(X, 'euclidean', n_clusters=5)
        path = str(tmp_path / tag)
        save(path, h.distances, h.assignments, h.center_indices)
        res = resume(path, X, metric='euclidean', n_clusters=12)
        np.testing.assert_array_equal(res.center_indices,
                                      full.center_indices)
        np.testing.assert_array_equal(res.assignments, full.assignments)
        np.testing.assert_allclose(res.distances, full.distances, rtol=1e-5)
        for c, i in zip(res.centers, full.center_indices):
            np.testing.assert_array_equal(c, X[i])
    state = checkpoint.load_clustering_checkpoint(str(tmp_path / 'jax'))
    assert state['iteration'] == 5 and state['metadata'] == {}


def test_save_states_writes_the_jax_pdbs(tmp_path):
    pdb, trjs, _ = write_fixture(tmp_path)
    rng = np.random.default_rng(1)
    assignments = rng.integers(0, 4, size=(3, 90))
    distances = rng.random((3, 90))
    distances[1, 5] = -1.0                  # a gap: never picked
    out = {}
    for tag, fn in (('jax', jax_save_states), ('port', save_states)):
        out[tag] = fn(assignments, distances, traj_filenames=trjs,
                      output_directory=str(tmp_path / tag), topology=pdb,
                      n_confs=2, n_processes=2, random_state=4)
    assert [os.path.basename(p) for p in out['port']] == \
        [os.path.basename(p) for p in out['jax']]
    assert len(out['port']) == 8
    for p, j in zip(out['port'], out['jax']):
        with open(p) as f, open(j) as g:
            assert f.read() == g.read()


def test_dispatcher_routes_and_names_the_unported_apps():
    for name, module in (('cluster', cluster), ('implied',
                                                implied_timescales),
                         ('reassign', reassign), ('cards', collect_cards),
                         ('entropy', shannon_entropy),
                         ('smfret-clouds', smFRET_point_clouds),
                         ('smfret-dyes', smFRET_dye_MC)):
        args = main_app.identify_app(['enspara', name, '--help'])
        assert args.main is module.main and args.appargs == ['--help']
    with pytest.raises(SystemExit):
        main_app.identify_app(['enspara', 'not-an-app'])
    from enspara_tpu.apps import main as jax_main
    assert set(main_app._APP_MODULES) == set(jax_main._APP_MODULES)
