"""The port's clustering entry points over a frame mesh and the
multi-process mode of its ``cluster`` CLI.

``kmedoids``, ``hybrid``, ``KMedoids``, ``KHybrid`` and ``hybrid_device``
over a 4-shard CPU mesh equal the same calls on one device (there the
device sweeps, as on the card: the CPU's default is the host PAM path,
which has no shards); ``ctr_ids_mpi`` equals the JAX function; and a
two-process gloo job of the CLI (2 CPU shards each, XTC files written
with the JAX package's writers, ``--algorithm khybrid``) equals a
one-process 4-shard run bit for bit and the JAX package's one-process
CLI (its device sweeps) in center indices and assignments, distances on
the msd bar of ``assert_rmsd_close``; rank 0 alone writes, and
``--subsample 2`` is refused. Both runs of the port draw the JAX
package's bits for the sweeps, as the JAX CLI does, so that they can
accept the same swaps. ``job_mesh`` takes NCCL only where every process
leads from a card of its own (its collectives patched to record).
"""

import importlib
import json
import os
import pickle
import socket
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enspara_tpu import ra as jra
from enspara_tpu.apps import cluster as jax_cluster
from enspara_tpu.parallel import mesh as jmesh
from enspara_tpu.parallel import ops as jops

from enspara_tpu_torch.apps import cluster
from enspara_tpu_torch.cluster import (KHybrid, KMedoids, engine_kmedoids,
                                       hybrid, hybrid_device, kmedoids)
from enspara_tpu_torch.exception import ImproperlyConfigured
from enspara_tpu_torch.parallel import FrameMesh
from enspara_tpu_torch.parallel import io as pio

from test_torch_apps import N_RES, write_fixture
from test_torch_port import assert_rmsd_close, basin_data

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
kmedoids_mod = importlib.import_module('enspara_tpu_torch.cluster.kmedoids')
jax_kmedoids = importlib.import_module('enspara_tpu.cluster.kmedoids')


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


def _gsum(X):
    Xc = X - X.mean(axis=1, keepdims=True)
    return 2 * float((Xc ** 2).sum((1, 2)).max())


def _device_sweeps_on_cpu(monkeypatch):
    """Make a one-device call on the CPU take the device sweeps, as it
    does on the card."""
    monkeypatch.setattr(kmedoids_mod, 'resolve_device',
                        lambda x, device=None: types.SimpleNamespace(
                            type='cuda'))


ENTRY_POINTS = {
    'kmedoids': lambda X, **kw: kmedoids(X, 'rmsd', n_clusters=9, n_iters=3,
                                         random_state=2, **kw),
    'hybrid': lambda X, **kw: hybrid(X, 'rmsd', n_iters=3, n_clusters=9,
                                     random_state=2, **kw),
    'KMedoids': lambda X, **kw: KMedoids('rmsd', n_clusters=9, n_iters=3,
                                         random_state=2, **kw).fit(X).result_,
    'KHybrid': lambda X, **kw: KHybrid('rmsd', n_clusters=9,
                                       kmedoids_updates=3, random_state=2,
                                       **kw).fit(X).result_,
    'hybrid_device': lambda X, **kw: hybrid_device(X, 'rmsd', n_iters=3,
                                                   n_clusters=9, seed=2,
                                                   **kw),
}


@pytest.mark.parametrize('entry', list(ENTRY_POINTS))
def test_mesh_entry_points_match_one_device(entry, monkeypatch):
    """Each entry point over a 4-shard CPU mesh equals its one-device
    call for the same seed: the same centers and assignments, distances
    on the msd bar, and at least one swap accepted."""
    X = basin_data(np.random.default_rng(6), 501, 8, n_basins=30,
                   noise=0.1) / 2
    _device_sweeps_on_cpu(monkeypatch)
    calls = []
    real = engine_kmedoids.kmedoids_sweeps_device

    def spy(*a, **kw):
        calls.append(kw.get('mesh'))
        return real(*a, **kw)
    for mod in (engine_kmedoids, importlib.import_module(
            'enspara_tpu_torch.cluster.hybrid')):
        monkeypatch.setattr(mod, 'kmedoids_sweeps_device', spy)
    mesh = FrameMesh(['cpu'] * 4)
    got = ENTRY_POINTS[entry](X, mesh=mesh)
    ref = ENTRY_POINTS[entry](X, device='cpu')
    assert len(calls) == 2 and calls[0] is mesh and calls[1] is None
    np.testing.assert_array_equal(np.asarray(got.center_indices),
                                  np.asarray(ref.center_indices))
    np.testing.assert_array_equal(got.assignments, ref.assignments)
    assert_rmsd_close(got.distances, ref.distances, _gsum(X), 8)
    if entry == 'kmedoids':
        return
    seed = engine_kmedoids.engine.kcenters_device_fused(X, n_clusters=9,
                                                        device='cpu')
    assert not np.array_equal(np.asarray(ref.center_indices),
                              seed.center_indices), 'no swap accepted'


@pytest.mark.parametrize('size', [1, 2, 3])
def test_ctr_ids_mpi_matches_jax(size, monkeypatch):
    """``(owner rank, local index)`` of centers given as global frame
    indices and as ``(trajectory, frame)`` pairs, with the trajectories
    striped over ``size`` processes."""
    monkeypatch.setattr(jops, '_proc_info', lambda: (0, size))
    monkeypatch.setattr(pio, '_process_info', lambda: (0, size))
    lengths = [5, 3, 7, 4, 6]
    inds = [0, 4, 5, 8, 14, 15, 24, (2, 6), (4, 0), (1, 2)]
    got = kmedoids_mod.ctr_ids_mpi(inds, lengths)
    assert got == jax_kmedoids.ctr_ids_mpi(inds, lengths)
    assert all(r < size for r, _ in got)
    assert 'ctr_ids_mpi' in kmedoids_mod.__all__


WORKER = r'''
import json, os, sys
rank, d = int(sys.argv[1]), sys.argv[2]

import numpy as np
import torch

from enspara_tpu_torch.apps import cluster
from enspara_tpu_torch.cluster import engine_kmedoids
from enspara_tpu_torch.cluster.kmedoids import ctr_ids_mpi
from enspara_tpu_torch.exception import ImproperlyConfigured

with open(os.path.join(d, 'job.json')) as f:
    job = json.load(f)
bits = np.load(os.path.join(d, 'bits.npy'))


def jax_bits(seed, n_sweeps, n, device):
    """The JAX package's bits for this seed, as the test drew them."""
    assert seed == job['seed'], (seed, job['seed'])
    for b in bits[:n_sweeps]:
        yield torch.from_numpy(b[:n]).to(device)


real_bits = engine_kmedoids.sweep_bits
engine_kmedoids.sweep_bits = jax_bits
fit = cluster.fit


def recorded(*a, **kw):
    c = fit(*a, **kw)
    r = c.result_
    np.savez(os.path.join(d, 'res%d.npz' % rank),
             ctr=np.asarray(r.center_indices), assig=r.assignments,
             dist=r.distances, size=a[3].size, first=a[3].first_shard)
    return c


cluster.fit = recorded
try:
    cluster.main(job['argv%d' % rank] + ['--subsample', '2'])
    raise SystemExit('--subsample 2 was not refused')
except ImproperlyConfigured as e:
    assert 'subsample' in str(e), e
assert cluster.main(job['argv%d' % rank]) == 0
res = np.load(os.path.join(d, 'res%d.npz' % rank))
with open(os.path.join(d, 'ctr_ids%d.json' % rank), 'w') as f:
    json.dump([[int(a), int(b)] for a, b in ctr_ids_mpi(
        res['ctr'], job['lengths'])], f)

# the library entry points across the processes, with the port's bits
from enspara_tpu_torch.cluster import hybrid_device, kmedoids
engine_kmedoids.sweep_bits = real_bits
mesh = cluster.join_job()
X = np.load(os.path.join(d, 'X.npy'))
hd = hybrid_device(X, 'rmsd', n_iters=2, n_clusters=8, seed=4, mesh=mesh)
km = kmedoids(X, 'rmsd', n_clusters=8, n_iters=2, random_state=5, mesh=mesh)
np.savez(os.path.join(d, 'lib%d.npz' % rank),
         *[np.asarray(v) for r in (hd, km)
           for v in (r.center_indices, r.assignments, r.distances)])
print('WORKER %d ALL_OK' % rank, flush=True)
import torch.distributed as dist
# a group left alive at exit can abort the process as gloo's threads die
dist.destroy_process_group()
'''


def _free_port():
    s = socket.socket()
    s.bind(('localhost', 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _outputs(d):
    os.makedirs(d, exist_ok=True)
    return {k: os.path.join(d, v) for k, v in (
        ('--distances', 'dist.h5'), ('--assignments', 'assig.h5'),
        ('--center-features', 'centers.pkl'),
        ('--center-indices', 'inds.npy'))}


def _argv(pdb, trjs, out):
    argv = ['cluster', '--trajectories', *trjs, '--topology', pdb,
            '--atoms', 'name CA', '--algorithm', 'khybrid',
            '--cluster-number', '10', '--random-state', '0']
    for k, v in out.items():
        argv += [k, v]
    return argv


def _flat(path):
    """An ``.h5`` output as ``(flat values, row lengths)``."""
    arr = jra.load(path)
    return arr._data, list(arr.lengths)


def _jax_cli(argv, monkeypatch):
    """The JAX package's one-process CLI with its device sweeps (taken
    on a TPU; here forced), over its 8 CPU devices."""
    monkeypatch.setattr(jax_kmedoids, '_tpu_present', lambda: True)
    monkeypatch.setenv('ENSPARA_TPU_CACHE_DIR', '0')
    assert jax_cluster.main(argv) == 0


def test_two_process_cli(tmp_path, monkeypatch):
    """Two processes joined over gloo through ENSPARA_TPU_COORDINATOR,
    2 CPU shards each, cluster 4 XTC files with khybrid: both fit the
    one-process 4-shard result bit for bit, rank 0 alone writes, the
    outputs equal the JAX CLI's, and ctr_ids_mpi in the job equals the
    JAX formula with two processes. In the same job ``hybrid_device`` and
    a cold-start ``kmedoids`` over the job's mesh equal a one-process
    4-shard run."""
    lengths = (150, 170, 140, 160)
    pdb, trjs, _ = write_fixture(tmp_path, seed=3, lengths=lengths)
    n = sum(lengths)
    seed = int(np.random.RandomState(0).randint(2 ** 31))
    n_pad = jmesh.pad_to_multiple(n, len(jax.devices()))
    key = jax.random.PRNGKey(seed)
    bits = np.stack([np.asarray(jax.random.bits(
        jax.random.fold_in(key, s), (n_pad,), jnp.uint32)).astype(np.int64)
        for s in range(5)])
    np.save(str(tmp_path / 'bits.npy'), bits)
    job = {'seed': seed, 'lengths': list(lengths)}
    for r in range(2):
        job['argv%d' % r] = _argv(pdb, trjs, _outputs(tmp_path / ('r%d' % r)))
    (tmp_path / 'job.json').write_text(json.dumps(job))
    X = basin_data(np.random.default_rng(9), 403, 8, n_basins=20,
                   noise=0.1) / 2
    np.save(str(tmp_path / 'X.npy'), X)
    worker = tmp_path / 'worker.py'
    worker.write_text(WORKER)
    port = str(_free_port())
    procs = []
    for r in range(2):
        env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
                   + os.environ.get('PYTHONPATH', ''), OMP_NUM_THREADS='1',
                   ENSPARA_TPU_PLATFORM='cpu',
                   ENSPARA_TPU_COORDINATOR='localhost:' + port,
                   ENSPARA_TPU_NUM_PROCESSES='2',
                   ENSPARA_TPU_PROCESS_ID=str(r),
                   ENSPARA_TPU_LOCAL_SHARDS='2')
        procs.append(subprocess.Popen(
            [sys.executable, str(worker), str(r), str(tmp_path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
            text=True))
    outs = []
    for r, p in enumerate(procs):
        try:
            outs.append(p.communicate(timeout=240)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail('worker %d timed out' % r)
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, 'worker %d failed:\n%s' % (r, out)
        assert ('WORKER %d ALL_OK' % r) in out, out

    # rank 0 alone wrote
    assert sorted(os.listdir(tmp_path / 'r0')) == sorted(
        ['dist.h5', 'assig.h5', 'centers.pkl', 'inds.npy'])
    assert os.listdir(tmp_path / 'r1') == []

    # hybrid_device and kmedoids across the processes: the 4-shard run
    mesh4 = FrameMesh(['cpu'] * 4)
    want = [np.asarray(v) for r in (
        hybrid_device(X, 'rmsd', n_iters=2, n_clusters=8, seed=4,
                      mesh=mesh4),
        kmedoids(X, 'rmsd', n_clusters=8, n_iters=2, random_state=5,
                 mesh=mesh4))
        for v in (r.center_indices, r.assignments, r.distances)]
    for r in range(2):
        got = np.load(str(tmp_path / ('lib%d.npz' % r)))
        for i, w in enumerate(want):
            np.testing.assert_array_equal(got['arr_%d' % i], w)

    # the one-process 4-shard run of the CLI, from the same bits
    def jax_bits(seed_, n_sweeps, n_, device):
        assert seed_ == seed
        for b in bits[:n_sweeps]:
            yield torch.from_numpy(b[:n_])
    monkeypatch.setattr(engine_kmedoids, 'sweep_bits', jax_bits)
    args = cluster.process_command_line(job['argv0'])
    _, data = cluster.util.load_trjs_or_features(args)
    one = cluster.fit(args, data, None, FrameMesh(['cpu'] * 4)).result_
    for r in range(2):
        got = np.load(str(tmp_path / ('res%d.npz' % r)))
        assert (int(got['size']), int(got['first'])) == (4, 2 * r)
        np.testing.assert_array_equal(got['ctr'], np.asarray(
            one.center_indices))
        np.testing.assert_array_equal(got['assig'], one.assignments)
        np.testing.assert_array_equal(got['dist'], one.distances)

    # the JAX package's one-process CLI
    ref = _outputs(tmp_path / 'jax')
    _jax_cli(_argv(pdb, trjs, ref), monkeypatch)
    out0 = _outputs(tmp_path / 'r0')
    np.testing.assert_array_equal(np.load(out0['--center-indices']),
                                  np.load(ref['--center-indices']))
    (pa, pl), (ja, jl) = (_flat(o['--assignments']) for o in (out0, ref))
    assert pl == jl == list(lengths)
    np.testing.assert_array_equal(pa, ja)
    centers = []
    for o in (out0, ref):
        with open(o['--center-features'], 'rb') as f:
            centers.append(pickle.load(f))
    assert len(centers[0]) == len(centers[1]) == 10
    for a, b in zip(*centers):
        np.testing.assert_array_equal(a.xyz, b.xyz)
    assert_rmsd_close(_flat(out0['--distances'])[0],
                      _flat(ref['--distances'])[0], _gsum(data.xyz), N_RES)

    # ctr_ids_mpi in the job: the JAX formula with two processes
    monkeypatch.setattr(jops, '_proc_info', lambda: (0, 2))
    want = [list(t) for t in jax_kmedoids.ctr_ids_mpi(
        np.asarray(one.center_indices), lengths)]
    for r in range(2):
        assert json.loads((tmp_path / ('ctr_ids%d.json' % r))
                          .read_text()) == want


def test_job_checks_and_placement():
    """The CLI's refusal of ``--subsample`` above 1 needs a job that spans
    processes; ``placement`` resolves device= and mesh= as the entry
    points take them."""
    from enspara_tpu_torch.parallel import placement

    job = types.SimpleNamespace(spans_processes=True)
    alone = types.SimpleNamespace(spans_processes=False)
    for mesh, sub, raises in ((job, 2, True), (job, 1, False),
                              (alone, 2, False), (None, 3, False)):
        args = types.SimpleNamespace(subsample=sub)
        if raises:
            with pytest.raises(ImproperlyConfigured, match='subsample'):
                cluster.check_job(args, mesh)
        else:
            cluster.check_job(args, mesh)
    one, four = FrameMesh(['cpu']), FrameMesh(['cpu'] * 4)
    assert placement(None, 'cpu') == ('cpu', None)
    assert placement(one, None) == (torch.device('cpu'), None)
    assert placement(four, None) == (None, four)
    with pytest.raises(ValueError, match='not both'):
        placement(four, 'cpu')
    assert cluster.join_job() is None


@pytest.mark.parametrize('uuids', ['distinct', 'repeated', 'cpu',
                                   'no_nccl'])
def test_job_mesh_takes_nccl_only_for_cards_of_their_own(uuids,
                                                         monkeypatch):
    """``job_mesh``'s decision for a 4-process job: every lead card
    distinct (by UUID) makes one NCCL group, set on the lead card and
    checked with one all_reduce over it; a repeated card, or CPU shards,
    keep the gloo world group and make no group. Where the NCCL group
    cannot be made, the job raises rather than staying on gloo."""
    import torch.distributed as dist
    from enspara_tpu_torch.parallel import mesh as pmesh

    world, calls = object(), []
    lead = 'cpu' if uuids == 'cpu' else 'cuda:0'
    monkeypatch.setattr(pmesh, 'frame_mesh',
                        lambda n=None: FrameMesh([lead], world))
    monkeypatch.setattr(dist, 'get_world_size', lambda group=None: 4)
    monkeypatch.setattr(dist, 'get_rank', lambda group=None: 2)
    monkeypatch.setattr(torch.cuda, 'get_device_properties',
                        lambda d: types.SimpleNamespace(uuid='GPU-2'))

    def gather(out, obj, group=None):
        calls.append(('all_gather_object', obj, group))
        out[:] = (['GPU-0', 'GPU-1', 'GPU-2', 'GPU-2'] if uuids == 'repeated'
                  else ['GPU-%d' % r for r in range(4)])

    def new_group(**kw):
        calls.append(('new_group', kw))
        if uuids == 'no_nccl':
            raise RuntimeError('Distributed package doesn\'t have NCCL')
        return 'nccl-group'

    def all_reduce(t, group=None):
        calls.append(('all_reduce', t.tolist(), group))
        t.mul_(4)

    real_ones = torch.ones
    monkeypatch.setattr(dist, 'all_gather_object', gather)
    monkeypatch.setattr(dist, 'new_group', new_group)
    monkeypatch.setattr(dist, 'all_reduce', all_reduce)
    monkeypatch.setattr(torch.cuda, 'set_device',
                        lambda d: calls.append(('set_device', str(d))))
    # the CPU build allocates nothing on a card: the one-element tensor
    # of the check lies on the CPU here
    monkeypatch.setattr(torch, 'ones', lambda *a, device=None, **kw:
                        real_ones(*a, **kw))

    if uuids == 'no_nccl':
        with pytest.raises(RuntimeError, match='NCCL'):
            pmesh.job_mesh()
        assert calls[-1] == ('new_group', {'backend': 'nccl'})
        return
    mesh = pmesh.job_mesh()
    assert (mesh.size, mesh.first_shard) == (4, 2)
    assert mesh.devices == (torch.device(lead),)
    if uuids == 'distinct':
        assert mesh.group == 'nccl-group'
        assert calls == [('all_gather_object', 'GPU-2', world),
                         ('set_device', 'cuda:0'),
                         ('new_group', {'backend': 'nccl'}),
                         ('all_reduce', [1.0], 'nccl-group')]
    else:
        assert mesh.group is world
        assert calls == ([] if uuids == 'cpu' else
                         [('all_gather_object', 'GPU-2', world)])
