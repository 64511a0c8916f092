"""The k-centers warm start on the devices: the assignment to the init
centers stays per shard where it was computed, each init center's frame
comes from a per-shard first minimum and one cross-shard argmax
(``engine._first_minima``), and the loop starts from the assignment's
own tensors.

Imports no jax: on the card machine, run with
``python -m pytest --noconftest -m cuda tests/test_torch_warm_start.py``.

On the CPU, against the host search it replaces (the assignment fetched,
``util.find_cluster_centers`` on it, the loop started from host arrays):
the same centers, labels and distances byte for byte, for RMSD and
euclidean frames, one device and meshes of 2 and 4 shards, 1 and 3 init
centers, and two processes over gloo, with
``_kcenters_fast.n_host_warm_starts`` at 0. The ``cuda`` tests skip
without a card: on one card, and in two processes over NCCL, no
card-to-host copy of ``n`` or more bytes between the warm start's start
and the loop's, and the host path's results bit for bit.

The other cases use these helpers from files of their own, each under
the size ROADMAP's "order of the test run" hazard allows:
``tests/test_torch_warm_start_ties.py`` (a tie across a shard boundary,
the search alone on labels full of ties) and
``tests/test_torch_warm_start_host.py`` (ownerless init centers, the
locality-sorted layout through the host, bf16 frames).
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from enspara_tpu_torch.cluster import engine, util
from enspara_tpu_torch.cluster.kcenters import _kcenters_fast, kcenters
from enspara_tpu_torch.parallel import FrameMesh

from test_torch_port import basin_data

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K = 40


@pytest.fixture(autouse=True)
def _cpu_platform(monkeypatch):
    """Host inputs run on the CPU in these tests; torch on one thread
    (the tier-1 run puts several test workers on one host's cores)."""
    monkeypatch.setenv('ENSPARA_TPU_PLATFORM', 'cpu')
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (torch.cuda.is_available() is '
                    'False)')
    return torch.device('cuda', 0)


def _where(shards, device='cpu'):
    """Keywords placing a job on one device or a mesh of ``shards``."""
    if shards == 1:
        return dict(device=torch.device(device))
    return dict(mesh=FrameMesh([device] * shards))


def _frames(metric, n=3000, seed=0):
    rng = np.random.default_rng(seed)
    if metric == 'rmsd':
        return basin_data(rng, n, 8, n_basins=30, noise=0.3)
    centers = rng.normal(size=(30, 6)).astype(np.float32)
    return (centers[rng.integers(0, 30, size=n)]
            + 0.3 * rng.normal(size=(n, 6))).astype(np.float32)


def _host_path(X, metric, init, k, sort=None, precision='fp32', **where):
    """The warm start through the host: the assignment (float32 frames)
    fetched, the host's first-minimum search, the loop started from host
    arrays on frames of ``precision``."""
    a, d = engine.assign_device(X, np.stack(init), metric, **where)
    inds = util.find_cluster_centers(a, d)
    assert len(inds) == len(init)
    if metric == 'rmsd':
        prep = engine.prepare_rmsd_frames(X, sort=sort, precision=precision,
                                          **where)
    else:
        prep = engine.prepare_sharded(X, metric, **where)
    return engine.kcenters_device(
        prep, metric, n_clusters=k, init_distances=d, init_assignments=a,
        n_init_centers=len(init), init_center_indices=inds,
        mesh=where.get('mesh'), sort=sort)


def _assert_same(res, ref):
    np.testing.assert_array_equal(np.asarray(res.center_indices),
                                  ref.center_indices)
    np.testing.assert_array_equal(res.assignments, ref.assignments)
    np.testing.assert_array_equal(res.distances, ref.distances)


def _boundary(metric, n, shards):
    """The first global index of shard 1 of the layout of ``n`` frames
    over ``shards`` shards (of a 2-shard layout on one device)."""
    prep = (engine.prepare_rmsd_frames if metric == 'rmsd' else
            (lambda X, **w: engine.prepare_sharded(X, metric, **w)))(
        _frames(metric, n), **_where(max(shards, 2)))
    return engine._shards(prep)[1]


@pytest.mark.parametrize('metric', ['rmsd', 'euclidean'])
@pytest.mark.parametrize('shards', [1, 2, 4])
@pytest.mark.parametrize('n_init', [1, 3])
def test_device_warm_start_equals_host_search(metric, shards, n_init):
    X = _frames(metric)
    init = [X[i] for i in (7, 1500, 2950)[:n_init]]
    where = _where(shards)
    res = kcenters(X, metric, n_clusters=K, init_centers=init, **where)
    assert _kcenters_fast.n_host_warm_starts == 0
    _assert_same(res, _host_path(X, metric, init, K, **where))


GLOO_WORKER = r'''
import json, sys
import numpy as np
import torch
torch.set_num_threads(1)
from enspara_tpu_torch.apps.cluster import join_job
from enspara_tpu_torch.cluster import engine, util
from enspara_tpu_torch.cluster.kcenters import _kcenters_fast, kcenters
mesh = join_job()
X = np.load(sys.argv[1])
init = [X[7], X[600], X[1190]]
res = kcenters(X, 'rmsd', n_clusters=30, init_centers=init, mesh=mesh)
a, d = engine.assign_device(X, np.stack(init), 'rmsd', mesh=mesh)
inds = util.find_cluster_centers(a, d)
ref = engine.kcenters_device(
    engine.prepare_rmsd_frames(X, mesh=mesh), 'rmsd', n_clusters=30,
    init_distances=d, init_assignments=a, n_init_centers=3,
    init_center_indices=inds, mesh=mesh)
print(json.dumps(dict(
    host=_kcenters_fast.n_host_warm_starts,
    spans_processes=mesh.spans_processes,
    same=bool(np.array_equal(res.center_indices, ref.center_indices)
              and np.array_equal(res.assignments, ref.assignments)
              and np.array_equal(res.distances, ref.distances)))))
'''


def _free_port():
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return str(s.getsockname()[1])


def _two_processes(tmp_path, worker_src, args, env_of, timeout):
    """Run ``worker_src`` as ranks 0 and 1 of a two-process job (``env_of(r)``
    sets rank r's variables, None removing one) and return each rank's
    last line, parsed as JSON."""
    worker = tmp_path / 'worker.py'
    worker.write_text(worker_src)
    port = _free_port()
    procs = []
    for r in range(2):
        env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
                   + os.environ.get('PYTHONPATH', ''),
                   ENSPARA_TPU_COORDINATOR='localhost:' + port,
                   ENSPARA_TPU_NUM_PROCESSES='2',
                   ENSPARA_TPU_PROCESS_ID=str(r))
        for name, value in env_of(r).items():
            if value is None:
                env.pop(name, None)
            else:
                env[name] = value
        procs.append(subprocess.Popen(
            [sys.executable, str(worker)] + [a.format(r=r) for a in args],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
            text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    got = []
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
        got.append(json.loads(out.strip().splitlines()[-1]))
    return got


def test_two_processes_over_gloo_equal_host_search(tmp_path):
    """Two processes of one CPU shard each: three init centers found by
    one cross-process argmax, the results the host path's."""
    np.save(str(tmp_path / 'X.npy'), _frames('rmsd', n=1200))
    got = _two_processes(
        tmp_path, GLOO_WORKER, [str(tmp_path / 'X.npy')],
        lambda r: dict(OMP_NUM_THREADS='1', ENSPARA_TPU_PLATFORM='cpu',
                       ENSPARA_TPU_LOCAL_SHARDS='1'), 240)
    for g in got:
        assert g == dict(host=0, spans_processes=True, same=True)


# ---------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------

def dtoh_bytes_in_warm_start(trace_path, loop_span):
    """The largest card-to-host copy (bytes) of a Chrome trace that
    starts between the start of the first ``enspara/kcenters.warm_start``
    span and the start of the first ``loop_span`` after it."""
    with open(trace_path) as f:
        evs = json.load(f)['traceEvents']
    host = [e for e in evs if e.get('ph') == 'X'
            and not e.get('cat', '').startswith('gpu')]
    ws = min(float(e['ts']) for e in host
             if e['name'] == 'enspara/kcenters.warm_start')
    loop = min(float(e['ts']) for e in host
               if e['name'] == loop_span and float(e['ts']) > ws)
    return max([int(e.get('args', {}).get('bytes', 0)) for e in evs
                if e.get('cat') == 'gpu_memcpy' and 'DtoH' in e['name']
                and ws <= float(e['ts']) <= loop] + [0])


@pytest.mark.cuda
def test_cuda_warm_start_reads_no_frame_array(cuda, tmp_path, monkeypatch):
    """One card, 12,000 frames from a random first center: no
    card-to-host copy of ``n`` bytes or more between the warm start's
    start and the loop's first chunk, and the host path's results."""
    from torch.profiler import ProfilerActivity, profile
    monkeypatch.delenv('ENSPARA_TPU_PLATFORM')
    n = 12_000
    X = basin_data(np.random.default_rng(14), n, 16, n_basins=40)
    first = int(np.random.default_rng(5).integers(n))

    def fit():
        return kcenters(X, 'rmsd', n_clusters=150, random_first_center=True,
                        random_state=5, device=cuda)
    fit()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        res = fit()
        torch.cuda.synchronize()
    path = str(tmp_path / 'trace.json')
    prof.export_chrome_trace(path)
    assert _kcenters_fast.n_host_warm_starts == 0
    assert dtoh_bytes_in_warm_start(path, 'enspara/kcenters.chunk') < n
    _assert_same(res, _host_path(X, 'rmsd', [X[first]], 150, device=cuda))


NCCL_WORKER = r'''
import json, sys
import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile
sys.path.insert(0, sys.argv[3])
from test_torch_warm_start import dtoh_bytes_in_warm_start
from enspara_tpu_torch.apps.cluster import join_job
from enspara_tpu_torch.cluster import KCenters, engine, util
from enspara_tpu_torch.cluster.kcenters import _kcenters_fast
mesh = join_job()
X = np.load(sys.argv[1])
n = len(X)


def fit():
    return KCenters(metric='rmsd', n_clusters=150, random_first_center=True,
                    random_state=5, mesh=mesh).fit(X).result_


fit()
with profile(activities=[ProfilerActivity.CPU,
                         ProfilerActivity.CUDA]) as prof:
    res = fit()
    torch.cuda.synchronize()
prof.export_chrome_trace(sys.argv[2])
big = dtoh_bytes_in_warm_start(sys.argv[2], 'enspara/kcenters.sharded')
init = X[int(np.random.default_rng(5).integers(n))][None]
a, d = engine.assign_device(X, init, 'rmsd', mesh=mesh)
ref = engine.kcenters_device(
    engine.prepare_rmsd_frames(X, mesh=mesh), 'rmsd', n_clusters=150,
    init_distances=d, init_assignments=a, n_init_centers=1,
    init_center_indices=util.find_cluster_centers(a, d), mesh=mesh)
print(json.dumps(dict(
    backend=mesh.backend, big=big, n=n,
    host=_kcenters_fast.n_host_warm_starts,
    same=bool(np.array_equal(res.center_indices, ref.center_indices)
              and np.array_equal(res.assignments, ref.assignments)
              and np.array_equal(res.distances, ref.distances)))))
torch.distributed.destroy_process_group()
'''


@pytest.mark.cuda
def test_cuda_two_processes_over_nccl_read_no_frame_array(cuda, tmp_path):
    """Two processes, a card each, over NCCL (the benchmark's path): no
    card-to-host copy of ``n`` bytes or more between the warm start's
    start and the sharded loop's, and the host path's results."""
    if torch.cuda.device_count() < 2:
        pytest.skip('needs two CUDA devices, %d visible'
                    % torch.cuda.device_count())
    X = basin_data(np.random.default_rng(15), 12_000, 16, n_basins=40)
    np.save(str(tmp_path / 'X.npy'), X)

    def env_of(r):
        return dict(CUDA_VISIBLE_DEVICES=str(r), ENSPARA_TPU_PLATFORM=None,
                    ENSPARA_TPU_LOCAL_SHARDS=None)
    got = _two_processes(
        tmp_path, NCCL_WORKER,
        [str(tmp_path / 'X.npy'), str(tmp_path / 'trace{r}.json'),
         os.path.join(REPO, 'tests')], env_of, 300)
    for g in got:
        assert g['backend'] == 'nccl' and g['host'] == 0 and g['same']
        assert g['big'] < g['n']
