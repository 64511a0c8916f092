"""The port's spans (``util.log.trace_region``) under a CPU
``torch.profiler``.

A span is a CPU op on the profiler's clock, never a user annotation,
nested under the range open around it, and nothing without a profiler.
The device PAM sweeps record one ``enspara/pam.read`` per host read that
``_pam_sweeps.n_host_syncs`` counts, each read, try and repair inside a
``enspara/pam.batch``; k-hybrid records its k-centers stage, each
chunk of the k-centers loop inside it, then its PAM stage; a warm start
records its host search for the init centers' frames before the first
chunk; the batched timescales record their host preparation before the
first count. In a job of two processes over gloo the sharded k-centers
loop is one ``enspara/kcenters.sharded`` span, each global argmax an
``enspara/kcenters.global_best`` span and each collective an
``enspara/mesh.*`` span, as many as ``FrameMesh.n_collectives`` counts.
Results under the profiler equal those without it, bit for bit. On the
card (the ``cuda`` test; this file imports no jax, run
it there with ``python -m pytest --noconftest -m cuda
tests/test_torch_spans.py``) no span reaches the device's timeline.
"""

import importlib
import json
import os
import socket
import subprocess
import sys
import types

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from enspara_tpu_torch.cluster import (engine, engine_kmedoids, hybrid,
                                       hybrid_device, kcenters)
from enspara_tpu_torch.msm.eigen_device import implied_timescales_batched
from enspara_tpu_torch.parallel import FrameMesh
from enspara_tpu_torch.util import log

N, K = 600, 20


@pytest.fixture(autouse=True)
def _cpu_platform(monkeypatch):
    """Host inputs run on the CPU in these tests, on one thread: the
    tier-1 run puts several test workers on one host's cores."""
    monkeypatch.setenv('ENSPARA_TPU_PLATFORM', 'cpu')
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def frames(seed=0, n=N, atoms=8, n_basins=12, dwell=40):
    """Temporally ordered metastable-basin frames."""
    rng = np.random.default_rng(seed)
    templates = rng.normal(size=(n_basins, atoms, 3)).astype(np.float32)
    seg = np.cumsum(rng.random(n) < 1.0 / dwell)
    basin = rng.integers(0, n_basins, size=seg.max() + 1)[seg]
    return (templates[basin]
            + 0.3 * rng.normal(size=(n, atoms, 3)).astype(np.float32))


def traced(fn):
    """``(fn(), events)`` with ``fn`` run under a CPU profiler."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, list(prof.events())


def named(events, name):
    return sorted((e for e in events if e.name == name),
                  key=lambda e: e.time_range.start)


def within(inner, outer):
    return (outer.time_range.start <= inner.time_range.start
            and inner.time_range.end <= outer.time_range.end)


def test_span_is_a_cpu_op_nested_under_its_range():
    def run():
        with record_function('outer'):
            with log.trace_region('enspara/test.span'):
                torch.ones(8).sum()
    _, events = traced(run)
    span, = named(events, 'enspara/test.span')
    outer, = named(events, 'outer')
    assert span.device_type == DeviceType.CPU
    assert not span.is_user_annotation
    assert span.cpu_parent.name == 'outer' and within(span, outer)
    assert any(e.name == 'aten::sum' and within(e, span) for e in events)


def test_span_without_a_profiler_records_nothing():
    with log.trace_region('enspara/test.unseen'):
        torch.ones(8).sum()
    with pytest.raises(KeyError):
        with log.trace_region('enspara/test.raised'):
            raise KeyError('passes through')

    def run():
        with log.trace_region('enspara/test.seen'):
            pass
    _, events = traced(run)
    assert [e.name for e in events if e.name.startswith('enspara/')] == \
        ['enspara/test.seen']


def sweeps(X, mesh=None, device=None):
    warm = kcenters(X, 'rmsd', n_clusters=K, device=device)
    return lambda: engine_kmedoids.kmedoids_sweeps_device(
        X, 'rmsd', warm.assignments, warm.distances, warm.center_indices,
        n_sweeps=3, seed=5, proposal_batch=8, device=device, mesh=mesh)


@pytest.mark.parametrize('shards', [None, 2])
def test_pam_reads_are_the_host_syncs(shards):
    mesh = None if shards is None else FrameMesh(['cpu'] * shards)
    run = sweeps(frames(), mesh)
    plain = run()
    before = engine_kmedoids._pam_sweeps.n_host_syncs
    out, events = traced(run)
    n_syncs = engine_kmedoids._pam_sweeps.n_host_syncs - before
    for a, b in zip(out, plain):
        np.testing.assert_array_equal(a, b)
    batches = named(events, 'enspara/pam.batch')
    reads = named(events, 'enspara/pam.read')
    inner = {name: named(events, 'enspara/pam.' + name)
             for name in ('read', 'try', 'repair')}
    assert len(reads) == n_syncs > 0
    assert len(batches) == 3 * ((K + 7) // 8)
    assert all(inner.values()), {n: len(v) for n, v in inner.items()}
    for evs in inner.values():
        for e in evs:
            assert any(within(e, b) for b in batches), e.name


@pytest.fixture
def device_sweeps(monkeypatch):
    """PAM on CPU frames takes the device sweeps, as frames on a card
    do."""
    mod = importlib.import_module('enspara_tpu_torch.cluster.kmedoids')
    monkeypatch.setattr(mod, 'resolve_device',
                        lambda X, device=None: types.SimpleNamespace(
                            type='cuda'))


@pytest.mark.parametrize('path', ['host PAM', 'device sweeps',
                                  'hybrid_device'])
def test_khybrid_spans_kcenters_then_pam(path, request):
    X = frames(1)
    if path == 'hybrid_device':
        def run():
            return hybrid_device(X, 'rmsd', n_iters=2, n_clusters=K, seed=3)
    else:
        if path == 'device sweeps':
            request.getfixturevalue('device_sweeps')

        def run():
            return hybrid(X, 'rmsd', n_iters=2, n_clusters=K,
                          random_state=3)
    plain = run()
    out, events = traced(run)
    np.testing.assert_array_equal(out.center_indices, plain.center_indices)
    np.testing.assert_array_equal(out.assignments, plain.assignments)
    np.testing.assert_array_equal(out.distances, plain.distances)
    kc, = named(events, 'enspara/khybrid.kcenters')
    pam, = named(events, 'enspara/khybrid.pam')
    assert kc.time_range.end <= pam.time_range.start
    chunks = named(events, 'enspara/kcenters.chunk')
    assert chunks and all(within(c, kc) for c in chunks)
    has_reads = bool(named(events, 'enspara/pam.read'))
    assert has_reads == (path != 'host PAM')


@pytest.mark.parametrize('n_clusters,random_first', [(K, False),
                                                     (150, True)])
def test_kcenters_chunks_are_spans(n_clusters, random_first):
    X = frames(2)

    def run():
        return kcenters(X, 'rmsd', n_clusters=n_clusters,
                        random_first_center=random_first, random_state=4)
    plain = run()
    out, events = traced(run)
    np.testing.assert_array_equal(out.center_indices, plain.center_indices)
    np.testing.assert_array_equal(out.assignments, plain.assignments)
    np.testing.assert_array_equal(out.distances, plain.distances)
    chunks = named(events, 'enspara/kcenters.chunk')
    assert len(chunks) == -(-n_clusters // engine.CHUNK)
    for a, b in zip(chunks, chunks[1:]):
        assert a.time_range.end <= b.time_range.start
    # the loop's work, from the first chunk to the last, is in chunks
    loop = [e for e in events if e.name.startswith('aten::')
            and chunks[0].time_range.start <= e.time_range.start
            <= chunks[-1].time_range.end]
    assert loop and all(any(within(e, c) for c in chunks) for e in loop)
    init = named(events, 'enspara/kcenters.init_centers')
    assert len(init) == int(random_first)
    assert all(e.time_range.end <= chunks[0].time_range.start
               for e in init)


def test_msm_prepare_ends_before_the_first_count():
    rng = np.random.default_rng(2)
    assigns = [rng.integers(0, 6, size=n) for n in (300, 250, 180)]
    lags = [1, 3, 5]
    plain = implied_timescales_batched(assigns, lags, n_times=3)
    out, events = traced(
        lambda: implied_timescales_batched(assigns, lags, n_times=3))
    np.testing.assert_array_equal(out, plain)
    prep, = named(events, 'enspara/msm.prepare')
    counts = named(events, 'aten::index_add_')
    assert len(counts) == len(lags)
    assert prep.time_range.end <= counts[0].time_range.start
    outside = [e for e in events if e.name.startswith('aten::')
               and not within(e, prep)]
    assert all(e.time_range.start >= prep.time_range.end for e in outside)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (torch.cuda.is_available() is '
                    'False)')
    return torch.device('cuda')


@pytest.mark.cuda
def test_spans_never_reach_the_device_timeline(cuda):
    run = sweeps(frames(), device=cuda)
    plain = run()
    before = engine_kmedoids._pam_sweeps.n_host_syncs
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = run()
        torch.cuda.synchronize()
    events = list(prof.events())
    n_syncs = engine_kmedoids._pam_sweeps.n_host_syncs - before
    for a, b in zip(out, plain):
        np.testing.assert_array_equal(a, b)
    device = [e for e in events if e.device_type == DeviceType.CUDA]
    assert device and not [e for e in device
                           if e.name.startswith('enspara/')]
    reads = named(events, 'enspara/pam.read')
    assert len(reads) == n_syncs > 0
    assert all(e.device_type == DeviceType.CPU and not e.is_user_annotation
               for e in reads)


SHARDED_WORKER = r'''
import json, sys
import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile
from enspara_tpu_torch.apps.cluster import join_job
from enspara_tpu_torch.cluster import KCenters, engine
torch.set_num_threads(1)
mesh = join_job()
X = np.load(sys.argv[1])
k = int(sys.argv[2])


def fit():
    return KCenters(metric='rmsd', n_clusters=k, random_first_center=True,
                    random_state=5, mesh=mesh).fit(X).result_


plain = fit()
before = mesh.n_collectives
with profile(activities=[ProfilerActivity.CPU]) as prof:
    res = fit()
evs = sorted((e for e in prof.events() if e.name.startswith('enspara/')),
             key=lambda e: e.time_range.start)
loop = [e for e in evs if e.name == 'enspara/kcenters.sharded']
best = [e for e in evs if e.name == 'enspara/kcenters.global_best']


def inside(e, spans):
    return any(s.time_range.start <= e.time_range.start
               and e.time_range.end <= s.time_range.end for s in spans)


mesh_evs = [e for e in evs if e.name.startswith('enspara/mesh.')]
print(json.dumps(dict(
    same=bool(np.array_equal(res.center_indices, plain.center_indices)
              and np.array_equal(res.distances, plain.distances)),
    spans_processes=mesh.spans_processes,
    n_loop=len(loop), n_best=len(best),
    in_loop={n: sum(1 for e in mesh_evs if e.name == n and inside(e, loop))
             for n in ('enspara/mesh.all_reduce', 'enspara/mesh.all_gather')},
    gathers_in_best=sum(1 for e in mesh_evs
                        if e.name == 'enspara/mesh.all_gather'
                        and inside(e, best)),
    n_mesh=len(mesh_evs), counted=mesh.n_collectives - before,
    fit_collectives=engine.kcenters_device_fused.n_collectives)))
'''


def _free_port():
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return str(s.getsockname()[1])


def test_sharded_kcenters_spans_its_collectives(tmp_path):
    """Two processes of one CPU shard each over gloo: one loop span, a
    global-best span for the first center's search and each iteration,
    two collectives an iteration and the final sum of skipped tiles
    inside the loop (each gather inside a global-best span), every
    collective of the fit a span and a count; the fit adds the two
    fetches of its results to the loop's."""
    k = 12
    np.save(str(tmp_path / 'X.npy'), frames(3, n=400))
    worker = tmp_path / 'worker.py'
    worker.write_text(SHARDED_WORKER)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    port = _free_port()
    procs = []
    for r in range(2):
        env = dict(os.environ, PYTHONPATH=repo + os.pathsep
                   + os.environ.get('PYTHONPATH', ''), OMP_NUM_THREADS='1',
                   ENSPARA_TPU_PLATFORM='cpu',
                   ENSPARA_TPU_COORDINATOR='localhost:' + port,
                   ENSPARA_TPU_NUM_PROCESSES='2',
                   ENSPARA_TPU_PROCESS_ID=str(r),
                   ENSPARA_TPU_LOCAL_SHARDS='1')
        procs.append(subprocess.Popen(
            [sys.executable, str(worker), str(tmp_path / 'X.npy'), str(k)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
            text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
        got = json.loads(out.strip().splitlines()[-1])
        assert got['same'] and got['spans_processes']
        iters = k - 1           # the first center is the seeded start
        assert got['n_loop'] == 1 and got['n_best'] == iters + 1
        assert got['in_loop'] == {'enspara/mesh.all_reduce': iters + 1,
                                  'enspara/mesh.all_gather': iters + 1}
        assert got['gathers_in_best'] == iters + 1
        assert got['n_mesh'] == got['counted']
        assert got['fit_collectives'] == 2 * (iters + 1) + 2
