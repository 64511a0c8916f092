"""The sharded k-centers loop's CUDA graph: one capture of ``CHUNK``
steps a fit, replayed for every later chunk, collectives included.

Imports no jax: on the card machine, run with
``python -m pytest --noconftest -m cuda tests/test_torch_kcenters_graph.py``.

On the CPU: the layout rule that picks the graph (CPU shards, a gloo
group and shards on several cards run eagerly; shards of one card with
no group or an NCCL one take the graph), and the loop's chunk logic with
a stand-in that replays a chunk by running its steps eagerly: the same
bits as the eager loop, the replays counted. The ``cuda`` tests skip
without a card: four virtual shards of one card take the graph and
equal the eager loop on the same shards bit for bit, and the one-card
loop in centers and labels (distances on the msd bar), for 150 centers
from one seeded center (two replays, the second with a no-op tail), a
``dist_cutoff`` that stops mid-chunk, ``tri_skip=False`` and bf16
frames; with two cards, two processes over NCCL equal the in-process
run on both cards (eager) bit for bit and count the collectives that
ran.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from enspara_tpu_torch.cluster import engine
from enspara_tpu_torch.ops import kcenters_step, qcp_update
from enspara_tpu_torch.parallel import FrameMesh

from test_torch_port import assert_rmsd_close, basin_data

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (torch.cuda.is_available() is '
                    'False)')
    return torch.device('cuda', 0)


def _card(i):
    return torch.device('cuda', i)


# (mesh devices, the local shards' devices, the group's backend or None,
#  whether the loop takes the graph)
LAYOUTS = {
    'cpu shards': (['cpu'] * 4, ['cpu'] * 4, None, False),
    'cpu shard a process over gloo': (['cpu'], ['cpu'], 'gloo', False),
    'a card a process over gloo': ([_card(0)], [_card(0)], 'gloo', False),
    'two cards in one process': ([_card(0), _card(1)],
                                 [_card(0), _card(1)], None, False),
    'shards off the lead card': ([_card(0)] * 2, [_card(1)] * 2, None,
                                 False),
    'virtual shards of one card': ([_card(0)] * 4, [_card(0)] * 4, None,
                                   True),
    'a card a process over nccl': ([_card(0)], [_card(0)], 'nccl', True),
}


@pytest.mark.parametrize('layout', list(LAYOUTS))
def test_graph_layout_rule(layout, monkeypatch):
    devices, shards, backend, want = LAYOUTS[layout]
    monkeypatch.setattr(torch.distributed, 'get_backend',
                        lambda group=None: backend)
    mesh = FrameMesh(devices, group=object() if backend else None)
    assert mesh.backend == backend
    assert engine._graph_fits(mesh, shards) is want


class _EagerChunks:
    """A CPU stand-in for ``engine._ChunkGraph``: a replay runs the
    ``CHUNK`` steps eagerly into the static state, as the graph does."""
    made = 0

    def __init__(self, step, state, mesh):
        type(self).made += 1
        self.step = step
        self.state = tuple(t.clone() for t in state)

    def replay(self):
        out = self.state
        for _ in range(engine.CHUNK):
            out = self.step(*out)
        for t, o in zip(self.state, out):
            t.copy_(o)
        return self.state

    def release(self):
        self.state = None


def _seeded(X, k=None, cutoff=None, **where):
    """K-centers from frame 0 as one seeded center (its distances and
    labels the warm start) to ``k`` centers or ``cutoff``."""
    one = engine.kcenters_device_fused(X, n_clusters=1, **where)
    return engine.kcenters_device_fused(
        X, n_clusters=k, dist_cutoff=cutoff, init_distances=one.distances,
        init_assignments=one.assignments, n_init_centers=1,
        init_center_indices=one.center_indices, **where)


def _radius(X, k, **where):
    """The largest distance to the nearest of ``k`` centers: a cutoff
    that stops the loop at ``k`` centers."""
    return float(np.float32(_seeded(X, k, **where).distances.max()))


@pytest.mark.parametrize('case,replays', [('k', 2), ('cutoff', 1)])
def test_chunk_replays_equal_eager_on_cpu(case, replays, monkeypatch):
    """With the stand-in replaying chunks, the loop on four CPU shards
    gives the eager loop's bits: 150 centers from one seeded center
    (an eager chunk, then two replays, the last with a no-op tail) and a
    cutoff met at 100 centers, mid-chunk (one replay)."""
    X = basin_data(np.random.default_rng(11), 4_000, 8, n_basins=40,
                   noise=0.3)
    mesh = FrameMesh(['cpu'] * 4)
    kw = dict(k=150) if case == 'k' else dict(
        cutoff=_radius(X, 100, mesh=mesh))
    eager = _seeded(X, mesh=mesh, **kw)
    assert engine.kcenters_device_fused.n_replays == 0
    monkeypatch.setattr(engine, '_graph_fits', lambda mesh, devices: True)
    monkeypatch.setattr(engine, '_ChunkGraph', _EagerChunks)
    _EagerChunks.made = 0
    got = _seeded(X, mesh=mesh, **kw)
    assert _EagerChunks.made == 1
    assert engine.kcenters_device_fused.n_replays == replays
    assert got.n_found == eager.n_found == (150 if case == 'k' else 100)
    for x, y in zip(got, eager):
        np.testing.assert_array_equal(x, y)


def _launches():
    return (kcenters_step.kcenters_iteration_skip.n_launches,
            qcp_update.kcenters_iteration.n_launches)


CARD_CASES = {
    # name: (frames' precision, tri_skip, centers or None, cutoff at
    #        this many centers or None, replays)
    'fp32 150 centers': ('fp32', True, 150, None, 2),
    'fp32 cutoff': ('fp32', True, None, 100, 1),
    'fp32 tri_skip=False': ('fp32', False, 150, None, 2),
    'bf16 150 centers': ('bf16', True, 150, None, 2),
}


@pytest.mark.cuda
@pytest.mark.parametrize('case', list(CARD_CASES))
def test_cuda_graph_equals_eager_and_one_card(cuda, case, monkeypatch):
    """Four virtual shards of the card take the graph: the replays the
    case needs, 64 steps of four launches each (the eager chunk and
    every replay's, no-op steps included); the same bits as the eager
    loop on those shards, and the one-card loop's centers and labels,
    its distances on the msd bar."""
    precision, skip, k, at, replays = CARD_CASES[case]
    X = basin_data(np.random.default_rng(12), 12_000, 16, n_basins=40)
    mesh = FrameMesh([cuda] * 4)
    prep = engine.prepare_rmsd_frames(X, mesh=mesh, precision=precision)
    # 99 steps from the seeded center: an eager chunk and an eager tail
    cutoff = None if at is None else _radius(prep, at, mesh=mesh)
    seed = engine.kcenters_device_fused(prep, n_clusters=1, mesh=mesh)

    def fit():
        before = _launches()
        res = engine.kcenters_device_fused(
            prep, n_clusters=k, dist_cutoff=cutoff,
            init_distances=seed.distances, init_assignments=seed.assignments,
            n_init_centers=1, init_center_indices=seed.center_indices,
            tri_skip=skip, mesh=mesh)
        torch.cuda.synchronize()
        return res, [b - a for a, b in zip(before, _launches())]
    graph, lg = fit()
    assert engine.kcenters_device_fused.n_replays == replays
    monkeypatch.setattr(engine, '_graph_fits', lambda mesh, devices: False)
    eager, le = fit()
    assert engine.kcenters_device_fused.n_replays == 0
    assert graph.n_found == eager.n_found == (k or at)
    # the eager loop runs a step an iteration up to n_clusters, whole
    # chunks towards a cutoff (its no-op steps too)
    steps = [4 * 64 * (1 + replays),
             4 * (k - 1) if k else 4 * 64 * (1 + replays)]
    assert (lg, le) == tuple([s, 0] if skip else [0, s] for s in steps)
    for x, y in zip(graph, eager):
        np.testing.assert_array_equal(x, y)
    ref = _seeded(engine.prepare_rmsd_frames(X, device=cuda,
                                             precision=precision),
                  graph.n_found)
    np.testing.assert_array_equal(graph.center_indices, ref.center_indices)
    np.testing.assert_array_equal(graph.assignments, ref.assignments)
    Xc = X - X.mean(axis=1, keepdims=True)
    assert_rmsd_close(graph.distances, ref.distances,
                      2 * float((Xc * Xc).sum((1, 2)).max()), 16)


NCCL_WORKER = r'''
import json, sys
import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile
from enspara_tpu_torch.apps.cluster import join_job
from enspara_tpu_torch.cluster import engine
mesh = join_job()
X = np.load(sys.argv[1])
one = engine.kcenters_device_fused(X, n_clusters=1, mesh=mesh)
before = mesh.n_collectives
with profile(activities=[ProfilerActivity.CPU]) as prof:
    res = engine.kcenters_device_fused(
        X, n_clusters=int(sys.argv[2]), init_distances=one.distances,
        init_assignments=one.assignments, n_init_centers=1,
        init_center_indices=one.center_indices, mesh=mesh)
torch.cuda.synchronize()
names = [e.name for e in prof.events() if e.name.startswith('enspara/')]
np.savez(sys.argv[3], ctr=res.center_indices, dist=res.distances,
         assig=res.assignments)
print('RESULT ' + json.dumps(dict(
    backend=mesh.backend, counted=mesh.n_collectives - before,
    fit_collectives=engine.kcenters_device_fused.n_collectives,
    replays=engine.kcenters_device_fused.n_replays,
    spans={n: names.count(n) for n in set(names)})), flush=True)
torch.distributed.destroy_process_group()
'''


def _free_port():
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return str(s.getsockname()[1])


@pytest.mark.cuda
def test_cuda_two_processes_over_nccl_equal_in_process(cuda, tmp_path):
    """Two processes, a card each, over NCCL: the graph (one capture,
    two replays for 150 centers from one seeded center) gives the
    in-process eager run over both cards bit for bit; the collectives
    counted are those that ran (two a step of the eager chunk and of
    each replay, the first search, the sum of skipped tiles, the two
    fetches), the spans those the host issued (the capture's too)."""
    if torch.cuda.device_count() < 2:
        pytest.skip('needs two CUDA devices, %d visible'
                    % torch.cuda.device_count())
    X = basin_data(np.random.default_rng(13), 12_000, 16, n_basins=40)
    np.save(str(tmp_path / 'X.npy'), X)
    worker = tmp_path / 'worker.py'
    worker.write_text(NCCL_WORKER)
    port = _free_port()
    procs = []
    for r in range(2):
        env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
                   + os.environ.get('PYTHONPATH', ''),
                   CUDA_VISIBLE_DEVICES=str(r),
                   ENSPARA_TPU_COORDINATOR='localhost:' + port,
                   ENSPARA_TPU_NUM_PROCESSES='2',
                   ENSPARA_TPU_PROCESS_ID=str(r))
        env.pop('ENSPARA_TPU_PLATFORM', None)
        env.pop('ENSPARA_TPU_LOCAL_SHARDS', None)
        procs.append(subprocess.Popen(
            [sys.executable, str(worker), str(tmp_path / 'X.npy'), '150',
             str(tmp_path / ('r%d.npz' % r))], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, env=env, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    ref = _seeded(X, 150, mesh=FrameMesh([cuda, _card(1)]))
    assert engine.kcenters_device_fused.n_replays == 0
    steps = 64 * 3
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, out
        got = json.loads(next(line[len('RESULT '):] for line in
                              out.splitlines()
                              if line.startswith('RESULT ')))
        assert got['backend'] == 'nccl' and got['replays'] == 2
        assert got['counted'] == got['fit_collectives'] \
            == 2 * steps + 1 + 1 + 2
        spans = got['spans']
        assert spans['enspara/kcenters.capture'] == 1
        assert spans['enspara/kcenters.replay'] == 2
        assert spans['enspara/mesh.all_reduce'] + spans[
            'enspara/mesh.all_gather'] == 2 * 128 + 1 + 1 + 2
        res = np.load(str(tmp_path / ('r%d.npz' % r)))
        np.testing.assert_array_equal(res['ctr'], ref.center_indices)
        np.testing.assert_array_equal(res['assig'], ref.assignments)
        np.testing.assert_array_equal(res['dist'], ref.distances)
