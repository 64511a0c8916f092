"""enspara_tpu_torch.parallel held against the JAX package: the frame
mesh's layout, its device-level collectives (on 8 CPU shards against
``shard_map`` over the suite's 8 virtual devices), the single-process
host vocabulary and striped loaders, and a two-process ``gloo`` job
(modelled on tests/test_multiprocess.py) whose sharded k-centers equals
a single-process run.
"""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enspara_tpu import ra as jra
from enspara_tpu.parallel import io as jio
from enspara_tpu.parallel import mesh as jmesh
from enspara_tpu.parallel import ops as jops

from enspara_tpu_torch import ra
from enspara_tpu_torch.parallel import FrameMesh, frame_mesh, io, mesh, ops

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


def _cpu_mesh(n=8):
    return FrameMesh(['cpu'] * n)


def _jax_shards(arr):
    return [np.asarray(s.data) for s in
            sorted(arr.addressable_shards, key=lambda s: s.index[0].start)]


def _in_shard_map(fn, *arrays):
    """``fn`` over the frame-sharded ``arrays`` under the JAX package's
    8-device mesh, with replicated outputs."""
    jm = jmesh.frame_mesh()
    sharded = [jmesh.shard_frames(a, jm)[0] for a in arrays]
    return jax.jit(jax.shard_map(
        fn, mesh=jm, in_specs=tuple(jmesh.P(jmesh.FRAME_AXIS)
                                    for _ in arrays),
        out_specs=jmesh.P(), check_vma=False))(*sharded)


def test_shard_frames_matches_jax():
    """Padding and the contiguous blocks: 13 rows on 8 shards pad to 16,
    3 rows to 8 (one per shard), exactly as the JAX package cuts them."""
    for n in (13, 3):
        arr = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
        shards, n_valid = mesh.shard_frames(arr, _cpu_mesh(), pad_value=-1)
        ref, n_ref = jmesh.shard_frames(arr, jmesh.frame_mesh(),
                                        pad_value=-1)
        assert n_valid == n_ref == n
        assert len(shards) == 8
        for got, want in zip(shards, _jax_shards(ref)):
            np.testing.assert_array_equal(got.numpy(), want)
    t = torch.arange(10.0)
    shards, _ = mesh.shard_frames(t, _cpu_mesh(4))
    assert [len(s) for s in shards] == [3, 3, 3, 3]
    np.testing.assert_array_equal(mesh.host_fetch(shards)[:10], t.numpy())
    copies = mesh.replicated(np.arange(4), _cpu_mesh(3))
    assert len(copies) == 3 and all(c.tolist() == [0, 1, 2, 3]
                                    for c in copies)


@pytest.mark.parametrize('case', ['cross_shard_tie', 'all_equal',
                                  'uint32_priorities', 'indices_past_2_31'])
def test_global_argmax_ties(case):
    """Ties across shards go to the smallest global index: the serial
    ``np.argmax`` and, for float32 values, the JAX package's
    ``global_argmax``; PAM's int64 priorities (uint32 values) and global
    indices past 2**31 come back exactly."""
    x = np.random.default_rng(1).random(64).astype(np.float32)
    if case == 'uint32_priorities':
        x = np.random.default_rng(1).integers(0, 2 ** 32 - 2, 64)
        x[[41, 9, 60]] = 2 ** 32 - 1       # shards 5, 1 and 7 of 8
    elif case == 'cross_shard_tie':
        x[[41, 9, 60]] = 2.0               # shards 5, 1 and 7 of 8
    elif case == 'all_equal':
        x[:] = 0.5
    shards, _ = mesh.shard_frames(x, _cpu_mesh())
    if case == 'indices_past_2_31':
        # the shards of a vector whose first frame is 2**33 + 5
        base = 2 ** 33 + 5
        x[[17, 50]] = 3.0
        la = [torch.argmax(s) for s in shards]
        val, idx = ops.argmax_over_shards(
            [s[a] for s, a in zip(shards, la)],
            [a + base + 8 * i for i, a in enumerate(la)], _cpu_mesh())
        assert idx.dtype == torch.int64
        assert int(idx) == base + int(np.argmax(x)) == base + 17
        assert float(val) == 3.0
        return
    val, idx = ops.global_argmax(shards, _cpu_mesh())
    assert val.dtype == shards[0].dtype
    assert int(idx) == int(np.argmax(x))
    assert val.item() == x.max()
    if case != 'uint32_priorities':
        j_val, j_idx = _in_shard_map(lambda v: jops.global_argmax(v), x)
        assert int(idx) == int(j_idx) and float(val) == float(j_val)


@pytest.mark.parametrize('shape', [(40,), (40, 6)])
def test_mesh_of_one_shard(shape):
    """On a mesh of one shard, where nothing is masked or summed, the
    first argmax and the picked frames equal ``np.argmax`` and plain
    indexing, ties to the first frame, the dtype kept."""
    x = np.random.default_rng(5).integers(0, 4, shape).astype(np.int64)
    x[[31, 6]] = 9                         # a tie in every column
    one = _cpu_mesh(1)
    val, idx = ops.global_argmax([torch.from_numpy(x)], one)
    assert val.dtype == idx.dtype == torch.int64
    np.testing.assert_array_equal(idx.numpy(), np.argmax(x, axis=0))
    np.testing.assert_array_equal(val.numpy(), x.max(axis=0))
    gi = torch.tensor([39, 0, 6, 6])
    (got,) = ops.distribute_frames([torch.from_numpy(x)], gi, one)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), x[gi.numpy()])
    if x.ndim == 2:
        (got,) = ops.distribute_frames([torch.from_numpy(x.T.copy())], gi,
                                       one, dim=1)
        np.testing.assert_array_equal(got.numpy(), x.T[:, gi.numpy()])


class _ThreadMesh:
    """Process ``rank`` of ``len(slots)`` for the mesh vocabulary, the
    processes being threads: ``all_gather`` joins every process's
    tensor in rank order and counts its calls."""
    spans_processes = True
    lead = torch.device('cpu')

    def __init__(self, rank, n_local, slots, barrier):
        self.rank, self.slots, self.barrier = rank, slots, barrier
        self.first_shard = rank * n_local
        self.n_gathers = 0

    def all_gather(self, t, dim=0):
        self.n_gathers += 1
        self.slots[self.rank] = t
        self.barrier.wait()
        out = torch.cat(self.slots, dim=dim)
        self.barrier.wait()
        return out


@pytest.mark.parametrize('case', ['float32 vector', 'int64 batch'])
def test_argmax_over_processes_is_one_collective(case):
    """Over two processes (threads here) of two shards each, one
    ``global_argmax`` issues one collective and equals ``np.argmax``,
    ties across the processes going to the smallest global index: for a
    float32 vector, and column by column for PAM's (n, B) block of
    uint32 priorities in int64."""
    import threading

    rng = np.random.default_rng(4)
    if case == 'float32 vector':
        x = rng.random(40).astype(np.float32)
        x[[33, 12, 25]] = 2.0              # processes 1, 0 and 1
    else:
        x = rng.integers(0, 2 ** 32 - 1, (40, 6))
        x[[33, 12], 2] = x[30, 4] = x[7, 4] = 2 ** 32 - 1
    blocks = torch.from_numpy(x).chunk(4)
    slots, barrier = [None, None], threading.Barrier(2)
    meshes = [_ThreadMesh(r, 2, slots, barrier) for r in range(2)]
    out = [None, None]

    def run(r):
        out[r] = ops.global_argmax(blocks[2 * r:2 * r + 2], meshes[r])
    threads = [threading.Thread(target=run, args=(r,)) for r in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for (val, idx), m in zip(out, meshes):
        assert m.n_gathers == 1
        assert val.dtype == blocks[0].dtype and idx.dtype == torch.int64
        np.testing.assert_array_equal(idx.numpy(), np.argmax(x, axis=0))
        np.testing.assert_array_equal(val.numpy(), x.max(axis=0))


@pytest.mark.parametrize('dtype', [np.int32, np.float64])
def test_distribute_frame_keeps_dtype(dtype):
    """The owner-masked sum fetches row ``i`` onto every shard in the
    input's dtype: int rows stay exact, fp64 rows keep all their bits."""
    rng = np.random.default_rng(2)
    data = (rng.integers(-2 ** 30, 2 ** 30, (24, 5)) if dtype == np.int32
            else rng.normal(size=(24, 5)) * 1e8 + 1e-9).astype(dtype)
    shards, _ = mesh.shard_frames(data, _cpu_mesh(4))
    for i in (0, 7, 23):
        rows = ops.distribute_frame(shards, torch.tensor(i), _cpu_mesh(4))
        assert len(rows) == 4
        for r in rows:
            assert r.dtype == torch.from_numpy(data).dtype
            np.testing.assert_array_equal(r.numpy(), data[i])


def test_striped_max_and_mean_match_jax():
    x = np.random.default_rng(3).normal(size=40).astype(np.float32)
    w = (np.arange(40) % 3 == 0).astype(np.float32)
    xs, _ = mesh.shard_frames(x, _cpu_mesh())
    ws, _ = mesh.shard_frames(w, _cpu_mesh())
    j_max = _in_shard_map(lambda v: jops.striped_max(v), x)
    j_mean = _in_shard_map(lambda v, u: jops.striped_mean(v, u), x, w)
    assert float(ops.striped_max(xs, _cpu_mesh())) == float(j_max)
    np.testing.assert_allclose(
        float(ops.striped_mean(xs, _cpu_mesh(), weights=ws)),
        float(j_mean), rtol=1e-6)
    np.testing.assert_allclose(float(ops.striped_mean(xs, _cpu_mesh())),
                               x.mean(), rtol=1e-6)


def test_host_vocabulary_single_process():
    """One process: the identity semantics of the JAX package's
    host-level striped functions, value for value."""
    arr = np.random.default_rng(4).normal(size=(7, 2)).astype(np.float32)
    assert ops.striped_array_max(arr) == jops.striped_array_max(arr)
    assert ops.striped_array_mean(arr) == jops.striped_array_mean(arr)
    assert ops.assemble_striped_array(arr) is arr
    lengths = [3, 5, 2]
    flat = np.arange(10.0)
    np.testing.assert_array_equal(
        ops.assemble_striped_ragged_array(flat, lengths),
        jops.assemble_striped_ragged_array(flat, lengths))
    pairs = [(0, 0), (0, 4), (0, 9)]
    assert ops.convert_local_indices(pairs, lengths) == \
        jops.convert_local_indices(pairs, lengths)
    assert ops.randind(arr, random_state=5) == \
        jops.randind(arr, random_state=5)
    assert io.striped_range(5) == jio.striped_range(5) == [0, 1, 2, 3, 4]


def test_striped_loaders_single_process(tmp_path):
    rows = [np.arange(n, dtype=np.float32) + 10 * i
            for i, n in enumerate([3, 5, 2, 4])]
    h5 = str(tmp_path / 'ra.h5')
    jra.save(h5, jra.RaggedArray(rows))
    npys = []
    for i in range(3):
        npys.append(str(tmp_path / ('arr%d.npy' % i)))
        np.save(npys[-1], np.arange(6, dtype=np.float32).reshape(3, 2) + i)
    for stride in (1, 2):
        got, ref = (io.load_h5_as_striped(h5, stride=stride),
                    jio.load_h5_as_striped(h5, stride=stride))
        assert list(got[0]) == list(ref[0])
        np.testing.assert_array_equal(got[1], ref[1])
        got, ref = (io.load_npy_as_striped(npys, stride=stride),
                    jio.load_npy_as_striped(npys, stride=stride))
        assert list(got[0]) == list(ref[0])
        np.testing.assert_array_equal(got[1], ref[1])


def test_frame_mesh_devices():
    """Under ``$ENSPARA_TPU_PLATFORM=cpu`` the default mesh holds CPU
    shards; a mesh never mixes device types; one process spans none."""
    m = frame_mesh(3)
    assert m.devices == (torch.device('cpu'),) * 3
    assert (m.size, m.first_shard, m.process_count) == (3, 0, 1)
    assert not m.spans_processes and m.shape == {'frames': 3}
    with pytest.raises(ValueError, match='one type'):
        FrameMesh(['cpu', 'meta'])
    with pytest.raises(ValueError, match='at least one'):
        FrameMesh([])
    t = torch.arange(6)
    assert m.all_reduce(t) is t and m.all_gather(t) is t
    assert ra.RaggedArray([[1, 2], [3]]).lengths.tolist() == [2, 1]


WORKER = r'''
import os, sys
rank, port, datadir = int(sys.argv[1]), sys.argv[2], sys.argv[3]
os.environ['ENSPARA_TPU_PLATFORM'] = 'cpu'

import numpy as np
import torch
import torch.distributed as dist

from enspara_tpu_torch.parallel import frame_mesh, initialize_distributed
from enspara_tpu_torch.parallel import io as pio
from enspara_tpu_torch.parallel import ops as pops

initialize_distributed(backend='gloo', init_method='tcp://localhost:' + port,
                       world_size=2, rank=rank)
initialize_distributed(backend='gloo')          # a second call is a no-op
assert dist.get_world_size() == 2 and dist.get_rank() == rank

# striped loaders: process r owns items r, r + 2, ..
assert pio.striped_range(5) == list(range(rank, 5, 2))
lengths, local = pio.load_h5_as_striped(os.path.join(datadir, 'ra.h5'))
rows = [np.arange(n, dtype=np.float32) + 10 * i
        for i, n in enumerate([3, 5, 2, 4])]
assert list(lengths) == [3, 5, 2, 4]
np.testing.assert_array_equal(
    np.asarray(local, np.float32),
    np.concatenate([rows[i] for i in range(rank, 4, 2)]))
npys = [os.path.join(datadir, 'arr%d.npy' % i) for i in range(3)]
gl, nl = pio.load_npy_as_striped(npys)
np.testing.assert_array_equal(
    nl, np.concatenate([np.load(npys[i]) for i in range(rank, 3, 2)]))

# assemble_striped_array: element i from process i % 2
full = np.arange(7, dtype=np.int64) * 3
np.testing.assert_array_equal(pops.assemble_striped_array(full[rank::2]),
                              full)
assert pops.striped_array_max(full[rank::2]) == 18
assert pops.randind(full[rank::2], random_state=1) == \
    pops.randind(full[rank::2], random_state=1)

# sharded k-centers: 2 processes x 2 CPU shards, a 4-shard mesh
mesh = frame_mesh(2)
assert (mesh.size, mesh.first_shard) == (4, 2 * rank), mesh
X = np.load(os.path.join(datadir, 'X.npy'))
from enspara_tpu_torch.cluster import kcenters
from enspara_tpu_torch.msm import assigns_to_counts_sharded
res = kcenters(X, 'rmsd', n_clusters=24, mesh=mesh)
np.savez(os.path.join(datadir, 'res%d.npz' % rank),
         ctr=np.asarray(res.center_indices), assig=res.assignments,
         dist=res.distances)
counts = assigns_to_counts_sharded(res.assignments.reshape(5, -1),
                                   np.ones((5, 200), bool), 2, 24, mesh=mesh)
np.save(os.path.join(datadir, 'counts%d.npy' % rank), counts.numpy())
dist.barrier()
print('WORKER %d ALL_OK' % rank, flush=True)
# a group left alive at exit can abort the process as gloo's threads die
dist.destroy_process_group()
'''


def _free_port():
    s = socket.socket()
    s.bind(('localhost', 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_gloo(tmp_path):
    """Two processes joined by ``initialize_distributed`` over gloo: the
    striped loaders hand each its stripe, ``assemble_striped_array``
    puts them back, and k-centers over 2 processes x 2 shards, with its
    sharded counts, equals the single-process run on both processes."""
    from enspara_tpu_torch.cluster import kcenters
    from enspara_tpu_torch.msm import assigns_to_counts
    from test_torch_port import basin_data

    rows = [np.arange(n, dtype=np.float32) + 10 * i
            for i, n in enumerate([3, 5, 2, 4])]
    jra.save(str(tmp_path / 'ra.h5'), jra.RaggedArray(rows))
    for i in range(3):
        np.save(str(tmp_path / ('arr%d.npy' % i)),
                np.arange(2, dtype=np.float32) + 100 * i)
    X = basin_data(np.random.default_rng(8), 1000, 8, n_basins=30)
    np.save(str(tmp_path / 'X.npy'), X)
    worker = tmp_path / 'worker.py'
    worker.write_text(WORKER)
    port = str(_free_port())
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get('PYTHONPATH', ''), OMP_NUM_THREADS='1')
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(r), port, str(tmp_path)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
        text=True) for r in range(2)]
    outs = []
    for r, p in enumerate(procs):
        try:
            outs.append(p.communicate(timeout=180)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail('worker %d timed out' % r)
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, 'worker %d failed:\n%s' % (r, out)
        assert ('WORKER %d ALL_OK' % r) in out, out

    one = kcenters(X, 'rmsd', n_clusters=24, device='cpu')
    counts = assigns_to_counts(one.assignments.reshape(5, -1), lag_time=2,
                               max_n_states=24).toarray()
    for r in range(2):
        got = np.load(str(tmp_path / ('res%d.npz' % r)))
        np.testing.assert_array_equal(got['ctr'], one.center_indices)
        np.testing.assert_array_equal(got['assig'], one.assignments)
        np.testing.assert_array_equal(
            np.load(str(tmp_path / ('counts%d.npy' % r))), counts)
        assert got['dist'].shape == one.distances.shape
