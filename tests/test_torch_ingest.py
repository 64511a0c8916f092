"""enspara_tpu_torch's ingest held against the JAX package: the locality
sort (``prepare_rmsd_frames(sort='locality')``, ``_locality_sort``, the
results mapped back to the caller's order), the streamed host ingest
against the monolithic one, and the loose names of the ported modules
(``util.log.trace_region`` and ``device_memory_stats``,
``util.backend.select_platform``, ``parallel.mesh.mesh_platform``,
``ops.qcp.kabsch_rmsd_np``); and the center's G, which every loop takes
as the prepared G.

Bars: permutations, layouts and G exactly equal where both packages
compute the same numbers (grid coordinates, keys separated by more than
1e-4); center indices and assignments exactly equal (tie-free data);
distances on the msd bar of ``test_torch_port.assert_rmsd_close``.
"""

import os

import jax
import numpy as np
import pytest
import torch

from enspara_tpu.cluster import engine as jengine
from enspara_tpu.cluster.kcenters import kcenters as jax_kcenters
from enspara_tpu.ops.qcp import kabsch_rmsd_np as jax_kabsch
from enspara_tpu.parallel.mesh import frame_mesh as jax_frame_mesh
from enspara_tpu.parallel.mesh import mesh_platform as jax_mesh_platform

from enspara_tpu_torch.cluster import engine, kcenters
from enspara_tpu_torch.ops.kcenters_step import center_g
from enspara_tpu_torch.ops.qcp import kabsch_rmsd_np, rmsd
from enspara_tpu_torch.parallel import FrameMesh
from enspara_tpu_torch.parallel.mesh import mesh_platform
from enspara_tpu_torch.util import backend, log

from test_torch_bf16 import grid_data
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


def scaled_frames(rng, n, a):
    """Frame k is a scaled copy of one structure, 1 + 0.01 * rank(k)
    with frame 0 the smallest, plus grid noise: the QCP RMSD to frame 0
    grows with the scale, so the sort keys lie about 0.01 apart."""
    base = rng.normal(size=(a, 3))
    scale = np.concatenate(([1.0],
                            1.0 + 0.01 * (1 + rng.permutation(n - 1))))
    X = scale[:, None, None] * base + 1e-3 * rng.normal(size=(n, a, 3))
    X = np.round(X * 1024) / 1024
    X[:, -1] = -X[:, :-1].sum(axis=1)
    return X.astype(np.float32)


def _gsum_x(X):
    return 2 * float((X.astype(np.float64) ** 2).sum((1, 2)).max()) * 1.01


@pytest.mark.parametrize('precision', ['fp32', 'bf16'])
def test_locality_sort_layout_matches_jax(precision):
    """The permutation (a stable sort of keys more than 1e-4 apart) and
    the sorted layout equal the JAX package's, bit for bit."""
    n, a = 300, 10
    X = scaled_frames(np.random.default_rng(1), n, a)
    _, jperm = jengine._locality_sort(X)
    data = X - X.mean(1, keepdims=True)
    keys = np.array([kabsch_rmsd_np(x, data[0]) for x in data])
    assert np.diff(keys[jperm]).min() > 1e-4
    jprep = jengine.prepare_rmsd_frames(X, tile=128, sort='locality',
                                        precision=precision)
    prep = engine.prepare_rmsd_frames(X, tile=128, sort='locality',
                                      precision=precision)
    np.testing.assert_array_equal(prep.perm, jperm)
    np.testing.assert_array_equal(prep.perm, np.asarray(jprep.perm))
    assert prep.perm.dtype == np.int64 and prep.precision == precision
    word = torch.int16 if precision == 'bf16' else torch.int32
    mine = prep.frames_r.view(word).numpy().reshape(3, -1, prep.n_pad)
    ref = np.asarray(jprep.frames_r).view(mine.dtype)
    ref = ref.reshape(3, -1, ref.shape[1])
    np.testing.assert_array_equal(mine[:, :a, :n], ref[:, :a, :n])
    g, jg = prep.g.numpy()[0, :n], np.asarray(jprep.g)[0, :n]
    assert (np.abs(g - jg) <= np.spacing(jg)).all()


def _shuffled_blobs(seed, n, a, k):
    """The data of the JAX package's locality-sort test: k blobs, frames
    drawn from them in random order."""
    rng = np.random.default_rng(seed)
    templates = rng.normal(size=(k, a, 3)).astype(np.float32) * 5.0
    blob = rng.integers(0, k, size=n)
    return (templates[blob]
            + 0.01 * rng.normal(size=(n, a, 3)).astype(np.float32))


def test_locality_sort_roundtrip_matches_jax():
    """sort='locality' clusters the sorted layout and returns results in
    the caller's order, equal to the JAX package's: centers are members
    of their own clusters at ~0, a warm start given in the caller's
    order continues as JAX's does, and sort on unsorted frames raises."""
    rng = np.random.default_rng(13)
    X = basin_data(rng, 1024, 8, n_basins=16)[rng.permutation(1024)]
    k = 24
    ref = jengine.kcenters_device_fused(X, n_clusters=k, tile=128,
                                        interpret=True, sort='locality')
    res = engine.kcenters_device_fused(X, n_clusters=k, tile=128,
                                       sort='locality')
    gsum = _gsum_x(X)
    np.testing.assert_array_equal(res.center_indices, ref.center_indices)
    np.testing.assert_array_equal(res.assignments, ref.assignments)
    assert_rmsd_close(res.distances, ref.distances, gsum, 8)
    for j, ci in enumerate(res.center_indices):
        assert res.assignments[ci] == j and res.distances[ci] < 1e-2

    kw = dict(n_clusters=k + 12, init_distances=res.distances,
              init_assignments=res.assignments, n_init_centers=k,
              init_center_indices=res.center_indices)
    jprep = jengine.prepare_rmsd_frames(X, tile=128, sort='locality')
    prep = engine.prepare_rmsd_frames(X, tile=128, sort='locality')
    warm_ref = jengine.kcenters_device_fused(jprep, interpret=True, **kw)
    warm = engine.kcenters_device_fused(prep, **kw)
    assert warm.n_found == k + 12
    np.testing.assert_array_equal(warm.center_indices,
                                  warm_ref.center_indices)
    np.testing.assert_array_equal(warm.assignments, warm_ref.assignments)
    assert_rmsd_close(warm.distances, warm_ref.distances, gsum, 8)

    with pytest.raises(ValueError, match='unsorted'):
        engine.kcenters_device_fused(engine.prepare_rmsd_frames(X, tile=128),
                                     n_clusters=k, sort='locality')
    with pytest.raises(ValueError, match='float32 frames'):
        engine.assign_device(prep, X[:2], 'rmsd')


def test_locality_sort_on_a_mesh_and_in_bf16():
    """A sorted layout over a CPU mesh of 4 shards keeps its permutation
    and clusters as the one-device sorted layout does, in both
    precisions."""
    X = grid_data(np.random.default_rng(3), 2000, 10, n_basins=20)
    X = X[np.random.default_rng(4).permutation(len(X))]
    mesh = FrameMesh(['cpu'] * 4)
    for precision in ('fp32', 'bf16'):
        one = engine.kcenters_device_fused(X, n_clusters=40, tile=128,
                                           sort='locality',
                                           precision=precision)
        prep = engine.prepare_rmsd_frames(X, tile=128, mesh=mesh,
                                          sort='locality',
                                          precision=precision)
        assert prep.perm is not None and prep.precision == precision
        res = engine.kcenters_device_fused(prep, n_clusters=40, mesh=mesh)
        np.testing.assert_array_equal(res.center_indices, one.center_indices)
        np.testing.assert_array_equal(res.assignments, one.assignments)
        assert_rmsd_close(res.distances, one.distances, _gsum_x(X), 10)
        # the caller's order: each center is its own nearest center
        assert (res.assignments[res.center_indices]
                == np.arange(40)).all()


def _streamed(monkeypatch, frames_per_chunk, a):
    """Shrink the stream chunk and count the chunks laid out."""
    monkeypatch.setattr(engine, '_STREAM_CHUNK_BYTES',
                        frames_per_chunk * a * 3 * 4)
    calls = []
    ingest = engine._ingest

    def counted(X, *args, **kw):
        calls.append(int(X.shape[0]))
        return ingest(X, *args, **kw)
    monkeypatch.setattr(engine, '_ingest', counted)
    return calls


@pytest.mark.parametrize('precision,chunk', [
    ('fp32', 256), ('bf16', 256), ('fp32', 300)],
    ids=['fp32', 'bf16', 'unaligned'])
def test_streamed_ingest_equals_monolithic(precision, chunk, monkeypatch):
    """The streamed ingest of a host array, its chunks ragged against
    the frame count (and, at 300 frames, against the tile), lays out the
    monolithic layout bit for bit, padding included; both cluster alike,
    and the layout is the JAX package's streamed one within its own
    streamed-vs-monolithic bar."""
    n, a = 700, 10
    rng = np.random.default_rng(77)
    templates = rng.normal(size=(5, a, 3)).astype(np.float32) * 5.0
    X = (templates[np.arange(n) % 5]
         + 0.01 * rng.normal(size=(n, a, 3)).astype(np.float32))
    calls = _streamed(monkeypatch, chunk, a)
    mono = engine.prepare_rmsd_frames(X, tile=128, precision=precision,
                                      stream=False)
    assert calls == [n]
    strm = engine.prepare_rmsd_frames(X, tile=128, precision=precision)
    assert calls[1:] == [chunk] * (n // chunk) + [n % chunk]
    assert strm.frames_r.dtype == mono.frames_r.dtype
    assert torch.equal(strm.frames_r, mono.frames_r)
    assert torch.equal(strm.g, mono.g)
    assert (strm.g[0, n:] == 1.0).all()
    assert (strm.frames_r[:, n:].float() == 0).all()

    monkeypatch.setattr(jengine, '_STREAM_CHUNK_BYTES', chunk * a * 3 * 4)
    jstrm = jengine.prepare_rmsd_frames(X, tile=128, precision=precision)
    fj = np.asarray(jstrm.frames_r, np.float32).reshape(3, -1, 768)
    fp = strm.frames_r.float().numpy().reshape(3, -1, 768)
    np.testing.assert_allclose(fp[:, :a], fj[:, :a], rtol=2e-4, atol=2e-6)
    np.testing.assert_allclose(strm.g.numpy(), np.asarray(jstrm.g),
                               rtol=2e-5, atol=0)
    a1 = engine.kcenters_device_fused(strm, n_clusters=5)
    a2 = engine.kcenters_device_fused(mono, n_clusters=5)
    assert all(np.array_equal(x, y) for x, y in zip(a1, a2))


def test_stream_takes_host_arrays_on_one_device(monkeypatch, tmp_path):
    """The stream takes a host array that spans more than one chunk, on
    one device, a memory-mapped file too (read a chunk at a time);
    tensors, ``stream=False``, one chunk's worth, sorted frames and a
    mesh of several shards take the one copy."""
    n, a = 700, 10
    X = basin_data(np.random.default_rng(2), n, a, n_basins=6)
    path = str(tmp_path / 'frames.npy')
    np.save(path, X)
    calls = _streamed(monkeypatch, 256, a)
    ref = engine.prepare_rmsd_frames(X, tile=128, stream=False)
    mm = np.load(path, mmap_mode='r')
    for src in (mm, X.astype(np.float64)):
        del calls[:]
        prep = engine.prepare_rmsd_frames(src, tile=128, stream=True)
        assert len(calls) == 3
        assert torch.equal(prep.frames_r, ref.frames_r)
        assert torch.equal(prep.g, ref.g)
    for kw in (dict(stream=False), dict(sort='locality'),
               dict(mesh=FrameMesh(['cpu'] * 2))):
        del calls[:]
        engine.prepare_rmsd_frames(X, tile=128, **kw)
        assert len(calls) == (2 if 'mesh' in kw else 1)
    del calls[:]
    engine.prepare_rmsd_frames(torch.from_numpy(X), tile=128)
    engine.prepare_rmsd_frames(X[:256], tile=128)
    assert calls == [n, 256]


def test_kcenters_sort_matches_jax():
    """kcenters(..., sort='locality') and kcenters_device(..., 'rmsd',
    sort='locality') against the JAX package's kcenters, which runs the
    sorted layout through its fused path on the CPU."""
    X = _shuffled_blobs(seed=21, n=900, a=10, k=12)
    ref = jax_kcenters(X, 'rmsd', n_clusters=12, sort='locality')
    port = kcenters(X, 'rmsd', n_clusters=12, sort='locality')
    np.testing.assert_array_equal(port.center_indices, ref.center_indices)
    np.testing.assert_array_equal(port.assignments, ref.assignments)
    assert_rmsd_close(port.distances, ref.distances, _gsum_x(X), 10)
    for c, i in zip(port.centers, port.center_indices):
        np.testing.assert_array_equal(c, X[i])
    dev = engine.kcenters_device(X, 'rmsd', n_clusters=12, sort='locality')
    np.testing.assert_array_equal(dev.center_indices, port.center_indices)


def test_trace_region_and_device_memory_stats(monkeypatch):
    """trace_region names a region of a torch.profiler trace;
    device_memory_stats is {} without a card, as the JAX package's is
    without device statistics."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with log.trace_region('enspara_region'):
            torch.ones(8).sum()
    assert 'enspara_region' in {e.key for e in prof.key_averages()}
    with log.trace_region('outside a profiler'):
        pass
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    assert log.device_memory_stats() == {}


def test_select_platform_pins_the_process(monkeypatch):
    """select_platform pins $ENSPARA_TPU_PLATFORM, which select_device and
    host input then follow; it refuses what select_device refuses."""
    monkeypatch.delenv('ENSPARA_TPU_PLATFORM')
    assert backend.select_platform() == ''
    assert backend.select_platform('CPU') == 'cpu'
    assert os.environ['ENSPARA_TPU_PLATFORM'] == 'cpu'
    assert backend.select_device() == torch.device('cpu')
    assert backend.select_platform() == 'cpu'
    with pytest.raises(ValueError, match='ENSPARA_TPU_PLATFORM'):
        backend.select_platform('tpu')
    assert os.environ['ENSPARA_TPU_PLATFORM'] == 'cpu'
    monkeypatch.setenv('ENSPARA_TPU_PLATFORM', 'quantum')
    with pytest.raises(ValueError, match='ENSPARA_TPU_PLATFORM'):
        backend.select_platform()


def test_mesh_platform_and_kabsch_oracle():
    """mesh_platform names a CPU mesh 'cpu', as the JAX package does;
    kabsch_rmsd_np is the JAX package's float64 oracle, and the QCP
    RMSD agrees with it."""
    assert mesh_platform(FrameMesh(['cpu'] * 2)) == 'cpu'
    assert jax_mesh_platform(jax_frame_mesh(n=1)) == 'cpu'
    rng = np.random.default_rng(8)
    A = rng.normal(size=(6, 12, 3))
    B = A[::-1] @ np.linalg.qr(rng.normal(size=(3, 3)))[0] + 0.3
    for x, y in zip(A, B):
        assert kabsch_rmsd_np(x, y) == pytest.approx(jax_kabsch(x, y),
                                                     rel=1e-12, abs=1e-12)
    ours = np.array([kabsch_rmsd_np(x, y) for x, y in zip(A, B)])
    qcp = rmsd(torch.from_numpy(A.astype(np.float32)),
               torch.from_numpy(B.astype(np.float32)))
    np.testing.assert_allclose(np.diag(qcp.numpy()), ours, atol=1e-4)
    assert kabsch_rmsd_np(A[0], A[0]) == pytest.approx(0.0, abs=1e-7)
    assert jax.default_backend() == 'cpu'


@pytest.mark.parametrize('precision', ['fp32', 'bf16'])
def test_center_g_is_the_prepared_g(precision):
    """The chunk's center G (kernel and plain version) adds the squares in
    the ingest's order, so it is every frame's prepared G bit for bit,
    the number the sharded loop reads: the one-device and sharded loops
    then measure alike, bit for bit."""
    X = basin_data(np.random.default_rng(31), 3000, 13, n_basins=30)
    prep = engine.prepare_rmsd_frames(X, tile=128, precision=precision)
    g = prep.g.numpy()[0]
    assert all(center_g(prep.frames_r[:, i].float()) == g[i]
               for i in range(0, prep.n, 7))
    one = engine.kcenters_device_fused(prep, n_clusters=48)
    mesh = FrameMesh(['cpu'] * 4)
    sh = engine.kcenters_device_fused(X, n_clusters=48, tile=128, mesh=mesh,
                                      precision=precision)
    for x, y in zip(one, sh):
        np.testing.assert_array_equal(x, y)
