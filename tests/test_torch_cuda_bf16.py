"""The bf16 frame stream of enspara_tpu_torch's k-centers kernels on the
card. Imports no jax: on the card machine, run with
``python -m pytest --noconftest -m cuda tests/test_torch_cuda_bf16.py``.

The ``cuda`` tests skip without a card. They hold the bf16 entry points
of kernels 1-4 (``kc_chunk_bf16`` with and without skipping,
``kc_iter_skip_bf16`` of ``csrc/kcenters_step.cu``, ``qu_iteration_bf16``
of ``csrc/qcp_update.cu``) against their plain versions on the same bf16
frames, show that a bf16 kernel that fails to load raises rather than
running the fp32 one, and hold the bf16, locality-sorted and streamed
paths on the card against the same on the CPU.
"""

import numpy as np
import pytest
import torch

from enspara_tpu_torch.cluster import engine
from enspara_tpu_torch.convert import result_to_numpy
from enspara_tpu_torch.ops import kcenters_step, qcp_update
from enspara_tpu_torch.parallel import FrameMesh

from test_torch_port import assert_rmsd_close, basin_data, fresh_arrays


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


def _bf16_prep(cuda, n=16_384, a=16, seed=3):
    X = basin_data(np.random.default_rng(seed), n, a, n_basins=40,
                   dwell=512)
    prep = engine.prepare_rmsd_frames(X, device=cuda, precision='bf16')
    assert prep.frames_r.dtype == torch.bfloat16
    return prep


def _state(prep, n_total=1 << 30):
    dist, assig = fresh_arrays(prep.n, prep.frames_r.shape[1])
    dev = prep.frames_r.device
    return kcenters_step.start_state(
        torch.from_numpy(dist).to(dev), torch.from_numpy(assig).to(dev),
        prep.frames_r.shape[0], prep.tile, 0, n_total, 0.0)


@pytest.mark.cuda
def test_cuda_bf16_chunk_matches_plain(cuda):
    """Kernels 1 and 2 in bf16 against the plain chunk on the same bf16
    frames; skip on and off bit for bit, tiles skipped."""
    prep = _bf16_prep(cuda)

    def run(fn, **kw):
        state = _state(prep)
        ctr, skc = fn(prep, state, 96, **kw)
        return result_to_numpy(state, ctr, skc)
    before = kcenters_step.kcenters_chunk.n_launches
    on = run(kcenters_step.kcenters_chunk)
    off = run(kcenters_step.kcenters_chunk, skip=False)
    torch.cuda.synchronize()
    assert kcenters_step.kcenters_chunk.n_launches == before + 2 * 97
    plain = run(kcenters_step.kcenters_chunk_plain)
    for x, y in zip(on, off):
        np.testing.assert_array_equal(x, y)
    assert on[6][on[6] > 0].sum() > 0, 'basin data must skip tiles'
    for k in (1, 2, 3, 6):
        np.testing.assert_array_equal(on[k], plain[k])
    g = 2 * float(prep.g.max())
    for k in (0, 4, 5):
        assert_rmsd_close(on[k], plain[k], g, 16)


@pytest.mark.cuda
@pytest.mark.parametrize('md_kind', ['finite', 'inf'])
def test_cuda_bf16_iteration_kernels_match_plain(cuda, md_kind):
    """Kernels 3 and 4 in bf16 on one shard against their plain
    versions; with md = inf, against each other bit for bit."""
    prep = _bf16_prep(cuda)
    st = _state(prep)
    kcenters_step.kcenters_chunk(prep, st, 16)
    gidx, md, i = st.scalars()
    lo, hi = 4096, 8192
    sh = engine.PreparedRMSDFrames(prep.frames_r[:, lo:hi].contiguous(),
                                   prep.g[:, lo:hi].contiguous(), hi - lo,
                                   16, prep.tile, 'bf16')
    d = st.dist[:, lo:hi].contiguous()
    a = st.assig[:, lo:hi].contiguous()
    tmax = kcenters_step.tile_summaries(d, prep.tile,
                                        kcenters_step.skip_t_pad(16))
    col = prep.frames_r[:, gidx:gidx + 1].float().contiguous()
    gc = prep.g[:, gidx:gidx + 1].contiguous()

    def one(v, dt):
        return torch.full((1, 1), v, dtype=dt, device=cuda)
    cid = one(i, torch.int32)
    mdt = one(md if md_kind == 'finite' else float('inf'), torch.float32)
    cvec = col.view(3, -1).t().contiguous()
    n4 = kcenters_step.kcenters_iteration_skip.n_launches
    n3 = qcp_update.kcenters_iteration.n_launches
    out = {}
    for name, fn in (('k4', kcenters_step.kcenters_iteration_skip),
                     ('p4', kcenters_step.kcenters_iteration_skip_plain)):
        out[name] = [t.cpu().numpy() for t in fn(
            sh.frames_r, sh.g, d.clone(), a.clone(), tmax.clone(), col, gc,
            cid, mdt, 16, tile=sh.tile)]
    for name, fn in (('k3', qcp_update.kcenters_iteration),
                     ('p3', qcp_update.kcenters_iteration_plain)):
        out[name] = [t.cpu().numpy() for t in fn(
            sh.frames_r, sh.g, d.clone(), a.clone(), cvec, gc, cid, 16,
            tile=sh.tile, with_argmax=True)]
    torch.cuda.synchronize()
    assert kcenters_step.kcenters_iteration_skip.n_launches == n4 + 1
    assert qcp_update.kcenters_iteration.n_launches == n3 + 1
    gmax = 2 * float(sh.g.max())
    for k, p in (('k4', 'p4'), ('k3', 'p3')):
        assert_rmsd_close(out[k][0], out[p][0], gmax, 16)
        np.testing.assert_array_equal(out[k][1], out[p][1])
    assert (int(out['k4'][5][0, 0]) > 0) == (md_kind == 'finite')
    assert int(out['k4'][5][0, 0]) == int(out['p4'][5][0, 0])
    if md_kind == 'inf':
        for j, k in ((0, 0), (1, 1), (3, 2), (4, 3)):
            np.testing.assert_array_equal(out['k4'][j], out['k3'][k])


class _Fp32Only:
    """A kernel library without its bf16 entry points."""

    def __init__(self, lib, names):
        self._lib, self._names = lib, names

    def __getattr__(self, name):
        if name in self._names:
            raise AttributeError('%s did not load' % name)
        return getattr(self._lib, name)


@pytest.mark.cuda
def test_cuda_bf16_kernel_that_fails_to_load_raises(cuda, monkeypatch):
    """bf16 frames launch the bf16 entry points or raise: with them
    missing from the loaded library, nothing runs the fp32 kernel on
    converted frames, and no launch is counted."""
    prep = _bf16_prep(cuda, n=4096)
    lib4 = kcenters_step._kernel()
    lib3 = qcp_update._kernel()
    monkeypatch.setattr(kcenters_step, '_kernel', lambda: _Fp32Only(
        lib4, ('kc_chunk_bf16', 'kc_iter_skip_bf16')))
    monkeypatch.setattr(qcp_update, '_kernel', lambda: _Fp32Only(
        lib3, ('qu_iteration_bf16',)))
    counts = (kcenters_step.kcenters_chunk.n_launches,
              kcenters_step.kcenters_iteration_skip.n_launches,
              qcp_update.kcenters_iteration.n_launches)
    with pytest.raises(AttributeError, match='kc_chunk_bf16'):
        kcenters_step.kcenters_chunk(prep, _state(prep), 4)
    with pytest.raises(AttributeError, match='kc_chunk_bf16'):
        engine.kcenters_device_fused(prep, n_clusters=8)
    mesh = FrameMesh((cuda,) * 4)
    X = basin_data(np.random.default_rng(3), 4096, 16, n_basins=40)
    mesh_prep = engine.prepare_rmsd_frames(X, mesh=mesh, precision='bf16')
    for tri_skip, name in ((True, 'kc_iter_skip_bf16'),
                           (False, 'qu_iteration_bf16')):
        with pytest.raises(AttributeError, match=name):
            engine.kcenters_device_fused(mesh_prep, n_clusters=8, mesh=mesh,
                                         tri_skip=tri_skip)
    assert counts == (kcenters_step.kcenters_chunk.n_launches,
                      kcenters_step.kcenters_iteration_skip.n_launches,
                      qcp_update.kcenters_iteration.n_launches)


@pytest.mark.cuda
def test_cuda_bf16_sorted_and_streamed_paths_match_cpu(cuda, monkeypatch):
    """kcenters_device_fused in bf16, unsorted and sorted, on the card
    against the same on the CPU (plain versions); the streamed ingest on
    the card (pinned buffers, a side stream) bit for bit its monolithic
    layout and the CPU's."""
    X = basin_data(np.random.default_rng(6), 20_000, 16, n_basins=60)
    X = X[np.random.default_rng(7).permutation(len(X))]
    for sort in (None, 'locality'):
        rg = engine.kcenters_device_fused(X, n_clusters=64, device=cuda,
                                          precision='bf16', sort=sort)
        rc = engine.kcenters_device_fused(X, n_clusters=64, device='cpu',
                                          precision='bf16', sort=sort)
        np.testing.assert_array_equal(rg.center_indices, rc.center_indices)
        np.testing.assert_array_equal(rg.assignments, rc.assignments)
        Xc = X - X.mean(1, keepdims=True)
        assert_rmsd_close(rg.distances, rc.distances,
                          2.02 * float((Xc * Xc).sum((1, 2)).max()), 16)
    monkeypatch.setattr(engine, '_STREAM_CHUNK_BYTES', 3000 * 16 * 3 * 4)
    for precision in ('fp32', 'bf16'):
        strm = engine.prepare_rmsd_frames(X, device=cuda,
                                          precision=precision)
        mono = engine.prepare_rmsd_frames(X, device=cuda,
                                          precision=precision, stream=False)
        host = engine.prepare_rmsd_frames(X, device='cpu',
                                          precision=precision)
        assert torch.equal(strm.frames_r, mono.frames_r)
        assert torch.equal(strm.g, mono.g)
        assert torch.equal(strm.frames_r.cpu(), host.frames_r)
        assert torch.equal(strm.g.cpu(), host.g)
