"""enspara_tpu_torch's sharded k-centers path on the card. Imports no jax:
on the card machine, run with
``python -m pytest --noconftest -m cuda tests/test_torch_cuda_sharded.py``.

The ``cuda`` tests skip without a card. They hold kernel 3
(``csrc/qcp_update.cu``) and kernel 4 (``kc_iter_skip`` of
``csrc/kcenters_step.cu``) against their plain versions, each kernel's
``tmax``, ``(lmax, largmax)`` and ``skipcnt`` against what its own output
distances and the skip rule give, the two kernels bit for bit against
each other when nothing skips, and the mesh paths (the sharded loop,
sharded assignment, sharded counts, lag-sharded timescales, the PAM
sweeps with kernel 5 on every shard) on four virtual shards of one card
against the same on the CPU or on one device. A k-hybrid fit lays its
frames out once, on two CPU shards and on the card.
"""

import numpy as np
import pytest
import torch

from enspara_tpu_torch.cluster import (KHybrid, engine, engine_kmedoids,
                                       kcenters)
from enspara_tpu_torch.msm import (assigns_to_counts_sharded,
                                   implied_timescales_batched)
from enspara_tpu_torch.ops import kcenters_step, qcp_matrix, qcp_update
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


def _shard_state(cuda, n_iters=16):
    """Shard 1 of 4 of 16,384 basin frames x 16 atoms (tile 256), the
    state ``n_iters`` chunk iterations leave on the whole set, and the
    next center: ``(shard prep, dist, assig, tmax, col, gc, cid, md)``."""
    X = basin_data(np.random.default_rng(3), 16_384, 16, n_basins=40,
                   dwell=512)
    prep = engine.prepare_rmsd_frames(X, device=cuda)
    dist, assig = fresh_arrays(prep.n, prep.frames_r.shape[1])
    st = kcenters_step.start_state(
        torch.from_numpy(dist).to(cuda), torch.from_numpy(assig).to(cuda),
        prep.frames_r.shape[0], prep.tile, 0, 1 << 30, 0.0)
    kcenters_step.kcenters_chunk(prep, st, n_iters)
    gidx, md, i = st.scalars()
    lo, hi = 4096, 8192
    sh = engine.PreparedRMSDFrames(prep.frames_r[:, lo:hi].contiguous(),
                                   prep.g[:, lo:hi].contiguous(), hi - lo,
                                   prep.n_atoms, prep.tile)
    d = st.dist[:, lo:hi].contiguous()
    tmax = kcenters_step.tile_summaries(d, prep.tile,
                                        kcenters_step.skip_t_pad(16))
    col = prep.frames_r[:, gidx:gidx + 1].contiguous()
    gc = prep.g[:, gidx:gidx + 1].contiguous()
    one = lambda v, dt: torch.full((1, 1), v, dtype=dt, device=cuda)
    return (sh, d, st.assig[:, lo:hi].contiguous(), tmax, col, gc,
            one(i, torch.int32), one(md, torch.float32))


def _both(sh, d, a, tmax, col, gc, cid, md):
    """Kernels 3 and 4 and their plain versions from copies of one
    state, as numpy: {name: outputs}."""
    cvec = col.view(3, -1).t().contiguous()
    out = {}
    for name, fn in (('k4', kcenters_step.kcenters_iteration_skip),
                     ('p4', kcenters_step.kcenters_iteration_skip_plain)):
        r = fn(sh.frames_r, sh.g, d.clone(), a.clone(), tmax.clone(), col,
               gc, cid, md, sh.n_atoms, tile=sh.tile)
        out[name] = [t.cpu().numpy() for t in r]
    for name, fn in (('k3', qcp_update.kcenters_iteration),
                     ('p3', qcp_update.kcenters_iteration_plain)):
        r = fn(sh.frames_r, sh.g, d.clone(), a.clone(), cvec, gc, cid,
               sh.n_atoms, tile=sh.tile, with_argmax=True)
        out[name] = [t.cpu().numpy() for t in r]
    return out


@pytest.mark.cuda
@pytest.mark.parametrize('md_kind', ['finite', 'inf'])
def test_cuda_iteration_kernels_match_plain(cuda, md_kind):
    sh, d, a, tmax, col, gc, cid, md = _shard_state(cuda)
    if md_kind == 'inf':
        md = torch.full_like(md, float('inf'))
    n4 = kcenters_step.kcenters_iteration_skip.n_launches
    n3 = qcp_update.kcenters_iteration.n_launches
    o = _both(sh, d, a, tmax, col, gc, cid, md)
    torch.cuda.synchronize()
    assert kcenters_step.kcenters_iteration_skip.n_launches == n4 + 1
    assert qcp_update.kcenters_iteration.n_launches == n3 + 1
    gmax = 2 * float(sh.g.max())
    for k, p in (('k4', 'p4'), ('k3', 'p3')):
        assert_rmsd_close(o[k][0], o[p][0], gmax, 16)
        np.testing.assert_array_equal(o[k][1], o[p][1])
    n_tiles = sh.frames_r.shape[1] // sh.tile
    tm_in = tmax[0, :n_tiles].cpu().numpy()
    rule = int(((tm_in <= 0.5 * float(md)) & np.isfinite(float(md))).sum())
    for k, (lm, la) in (('k4', (3, 4)), ('k3', (2, 3))):
        dk = o[k][0][0]
        assert float(o[k][lm][0, 0]) == dk.max()
        assert int(o[k][la][0, 0]) == int(np.argmax(dk))
    np.testing.assert_array_equal(o['k4'][2][0, :n_tiles],
                                  o['k4'][0][0].reshape(n_tiles, -1).max(1))
    assert int(o['k4'][5][0, 0]) == int(o['p4'][5][0, 0]) == rule
    assert (rule > 0) == (md_kind == 'finite'), rule
    for j, k in ((0, 0), (1, 1), (3, 2), (4, 3)):
        np.testing.assert_array_equal(o['k4'][j], o['k3'][k])


@pytest.mark.cuda
def test_cuda_stop_flag_leaves_state(cuda):
    sh, d, a, tmax, col, gc, cid, md = _shard_state(cuda)
    stop = torch.ones((1, 1), dtype=torch.int32, device=cuda)
    d0, a0, t0 = d.clone(), a.clone(), tmax.clone()
    _, _, _, lm, la, sk = kcenters_step.kcenters_iteration_skip(
        sh.frames_r, sh.g, d, a, tmax, col, gc, cid, md, sh.n_atoms,
        tile=sh.tile, stop=stop)
    _, _, lm3, la3 = qcp_update.kcenters_iteration(
        sh.frames_r, sh.g, d, a, col.view(3, -1).t().contiguous(), gc, cid,
        sh.n_atoms, tile=sh.tile, with_argmax=True, stop=stop)
    for x, y in ((d, d0), (a, a0), (tmax, t0)):
        assert torch.equal(x, y)
    assert float(lm) == float(lm3) == -np.inf
    assert int(la) == int(la3) == int(sk) == 0


@pytest.mark.cuda
def test_cuda_sharded_loop_matches_cpu(cuda):
    """K-centers over four virtual shards of the card equals the same
    over four CPU shards (plain versions); tri_skip on (kernel 4) and off
    (kernel 3) agree bit for bit; four launches an iteration, none of
    kernel 1."""
    X = basin_data(np.random.default_rng(4), 12_000, 16, n_basins=30)
    mesh = FrameMesh([cuda] * 4)
    out = {}
    for name, m, skip in (('cpu', FrameMesh(['cpu'] * 4), True),
                          ('on', mesh, True), ('off', mesh, False)):
        counts = (kcenters_step.kcenters_chunk.n_launches,
                  kcenters_step.kcenters_iteration_skip.n_launches,
                  qcp_update.kcenters_iteration.n_launches)
        res = engine.kcenters_device_fused(X, n_clusters=90, mesh=m,
                                           tri_skip=skip)
        torch.cuda.synchronize()
        out[name] = (res, [b - a for a, b in zip(counts, (
            kcenters_step.kcenters_chunk.n_launches,
            kcenters_step.kcenters_iteration_skip.n_launches,
            qcp_update.kcenters_iteration.n_launches))])
    (rc, lc), (ron, lon), (roff, loff) = out.values()
    assert lc == [0, 0, 0]
    assert lon == [0, 4 * 90, 0] and loff == [0, 0, 4 * 90]
    for x, y in zip(ron, roff):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(ron.center_indices, rc.center_indices)
    np.testing.assert_array_equal(ron.assignments, rc.assignments)
    Xc = X - X.mean(axis=1, keepdims=True)
    assert_rmsd_close(ron.distances, rc.distances,
                      2 * float((Xc * Xc).sum((1, 2)).max()), 16)


@pytest.mark.cuda
def test_cuda_mesh_paths_match_one_device(cuda):
    """Sharded assignment equals the one-device assignment on the card,
    sharded counts equal numpy, lag-sharded timescales equal the
    unsharded batch."""
    X = basin_data(np.random.default_rng(5), 9_000, 16, n_basins=30)
    mesh = FrameMesh([cuda] * 4)
    centers = X[::90]
    a_m, d_m = engine.assign_device(X, centers, 'rmsd', mesh=mesh)
    a_1, d_1 = engine.assign_device(X, centers, 'rmsd', device=cuda)
    np.testing.assert_array_equal(a_m, a_1)
    np.testing.assert_array_equal(d_m, d_1)
    a = a_m.reshape(9, -1)
    counts = assigns_to_counts_sharded(a, np.ones_like(a, bool), 3, 100,
                                       mesh=mesh)
    assert counts.is_cuda
    ref = np.bincount((a[:, :-3] * 100 + a[:, 3:]).ravel(),
                      minlength=100 ** 2).reshape(100, 100)
    np.testing.assert_array_equal(counts.cpu().numpy(), ref)
    lags = [1, 2, 3, 5, 8]
    base = implied_timescales_batched(a, lags, n_times=5, device=cuda)
    shrd = implied_timescales_batched(a, lags, n_times=5, mesh=mesh)
    assert shrd.shape == (5, 5)
    np.testing.assert_array_equal(shrd, base)


@pytest.mark.cuda
def test_cuda_sharded_pam_matches_cpu(cuda, monkeypatch):
    """The PAM sweeps over four virtual shards of the card equal the same
    sweeps over four CPU shards (plain versions) and on the card alone,
    from the same random bits; kernel 5 runs on every shard's blocks
    (a multiple of four launches) and never on the CPU shards."""
    X = basin_data(np.random.default_rng(6), 6_000, 16, n_basins=80,
                   noise=0.1)
    seed = engine.kcenters_device_fused(X, n_clusters=60, device=cuda)
    real = engine_kmedoids.sweep_bits

    def cpu_bits(s, n_sweeps, n, device):
        for b in real(s, n_sweeps, n, 'cpu'):
            yield b.to(device)
    monkeypatch.setattr(engine_kmedoids, 'sweep_bits', cpu_bits)
    out = {}
    for name, kw in (('cpu', dict(mesh=FrameMesh(['cpu'] * 4))),
                     ('mesh', dict(mesh=FrameMesh([cuda] * 4))),
                     ('one', dict(device=cuda))):
        q0 = qcp_matrix.qcp_rmsd_matrix_kernel.n_launches
        res = engine_kmedoids.kmedoids_sweeps_device(
            X, 'rmsd', seed.assignments, seed.distances, seed.center_indices,
            n_sweeps=2, seed=5, **kw)
        torch.cuda.synchronize()
        out[name] = res, qcp_matrix.qcp_rmsd_matrix_kernel.n_launches - q0
    (rc, lc), (rm, lm), (r1, l1) = out.values()
    assert lc == 0 and l1 > 0 and lm > 0 and lm % 4 == 0
    for m, d, a in (rm, r1):
        np.testing.assert_array_equal(m, rc[0])
        np.testing.assert_array_equal(a, rc[2])
        assert_rmsd_close(d, rc[1], 2 * float(
            ((X - X.mean(1, keepdims=True)) ** 2).sum((1, 2)).max()), 16)
    assert not np.array_equal(rc[0], seed.center_indices)
    assert np.mean(rm[1] ** 2) < np.mean(seed.distances ** 2)


@pytest.mark.parametrize('place', ['two CPU shards',
                                   pytest.param('one card',
                                                marks=pytest.mark.cuda)])
def test_khybrid_lays_out_its_frames_once(place, request, monkeypatch):
    """A ``KHybrid`` fit that takes the device sweeps lays its frames out
    once: the k-centers stage's layout serves the sweeps. It equals the
    two stages run by hand from the same draws (the first center's seed,
    then the sweeps' seed), which lay the frames out twice."""
    if place == 'one card':
        kw = dict(device=request.getfixturevalue('cuda'))
    else:
        kw = dict(mesh=FrameMesh(['cpu'] * 2))
    X = basin_data(np.random.default_rng(7), 3_000, 16, n_basins=40,
                   noise=0.1)
    real, calls = engine.prepare_rmsd_frames, []

    def spy(*args, **kwargs):
        calls.append(kwargs)
        return real(*args, **kwargs)
    monkeypatch.setattr(engine, 'prepare_rmsd_frames', spy)
    fit = KHybrid('rmsd', n_clusters=8, kmedoids_updates=2,
                  random_first_center=True, random_state=6,
                  **kw).fit(X).result_
    assert len(calls) == 1
    rs = np.random.RandomState(6)
    kc = kcenters(X, 'rmsd', n_clusters=8, random_first_center=True,
                  random_state=rs.randint(2 ** 31), **kw)
    m, d, a = engine_kmedoids.kmedoids_sweeps_device(
        X, 'rmsd', kc.assignments, kc.distances, kc.center_indices,
        n_sweeps=2, seed=rs.randint(2 ** 31), **kw)
    assert len(calls) == 3
    assert not np.array_equal(m, kc.center_indices)
    np.testing.assert_array_equal(fit.center_indices, m)
    np.testing.assert_array_equal(fit.assignments, a)
    np.testing.assert_array_equal(fit.distances, d)
