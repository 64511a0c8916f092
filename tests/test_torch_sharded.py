"""enspara_tpu_torch's sharded path held against the JAX package: the
one-iteration kernels' plain versions (kernels 3 and 4), the sharded
k-centers loop, ``kcenters`` / ``assign_device`` over a mesh, the
sharded counts and the lag-sharded timescales.

The same numpy inputs go through both. The JAX kernels run in interpret
mode on the suite's 8 virtual CPU devices; the port runs its plain
versions on a mesh of 8 CPU shards (``FrameMesh(['cpu'] * 8)``).

Bars: center indices, assignments, argmaxes and skip counts exactly
equal (tie-free data), distances on the msd bar of
``test_torch_port.assert_rmsd_close``, integer counts exactly equal,
eigenvalues within 1e-4.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding

from enspara_tpu.cluster import engine as jengine
from enspara_tpu.msm.eigen_device import \
    implied_timescales_batched as jax_batched
from enspara_tpu.msm.transition_matrices import \
    assigns_to_counts_sharded as jax_counts_sharded
from enspara_tpu.ops.kcenters_skip_pallas import (
    kcenters_iteration_skip_pallas, skip_t_pad, tile_summaries)
from enspara_tpu.ops.qcp_update_pallas import kcenters_iteration_pallas
from enspara_tpu.parallel.mesh import FRAME_AXIS, P
from enspara_tpu.parallel.mesh import frame_mesh as jax_frame_mesh

from enspara_tpu_torch import convert, exception
from enspara_tpu_torch.cluster import (engine, engine_kmedoids, kcenters,
                                       kmedoids)
from enspara_tpu_torch.msm import (assigns_to_counts,
                                   assigns_to_counts_sharded,
                                   implied_timescales_batched)
from enspara_tpu_torch.ops.kcenters_step import kcenters_iteration_skip
from enspara_tpu_torch.ops.qcp_update import kcenters_iteration
from enspara_tpu_torch.parallel import FrameMesh
from enspara_tpu_torch.ra import RaggedArray

from test_torch_kcenters import _jax_chunk
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


def _jax_mesh():
    return Mesh(np.array(jax.devices()[:8]), (FRAME_AXIS,))


def _cpu_mesh(n=8):
    return FrameMesh(['cpu'] * n)


def _t(x, dtype):
    return torch.from_numpy(np.array(x, dtype=dtype))


def _s(v, dtype):
    return np.full((1, 1), v, dtype)


def _gsum_max(X):
    Xc = X - X.mean(axis=1, keepdims=True)
    return 2 * float((Xc * Xc).sum((1, 2)).max())


@pytest.mark.parametrize('with_argmax', [False, True])
def test_iteration_plain_matches_pallas(with_argmax):
    """Kernel 3's plain version against ``kcenters_iteration_pallas`` over
    three centers from a fresh state (n 1000 padded to 1024)."""
    X = basin_data(np.random.default_rng(21), 1000, 8, n_basins=12)
    jprep = jengine.prepare_rmsd_frames(X, tile=128)
    fr, g = np.asarray(jprep.frames_r), np.asarray(jprep.g)
    a_pad = fr.shape[0] // 3
    dist_j, assig_j = fresh_arrays(1000, fr.shape[1])
    dist_p, assig_p = _t(dist_j, np.float32), _t(assig_j, np.int32)
    dist_j, assig_j = jnp.asarray(dist_j), jnp.asarray(assig_j)
    for k, c in enumerate((0, 517, 900)):
        cvec = fr[:, c].reshape(3, a_pad).T.copy()
        args = (cvec, _s(g[0, c], np.float32), _s(k, np.int32))
        ref = kcenters_iteration_pallas(
            jnp.asarray(fr), jnp.asarray(g), dist_j, assig_j,
            *(jnp.asarray(x) for x in args), 8, interpret=True, tile=128,
            with_argmax=with_argmax)
        port = kcenters_iteration(
            _t(fr, np.float32), _t(g, np.float32), dist_p, assig_p,
            *(torch.from_numpy(x) for x in args), 8, tile=128,
            with_argmax=with_argmax)
        dist_j, assig_j = ref[0], ref[1]
        assert port[0] is dist_p and port[1] is assig_p      # in place
        assert_rmsd_close(dist_p.numpy(), np.asarray(dist_j),
                          2 * g.max(), 8)
        np.testing.assert_array_equal(assig_p.numpy(), np.asarray(assig_j))
        if with_argmax:
            assert_rmsd_close(port[2].numpy(), np.asarray(ref[2]),
                              2 * g.max(), 8)
            np.testing.assert_array_equal(port[3].numpy(),
                                          np.asarray(ref[3]))
    assert kcenters_iteration.n_launches == 0


@pytest.mark.parametrize('md', ['finite', 'inf'])
def test_iteration_skip_plain_matches_pallas(md):
    """Kernel 4's plain version against ``kcenters_iteration_skip_pallas``
    from the state 16 chunk iterations leave on basin data: with the
    finite md that chose the center, tiles skip (``skipcnt`` exact); with
    md = inf nothing skips."""
    X = basin_data(np.random.default_rng(5), 2048, 8, n_basins=40)
    jprep = jengine.prepare_rmsd_frames(X, tile=128)
    fr, g = np.asarray(jprep.frames_r), np.asarray(jprep.g)
    dist, assig = fresh_arrays(2048, 2048)
    tmax = np.asarray(tile_summaries(jnp.asarray(dist), 128, skip_t_pad(16)))
    d, asg, _, gidx, mdv, tm, _ = _jax_chunk(jprep, dist, assig, tmax, 0,
                                             np.inf, 0, 64, 0.0, 16)
    c = int(gidx[0, 0])
    md_v = float(mdv[0, 0]) if md == 'finite' else np.inf
    args = (tm, fr[:, c:c + 1].copy(), _s(g[0, c], np.float32),
            _s(16, np.int32), _s(md_v, np.float32))
    ref = [np.asarray(x) for x in kcenters_iteration_skip_pallas(
        jnp.asarray(fr), jnp.asarray(g), jnp.asarray(d), jnp.asarray(asg),
        *(jnp.asarray(x) for x in args), 8, interpret=True, tile=128)]
    tensors = [_t(x, x.dtype) for x in (d, asg) + args]
    port = [t.numpy() for t in kcenters_iteration_skip(
        _t(fr, np.float32), _t(g, np.float32), *tensors[:3], *tensors[3:],
        8, tile=128)]
    gmax = 2 * g.max()
    for k in (0, 2, 3):                 # dist, tmax, lmax
        assert_rmsd_close(port[k], ref[k], gmax, 8)
    for k in (1, 4, 5):                 # assig, largmax, skipcnt
        np.testing.assert_array_equal(port[k], ref[k])
    assert (int(port[5][0, 0]) > 0) == (md == 'finite')
    assert kcenters_iteration_skip.n_launches == 0


@pytest.mark.parametrize('tri_skip', [True, False])
def test_sharded_loop_matches_jax(tri_skip):
    """The port's sharded loop on 8 CPU shards against the JAX package's
    on the 8-device mesh (tests/test_kcenters_skip.py:133-172), on basin
    data where skips fire, from the same JAX layout."""
    mesh = _jax_mesh()
    n, a, k = 4096, 8, 48
    X = basin_data(np.random.default_rng(21), n, a, n_basins=40, dwell=256)
    jprep = jengine.prepare_rmsd_frames(X, tile=128, mesh=mesh)
    n_pad = jprep.frames_r.shape[1]
    dist, assig = fresh_arrays(n, n_pad)
    sh = NamedSharding(mesh, P(None, FRAME_AXIS))
    d_j, a_j, c_j, n_j = jengine._kcenters_loop_fused_sharded(
        jprep.frames_r, jprep.g, jax.device_put(dist, sh),
        jax.device_put(assig, sh), np.int32(0), np.int32(k),
        np.float32(0.0), k, a, mesh, True, jprep.tile, tri_skip=tri_skip)

    cmesh = _cpu_mesh()
    prep = convert.sharded_from_numpy(jprep.frames_r, jprep.g, n, a, 128,
                                      cmesh)
    n_local = prep.n_local
    state, ctr, n_found = engine._kcenters_loop_fused_sharded(
        prep, [_t(dist[:, s * n_local:(s + 1) * n_local], np.float32)
               for s in range(8)],
        [_t(assig[:, s * n_local:(s + 1) * n_local], np.int32)
         for s in range(8)], 0, k, 0.0, k, cmesh, tri_skip=tri_skip)
    assert n_found == int(np.asarray(n_j)) == k
    np.testing.assert_array_equal(ctr.numpy(), np.asarray(c_j))
    np.testing.assert_array_equal(
        np.concatenate([x.numpy() for x in state.assig], axis=1),
        np.asarray(a_j))
    assert_rmsd_close(np.concatenate([x.numpy() for x in state.dist], axis=1),
                      np.asarray(d_j), 2 * float(np.asarray(jprep.g).max()),
                      a)
    if tri_skip:
        assert int(state.skipped) > 0, 'basin data must skip tiles'


@pytest.mark.parametrize('case', ['cutoff', 'warm_start'])
def test_kcenters_on_mesh_equals_one_device(case):
    """``kcenters(mesh=8 CPU shards)`` equals ``kcenters`` on one device
    and the JAX package's sharded fused loop (tests/test_kcenters.py:
    188-204, tests/test_qcp_pallas.py:63-77), with a distance cutoff or
    from a warm start."""
    rng = np.random.default_rng(9)
    X = rng.normal(size=(600, 10, 3)).astype(np.float32)
    mesh = _cpu_mesh()
    if case == 'cutoff':
        kw = dict(n_clusters=80, dist_cutoff=1.7)
        ref = jengine.kcenters_device_fused(X, tile=128, interpret=True,
                                            mesh=jax_frame_mesh(), **kw)
        assert ref.n_found < 80
    else:
        first = kcenters(X, 'rmsd', n_clusters=8)
        kw = dict(n_clusters=20, init_centers=[X[i] for i in
                                               first.center_indices])
        ref = None
    one = kcenters(X, 'rmsd', **kw) if case == 'warm_start' else \
        engine.kcenters_device_fused(X, tile=128, device='cpu', **kw)
    sharded = kcenters(X, 'rmsd', mesh=mesh, **kw) \
        if case == 'warm_start' else \
        engine.kcenters_device_fused(X, tile=128, mesh=mesh, **kw)
    gmax = _gsum_max(X)
    for other in filter(None, (one, ref)):
        np.testing.assert_array_equal(sharded.center_indices,
                                      other.center_indices)
        np.testing.assert_array_equal(sharded.assignments, other.assignments)
        assert_rmsd_close(sharded.distances, other.distances, gmax, 10)
    if case == 'warm_start':
        np.testing.assert_array_equal(sharded.center_indices[:8],
                                      first.center_indices)
        assert len(sharded.center_indices) == 20


def test_assign_device_on_mesh_matches_jax():
    """``assign_device(mesh=)`` against the JAX package's sharded Pallas
    assignment (tests/test_qcp_pallas.py:39-60) and the one-device
    assignment."""
    from enspara_tpu.parallel import mesh as pmesh

    rng = np.random.default_rng(2)
    X = rng.normal(size=(160, 20, 3)).astype(np.float32)
    centers = X[[0, 40, 80, 120]]
    jmesh = pmesh.frame_mesh()
    data_sh, _ = jengine.prepare_sharded(X, 'rmsd', jmesh)
    centers_r = jengine._center_structures(pmesh.replicated(centers, jmesh))
    a_j, d_j = jengine._assign_rmsd_pallas_sharded(data_sh, centers_r, 4,
                                                   jmesh)
    a_p, d_p = engine.assign_device(X, centers, 'rmsd', mesh=_cpu_mesh())
    a_1, d_1 = engine.assign_device(X, centers, 'rmsd', device='cpu')
    gmax = _gsum_max(X)
    np.testing.assert_array_equal(a_p, np.asarray(a_j)[:160])
    assert_rmsd_close(d_p, np.asarray(d_j)[:160], gmax, 20)
    np.testing.assert_array_equal(a_p, a_1)
    np.testing.assert_array_equal(d_p, d_1)


def test_counts_sharded_matches_jax_and_host():
    """Trajectory-sharded counting over 8 CPU shards equals the JAX
    package's over the 8-device mesh and the host counts on gap-free
    rows (tests/test_msm.py:393-410); 13 rows pad to 16."""
    rng = np.random.default_rng(3)
    assigns = rng.integers(0, 7, size=(13, 211))
    mask = np.ones_like(assigns, dtype=bool)
    mask[:, 200:] = False
    host = assigns_to_counts([row[:200] for row in assigns], max_n_states=7,
                             lag_time=3).toarray()
    ref = np.asarray(jax_counts_sharded(assigns, mask, 3, 7,
                                        mesh=jax_frame_mesh()))
    port = assigns_to_counts_sharded(assigns, mask, 3, 7, mesh=_cpu_mesh())
    assert port.dtype == torch.int32
    np.testing.assert_array_equal(port.numpy(), ref)
    np.testing.assert_array_equal(port.numpy(), host)
    strided = assigns_to_counts_sharded(assigns, mask, 3, 7,
                                        sliding_window=False,
                                        mesh=_cpu_mesh(4))
    np.testing.assert_array_equal(
        strided.numpy(),
        assigns_to_counts([row[:200] for row in assigns], max_n_states=7,
                          lag_time=3, sliding_window=False).toarray())


def test_counts_sharded_validates_inputs():
    """Out-of-range masked-in ids and bad lags raise up front
    (tests/test_msm.py:455-466); masked-out sentinels are padding."""
    a = np.array([[0, 1, 5, 1]])
    m = np.ones_like(a, dtype=bool)
    with pytest.raises(exception.DataInvalid, match='>= n_states'):
        assigns_to_counts_sharded(a, m, 1, n_states=3, mesh=_cpu_mesh(2))
    with pytest.raises(exception.DataInvalid, match='lag_time'):
        assigns_to_counts_sharded(a, m, 0, n_states=6, mesh=_cpu_mesh(2))
    m[0, 2] = False
    counts = assigns_to_counts_sharded(a, m, 1, n_states=3,
                                       mesh=_cpu_mesh(2))
    assert int(counts.sum()) == 1 and int(counts[0, 1]) == 1


def test_batched_timescales_lag_sharded():
    """``implied_timescales_batched`` with the lags split over 8 CPU
    shards (3 lags: the shards pad with lag 1) equals the unsharded
    batch (tests/test_eigen_device.py:264-289), and both hold the JAX
    package's eigenvalues exp(-lag/t) to 1e-4."""
    rng = np.random.RandomState(2)
    assigns = RaggedArray([rng.randint(0, 5, size=n) for n in (300, 211, 97)])
    for lags in ([2, 5, 9], [1, 2, 3, 4, 5, 6, 7, 8]):
        base = implied_timescales_batched(assigns, lags, n_times=3)
        shrd = implied_timescales_batched(assigns, lags, n_times=3,
                                          mesh=_cpu_mesh())
        ref = jax_batched(assigns, lags, n_times=3)
        assert shrd.shape == base.shape == ref.shape == (len(lags), 3)
        np.testing.assert_array_equal(shrd, base)
        lag = np.asarray(lags, np.float64)[:, None]
        np.testing.assert_allclose(np.exp(-lag / base), np.exp(-lag / ref),
                                   atol=1e-4)


def test_shard_count_mismatch_raises():
    """Prepared frames run only on a mesh of their shard count
    (engine.py:927-933), in the PAM sweeps as in k-centers; given no
    mesh, the sweeps run a sharded container over its own shards (the
    fused loop, whose JAX counterpart reads no mesh as one device,
    raises); kmedoids over a 2-shard mesh runs the sweeps over it and
    equals one device."""
    X = np.random.default_rng(0).normal(size=(300, 6, 3)).astype(np.float32)
    prep4 = engine.prepare_rmsd_frames(X, tile=32, mesh=_cpu_mesh(4))
    assert prep4.n_shards == 4 and prep4.n_local * 4 % (32 * 4) == 0
    one = engine.prepare_rmsd_frames(X, tile=32)
    warm = (np.zeros(300), np.zeros(300), [0, 1, 2, 3])
    for x, mesh in ((prep4, _cpu_mesh(8)), (prep4, None),
                    (one, _cpu_mesh(2))):
        with pytest.raises(ValueError, match='laid out for'):
            engine.kcenters_device_fused(x, n_clusters=4, mesh=mesh)
        if mesh is None:
            own = engine_kmedoids.kmedoids_sweeps_device(x, 'rmsd', *warm)
            ref = engine_kmedoids.kmedoids_sweeps_device(
                x, 'rmsd', *warm, mesh=_cpu_mesh(4))
            for a, b in zip(own, ref):
                np.testing.assert_array_equal(a, b)
            continue
        with pytest.raises(ValueError, match='laid out for'):
            engine_kmedoids.kmedoids_sweeps_device(x, 'rmsd', *warm,
                                                   mesh=mesh)
    with pytest.raises(ValueError, match='laid out for'):
        engine.assign_device(prep4, X[:2], 'rmsd', mesh=_cpu_mesh(2))
    # half the scale: the cold start's warm-start gate (1e-3) refuses the
    # fp32 self-distances of unit-scale random frames on one device too
    Xk = X / 2
    got = kmedoids(Xk, 'rmsd', n_clusters=4, random_state=1,
                   mesh=_cpu_mesh(2))
    # the one-device call of the same sweeps: the cold start's draw and
    # assignment, then the device sweeps (the CPU's default is the host
    # path, which has no shards)
    rs = np.random.RandomState(1)
    inds = rs.choice(len(X), size=4, replace=False)
    a, d = engine.assign_device(Xk, Xk[inds], 'rmsd', device='cpu')
    ref = importlib.import_module(
        'enspara_tpu_torch.cluster.kmedoids')._kmedoids_iterations(
        Xk, 'rmsd', 5, list(inds), a, d, random_state=rs, backend='device',
        device='cpu')
    np.testing.assert_array_equal(got.center_indices, ref.center_indices)
    np.testing.assert_array_equal(got.assignments, ref.assignments)
    assert not np.array_equal(got.center_indices, inds)
    res = engine.kcenters_device_fused(prep4, n_clusters=4,
                                       mesh=_cpu_mesh(4))
    assert res.n_found == 4
