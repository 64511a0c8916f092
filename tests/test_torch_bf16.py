"""enspara_tpu_torch's bf16 frame stream held against the JAX package:
the bf16 layout of ``prepare_rmsd_frames(precision='bf16')``, the plain
versions of kernels 1-4 on bf16 frames against the Pallas kernels in
interpret mode, ``kcenters_device_fused`` in bf16 (both skip settings, a
warm start, a CPU mesh), the precision rules of prepared frames, and
``KCenters(precision=, sort=)``.

Centering before rounding: an fp32 ulp of difference in a frame's mean
flips the bf16 rounding of a coordinate now and then, and a flipped
coordinate moves a distance far past the distance bar. So the parity
tests that prepare coordinates in both packages use ``grid_data``:
coordinates on a dyadic grid whose per-frame mean is exactly 0 in any
summation order, so both packages round the same numbers. The kernel
tests carry the JAX package's own bf16 layout across.

Bars: the layout bit for bit (as 16-bit words), G within one ulp;
center indices, assignments and skip counts exactly equal (tie-free
data); distances on the msd bar of ``test_torch_port.assert_rmsd_close``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from enspara_tpu.cluster import engine as jengine
from enspara_tpu.cluster.kcenters import kcenters as jax_kcenters
from enspara_tpu.ops.kcenters_chunk_pallas import kcenters_chunk_pallas
from enspara_tpu.ops.kcenters_skip_pallas import (
    kcenters_iteration_skip_pallas, skip_t_pad, tile_summaries)
from enspara_tpu.ops.qcp_update_pallas import kcenters_iteration_pallas
from enspara_tpu.parallel.mesh import FRAME_AXIS

from enspara_tpu_torch import convert
from enspara_tpu_torch.cluster import KCenters, engine, kcenters
from enspara_tpu_torch.exception import ImproperlyConfigured
from enspara_tpu_torch.ops import kcenters_step
from enspara_tpu_torch.ops.kcenters_step import kcenters_iteration_skip
from enspara_tpu_torch.ops.qcp import qcp_rmsd_vector
from enspara_tpu_torch.ops.qcp_update import kcenters_iteration
from enspara_tpu_torch.parallel import FrameMesh

from test_torch_kcenters import _assert_chunks_equal, _jax_chunk
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


def grid_data(rng, n, a, n_basins):
    """Basin frames on the grid of multiples of 2**-10 (|x| < 2**6),
    the last atom minus the sum of the others: every partial sum of a
    frame's coordinates is exact in float32, so its mean is exactly 0
    and both packages center it to itself, then round the same values
    to bf16."""
    X = np.round(basin_data(rng, n, a, n_basins) * 1024) / 1024
    X[:, -1] = -X[:, :-1].sum(axis=1)
    assert np.abs(X).max() < 64
    return X.astype(np.float32)


def _bits(frames, a, n):
    """The real atom rows and frames of a bf16 layout as int16 words."""
    if isinstance(frames, torch.Tensor):
        words = frames.view(torch.int16).numpy()
    else:
        words = np.asarray(frames).view(np.int16)
    return words.reshape(3, -1, words.shape[1])[:, :a, :n]


def _gsum(g):
    return 2 * float(np.max(np.asarray(g, np.float32)))


def _port_prep(jprep, tile=None):
    return convert.prepared_from_numpy(
        jprep.frames_r, jprep.g, jprep.n, jprep.n_atoms,
        tile=tile or jprep.tile, precision='bf16')


def test_bf16_layout_matches_jax():
    """Centered in float32, rounded once to nearest even: the layout is
    the JAX package's bit for bit and G within one ulp; the sharded
    layout is the one-device layout cut into shards."""
    n, a = 300, 10
    X = grid_data(np.random.default_rng(11), n, a, n_basins=8)
    jprep = jengine.prepare_rmsd_frames(X, tile=128, precision='bf16')
    prep = engine.prepare_rmsd_frames(X, tile=128, precision='bf16')
    assert prep.precision == 'bf16' and prep.perm is None
    assert prep.frames_r.dtype == torch.bfloat16
    assert tuple(prep.frames_r.shape) == (48, 384)
    np.testing.assert_array_equal(_bits(prep.frames_r, a, n),
                                  _bits(jprep.frames_r, a, n))
    g, jg = prep.g.numpy()[0], np.asarray(jprep.g)[0]
    assert (np.abs(g[:n] - jg[:n]) <= np.spacing(jg[:n])).all()
    assert (g[n:] == 1.0).all()
    assert (prep.frames_r.float().numpy()[:, n:] == 0).all()
    # G is the sum of squares of the rounded coordinates
    r = prep.frames_r.float().numpy()[:, :n]
    np.testing.assert_allclose(g[:n], (r.astype(np.float64) ** 2).sum(0),
                               rtol=1e-6)

    sh = engine.prepare_rmsd_frames(X, tile=128, precision='bf16',
                                    mesh=FrameMesh(['cpu'] * 2))
    assert sh.precision == 'bf16' and sh.n_local == 256
    whole = torch.cat([s.frames_r for s in sh.shards], dim=1)
    np.testing.assert_array_equal(whole.view(torch.int16).numpy()[:, :n],
                                  prep.frames_r.view(torch.int16)
                                  .numpy()[:, :n])
    np.testing.assert_array_equal(
        torch.cat([s.g for s in sh.shards], dim=1).numpy()[0, :n], g[:n])


def _state_args(jprep, case):
    """Chunk arguments: a fresh run, or the carry of a first 8-iteration
    JAX chunk (finite md: tiles skip)."""
    n_pad, tile = jprep.frames_r.shape[1], jprep.tile
    dist, assig = fresh_arrays(jprep.n, n_pad)
    tmax = np.asarray(tile_summaries(jnp.asarray(dist), tile,
                                     skip_t_pad(n_pad // tile)))
    if case == 'fresh':
        return (dist, assig, tmax, 0, np.inf, 0, 64, 0.0, 16)
    d, asg, _, gidx, md, tm, _ = _jax_chunk(jprep, dist, assig, tmax, 0,
                                            np.inf, 0, 64, 0.0, 8)
    return (d, asg, tm, gidx[0, 0], md[0, 0], 8, 64, 0.0, 16)


@pytest.mark.parametrize('case', ['fresh', 'carry'])
def test_bf16_chunk_matches_pallas(case):
    """Kernels 1 and 2 (the chunk with and without skipping) on the JAX
    package's bf16 layout: the plain chunk against
    ``kcenters_chunk_skip_pallas`` and ``kcenters_chunk_pallas``."""
    X = basin_data(np.random.default_rng(5), 1024, 10, n_basins=40)
    jprep = jengine.prepare_rmsd_frames(X, tile=128, precision='bf16')
    assert jprep.frames_r.dtype == jnp.bfloat16
    args = _state_args(jprep, case)
    ref = _jax_chunk(jprep, *args)
    prep = _port_prep(jprep)
    state = convert.state_from_numpy(*args[:3], prep.frames_r.shape[0],
                                     *args[3:8])
    ctr, skipcnt = kcenters_step.kcenters_chunk(prep, state, args[8])
    port = convert.result_to_numpy(state, ctr, skipcnt)
    _assert_chunks_equal(port, ref, jprep)
    if case == 'carry':
        assert ref[6].sum() > 0, 'basin data must give skippable tiles'

    def s(v, dtype):
        return jnp.full((1, 1), v, dtype)
    noskip = [np.asarray(x) for x in kcenters_chunk_pallas(
        jprep.frames_r, jprep.g, jnp.asarray(args[0]), jnp.asarray(args[1]),
        s(args[3], jnp.int32), s(args[4], jnp.float32),
        s(args[5], jnp.int32), s(args[6], jnp.int32),
        s(args[7], jnp.float32), args[8], jprep.n_atoms, interpret=True,
        tile=128)]
    for k in (1, 2, 3):
        np.testing.assert_array_equal(port[k], noskip[k])
    for k in (0, 4):
        assert_rmsd_close(port[k], noskip[k], _gsum(jprep.g), 10)


@pytest.mark.parametrize('kernel', ['3', '4'])
def test_bf16_iteration_matches_pallas(kernel):
    """Kernels 3 and 4 (one iteration of one shard) on the bf16 layout,
    from the state 8 chunk iterations leave, against the next center at
    the finite md that chose it."""
    X = basin_data(np.random.default_rng(21), 2048, 10, n_basins=40)
    jprep = jengine.prepare_rmsd_frames(X, tile=128, precision='bf16')
    fr = np.asarray(jprep.frames_r, np.float32)
    g = np.array(jprep.g)
    d, asg, _, gidx, md, tm, _ = _jax_chunk(
        jprep, *_state_args(jprep, 'fresh')[:3], 0, np.inf, 0, 64, 0.0, 8)
    c, a_pad = int(gidx[0, 0]), fr.shape[0] // 3
    col = fr[:, c:c + 1].copy()
    gc, cid = np.full((1, 1), g[0, c], np.float32), np.full((1, 1), 8,
                                                            np.int32)
    frames_t = _port_prep(jprep).frames_r
    assert frames_t.dtype == torch.bfloat16
    dist_t, assig_t = torch.from_numpy(d.copy()), torch.from_numpy(asg.copy())
    if kernel == '3':
        cvec = col.reshape(3, a_pad).T.copy()
        ref = kcenters_iteration_pallas(
            jprep.frames_r, jprep.g, jnp.asarray(d), jnp.asarray(asg),
            jnp.asarray(cvec), jnp.asarray(gc), jnp.asarray(cid), 10,
            interpret=True, tile=128, with_argmax=True)
        port = kcenters_iteration(
            frames_t, torch.from_numpy(g), dist_t, assig_t,
            torch.from_numpy(cvec), torch.from_numpy(gc),
            torch.from_numpy(cid), 10, tile=128, with_argmax=True)
        pairs = ((0, 0), (1, 1), (2, 2), (3, 3))
    else:
        mdv = np.full((1, 1), md[0, 0], np.float32)
        ref = kcenters_iteration_skip_pallas(
            jprep.frames_r, jprep.g, jnp.asarray(d), jnp.asarray(asg),
            jnp.asarray(tm), jnp.asarray(col), jnp.asarray(gc),
            jnp.asarray(cid), jnp.asarray(mdv), 10, interpret=True,
            tile=128)
        port = kcenters_iteration_skip(
            frames_t, torch.from_numpy(g), dist_t, assig_t,
            torch.from_numpy(tm.copy()), torch.from_numpy(col),
            torch.from_numpy(gc), torch.from_numpy(cid),
            torch.from_numpy(mdv), 10, tile=128)
        pairs = ((0, 0), (1, 1), (2, 2), (3, 3), (4, 4), (5, 5))
        assert int(np.asarray(ref[5])[0, 0]) > 0, 'tiles must skip'
    for p, r in pairs:
        pv, rv = port[p].numpy(), np.asarray(ref[r])
        if pv.dtype == np.float32:
            assert_rmsd_close(pv, rv, _gsum(g), 10)
        else:
            np.testing.assert_array_equal(pv, rv)


def _assert_results_equal(port, ref, gsum, n_atoms):
    assert port.n_found == ref.n_found
    np.testing.assert_array_equal(port.center_indices, ref.center_indices)
    np.testing.assert_array_equal(port.assignments, ref.assignments)
    assert_rmsd_close(port.distances, ref.distances, gsum, n_atoms)


def _gsum_x(X):
    return 2 * float((X.astype(np.float64) ** 2).sum((1, 2)).max()) * 1.01


@pytest.mark.parametrize('tri_skip', [True, False])
def test_bf16_fused_matches_jax(tri_skip, monkeypatch):
    """kcenters_device_fused(precision='bf16') from coordinates: the bf16
    chunk kernel's plain version runs (it sees bfloat16 frames), and the
    results equal the JAX package's, tiles skipped or not."""
    X = grid_data(np.random.default_rng(7), 1000, 10, n_basins=16)
    ref = jengine.kcenters_device_fused(X, n_clusters=40, tile=128,
                                        interpret=True, precision='bf16')
    seen = []
    chunk = engine.kcenters_chunk

    def spy(prep, state, n_iters, skip=True):
        seen.append((prep.frames_r.dtype, skip))
        return chunk(prep, state, n_iters, skip=skip)
    monkeypatch.setattr(engine, 'kcenters_chunk', spy)
    port = engine.kcenters_device_fused(X, n_clusters=40, tile=128,
                                        precision='bf16', tri_skip=tri_skip)
    assert seen and set(seen) == {(torch.bfloat16, tri_skip)}
    _assert_results_equal(port, ref, _gsum_x(X), 10)
    r32 = engine.kcenters_device_fused(X, n_clusters=40, tile=128)
    assert not np.array_equal(r32.distances, port.distances)


def test_bf16_warm_start_matches_jax():
    X = grid_data(np.random.default_rng(9), 1024, 10, n_basins=30)
    first = jengine.kcenters_device_fused(X, n_clusters=20, tile=128,
                                          interpret=True, precision='bf16')
    kw = dict(n_clusters=36, init_distances=first.distances,
              init_assignments=first.assignments, n_init_centers=20,
              init_center_indices=first.center_indices)
    jprep = jengine.prepare_rmsd_frames(X, tile=128, precision='bf16')
    ref = jengine.kcenters_device_fused(jprep, interpret=True, **kw)
    prep = engine.prepare_rmsd_frames(X, tile=128, precision='bf16')
    port = engine.kcenters_device_fused(prep, **kw)
    _assert_results_equal(port, ref, _gsum_x(X), 10)
    np.testing.assert_array_equal(port.center_indices[:20],
                                  first.center_indices)


def test_bf16_mesh_matches_jax():
    """The sharded loop on bf16 shards (kernels 4 and 3, plain) over a
    CPU mesh of 4 shards against the JAX package's on 4 devices."""
    X = grid_data(np.random.default_rng(13), 2000, 10, n_basins=24)
    jmesh = Mesh(np.array(jax.devices()[:4]), (FRAME_AXIS,))
    ref = jengine.kcenters_device_fused(X, n_clusters=32, tile=128,
                                        interpret=True, mesh=jmesh,
                                        precision='bf16')
    mesh = FrameMesh(['cpu'] * 4)
    prep = engine.prepare_rmsd_frames(X, tile=128, mesh=mesh,
                                      precision='bf16')
    assert {s.frames_r.dtype for s in prep.shards} == {torch.bfloat16}
    for tri_skip in (True, False):
        port = engine.kcenters_device_fused(prep, n_clusters=32, mesh=mesh,
                                            tri_skip=tri_skip)
        _assert_results_equal(port, ref, _gsum_x(X), 10)


def test_prepared_bf16_frames_inherit_precision():
    """precision=None inherits the prepared frames' precision; only an
    explicit mismatch raises (the JAX test of the same name). The other
    errors are the JAX package's: an unknown precision or sort, sort on
    unsorted frames, bf16 or sort with a feature metric; assignment
    refuses bf16 frames."""
    rng = np.random.default_rng(51)
    templates = rng.normal(size=(4, 8, 3)).astype(np.float32) * 5.0
    X = (templates[np.arange(256) % 4]
         + 0.01 * rng.normal(size=(256, 8, 3)).astype(np.float32))
    prep16 = engine.prepare_rmsd_frames(X, tile=128, precision='bf16')
    res = engine.kcenters_device_fused(prep16, n_clusters=4)
    assert res.n_found == 4
    res2 = engine.kcenters_device_fused(prep16, n_clusters=4,
                                        precision='bf16')
    np.testing.assert_array_equal(res.assignments, res2.assignments)
    with pytest.raises(ValueError, match='prepared frames are bf16'):
        engine.kcenters_device_fused(prep16, n_clusters=4,
                                     precision='fp32')
    with pytest.raises(ValueError, match='unsorted'):
        engine.kcenters_device_fused(prep16, n_clusters=4, sort='locality')
    for kw in (dict(precision='fp16'), dict(sort='random')):
        with pytest.raises(ValueError, match='must be'):
            engine.prepare_rmsd_frames(X, **kw)
    F = X.reshape(256, -1)
    with pytest.raises(ValueError, match="precision='bf16' requires"):
        engine.kcenters_device(F, 'euclidean', n_clusters=4,
                               precision='bf16')
    with pytest.raises(ValueError, match="sort='locality' requires"):
        engine.kcenters_device(F, 'euclidean', n_clusters=4,
                               sort='locality')
    with pytest.raises(ValueError, match='float32 frames'):
        engine.assign_device(prep16, X[:2], 'rmsd')
    # kcenters_device passes both on for 'rmsd'
    dev = engine.kcenters_device(prep16, 'rmsd', n_clusters=4)
    np.testing.assert_array_equal(dev.assignments, res.assignments)


def test_bf16_distances_within_rounding_bound():
    """Each bf16 distance against the fp32 QCP RMSD of the same frame and
    the same center frame, unrounded: by RMSD's triangle inequality they
    differ by at most rms(x_bf16 - x) + rms(c_bf16 - c), plus the fp32
    bar of each side."""
    X = basin_data(np.random.default_rng(3), 2000, 10, n_basins=20)
    res = engine.kcenters_device_fused(X, n_clusters=30, precision='bf16')
    Xc = torch.from_numpy(X - X.mean(axis=1, keepdims=True))
    g = (Xc * Xc).sum(dim=(1, 2))
    ctr = res.center_indices[res.assignments]
    d32 = np.empty(len(X))
    for c in np.unique(ctr):
        m = ctr == c
        d32[m] = qcp_rmsd_vector(Xc[m], Xc[c], g[m], g[c]).numpy()
    err = (Xc.bfloat16().float() - Xc).square().sum((1, 2)).div(10)
    err = err.sqrt().numpy().astype(np.float64)
    floor = 16 * np.finfo(np.float32).eps * 2 * float(g.max()) / 10
    slack = 2 * np.sqrt(1e-5 * d32 ** 2 + floor)
    gap = np.abs(res.distances - d32)
    assert (gap <= err + err[ctr] + slack).all(), gap.max()
    assert gap.max() > 1e-4, 'the bf16 run must carry the rounding'


def test_kcenters_estimator_precision_and_sort():
    """KCenters(precision=, sort=) and kcenters(...): get_params, the fit
    equal to the functional form and, warm-started from init_centers,
    to the JAX package's kcenters (which runs bf16 on the CPU only with
    the sort); callable metrics refuse both."""
    X = grid_data(np.random.default_rng(17), 600, 10, n_basins=12)
    est = KCenters('rmsd', n_clusters=12, precision='bf16',
                   sort='locality')
    params = est.get_params()
    assert params['precision'] == 'bf16' and params['sort'] == 'locality'
    est.fit(X)
    fn = kcenters(X, 'rmsd', n_clusters=12, precision='bf16',
                  sort='locality')
    np.testing.assert_array_equal(est.labels_, fn.assignments)
    np.testing.assert_array_equal(est.center_indices_, fn.center_indices)
    init = [X[3], X[400]]
    ref = jax_kcenters(X, 'rmsd', n_clusters=12, init_centers=init,
                       precision='bf16', sort='locality')
    port = kcenters(X, 'rmsd', n_clusters=12, init_centers=init,
                    precision='bf16', sort='locality')
    np.testing.assert_array_equal(port.center_indices, ref.center_indices)
    np.testing.assert_array_equal(port.assignments, ref.assignments)
    assert_rmsd_close(port.distances, ref.distances, _gsum_x(X), 10)

    def metric(a, b):
        return np.zeros(len(a))
    for kw in (dict(precision='bf16'), dict(sort='locality')):
        with pytest.raises(ImproperlyConfigured, match='built-in metric'):
            kcenters(X, metric, n_clusters=2, **kw)
