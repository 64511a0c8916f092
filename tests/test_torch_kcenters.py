"""enspara_tpu_torch k-centers held against the JAX package.

The same numpy inputs go through both: one chunk against
``kcenters_chunk_skip_pallas(..., interpret=True)``, the whole loop
against ``kcenters_device_fused(..., interpret=True)``, and the
functional ``kcenters`` against ``enspara_tpu.cluster.kcenters`` (the
XLA loop on the CPU mesh). ``prepared_from_numpy`` carries the JAX
layout across, so both packages cluster identical frames.

Bars: center indices, assignments, skip counts and the next center are
exactly equal (tie-free data). Distances are compared on the mean
square deviation: fp32 QCP recovers it as ``gsum - 2*lambda_max``, so a
different summation order (and the TPU kernel's approximate
reciprocal) moves it by a few ulp of ``gsum / n_atoms`` whatever its
size; the bar is rtol 1e-5 on msd plus 16 such ulp.

The tests that need no JAX, the CUDA kernel's among them, are in
test_torch_port.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enspara_tpu.cluster import engine as jengine
from enspara_tpu.cluster.kcenters import kcenters as jax_kcenters
from enspara_tpu.ops.kcenters_skip_pallas import (kcenters_chunk_skip_pallas,
                                                  skip_t_pad, tile_summaries)

from enspara_tpu_torch import convert
from enspara_tpu_torch.cluster import KCenters, engine, kcenters
from enspara_tpu_torch.ops import kcenters_step

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


def _gsum_max(prep):
    return 2 * float(np.max(np.asarray(prep.g)))


def _jax_chunk(jprep, dist, assig, tmax, gidx0, max0, i_offset, n_total,
               cutoff, n_iters):
    def s(v, dtype):
        return jnp.full((1, 1), v, dtype)
    out = kcenters_chunk_skip_pallas(
        jprep.frames_r, jprep.g, jnp.asarray(dist), jnp.asarray(assig),
        jnp.asarray(tmax), s(gidx0, jnp.int32), s(max0, jnp.float32),
        s(i_offset, jnp.int32), s(n_total, jnp.int32),
        s(cutoff, jnp.float32), n_iters, jprep.n_atoms, interpret=True,
        tile=jprep.tile)
    return [np.asarray(x) for x in out]


def _port_chunk(jprep, dist, assig, tmax, gidx0, max0, i_offset, n_total,
                cutoff, n_iters):
    prep = convert.prepared_from_numpy(jprep.frames_r, jprep.g, jprep.n,
                                       jprep.n_atoms, tile=jprep.tile)
    state = convert.state_from_numpy(dist, assig, tmax,
                                     prep.frames_r.shape[0], gidx0, max0,
                                     i_offset, n_total, cutoff)
    ctr, skipcnt = kcenters_step.kcenters_chunk(prep, state, n_iters)
    return convert.result_to_numpy(state, ctr, skipcnt)


def _assert_chunks_equal(port, ref, jprep):
    """Compare the 7 outputs of the chunk: dist, assig, ctr, next gidx,
    next max, tmax, skipcnt."""
    g, a = _gsum_max(jprep), jprep.n_atoms
    assert_rmsd_close(port[0], ref[0], g, a)
    for k in (1, 2, 3, 6):
        np.testing.assert_array_equal(port[k], ref[k])
    assert_rmsd_close(port[4], ref[4], g, a)
    assert_rmsd_close(port[5], ref[5], g, a)


@pytest.mark.parametrize('case', ['fresh', 'budget_stop', 'cutoff_stop'])
def test_chunk_matches_pallas(case):
    rng = np.random.default_rng(3)
    n, a, tile = 1000, 10, 128          # n_pad 1024: one padded tile
    X = basin_data(rng, n, a, n_basins=12)
    jprep = jengine.prepare_rmsd_frames(X, tile=tile)
    n_pad = jprep.frames_r.shape[1]
    dist, assig = fresh_arrays(n, n_pad)
    tmax = np.asarray(tile_summaries(jnp.asarray(dist), tile,
                                     skip_t_pad(n_pad // tile)))
    n_total, cutoff = {'fresh': (100, 0.0), 'budget_stop': (9, 0.0),
                       'cutoff_stop': (100, 1.0)}[case]
    args = (dist, assig, tmax, 0, np.inf, 0, n_total, cutoff, 24)
    ref = _jax_chunk(jprep, *args)
    port = _port_chunk(jprep, *args)
    _assert_chunks_equal(port, ref, jprep)
    placed = int((port[2] != -1).sum())
    assert placed == {'fresh': 24, 'budget_stop': 9}.get(case, placed)
    if case == 'cutoff_stop':
        assert 0 < placed < 24


def test_chunk_carry_matches_pallas():
    """A second chunk from the first one's outputs (finite md): tiles
    are skipped by the rule, and the carry matches chunk for chunk."""
    rng = np.random.default_rng(5)
    n, a, tile = 1024, 8, 128
    X = basin_data(rng, n, a, n_basins=40)
    jprep = jengine.prepare_rmsd_frames(X, tile=tile)
    dist, assig = fresh_arrays(n, n)
    tmax = np.asarray(tile_summaries(jnp.asarray(dist), tile,
                                     skip_t_pad(n // tile)))
    first = _jax_chunk(jprep, dist, assig, tmax, 0, np.inf, 0, 64, 0.0, 8)
    d, asg, _, gidx, md, tm, _ = first
    args = (d, asg, tm, gidx[0, 0], md[0, 0], 8, 64, 0.0, 16)
    ref = _jax_chunk(jprep, *args)
    port = _port_chunk(jprep, *args)
    _assert_chunks_equal(port, ref, jprep)
    assert ref[6].sum() > 0, 'basin data must give skippable tiles'


def _jax_fused(jprep, **kw):
    return jengine.kcenters_device_fused(jprep, interpret=True, **kw)


def _port_fused(jprep, **kw):
    prep = convert.prepared_from_numpy(jprep.frames_r, jprep.g, jprep.n,
                                       jprep.n_atoms, tile=jprep.tile)
    return engine.kcenters_device_fused(prep, **kw)


def _assert_results_equal(port, ref, jprep):
    assert port.n_found == ref.n_found
    np.testing.assert_array_equal(port.center_indices, ref.center_indices)
    np.testing.assert_array_equal(port.assignments, ref.assignments)
    assert_rmsd_close(port.distances, ref.distances, _gsum_max(jprep),
                      jprep.n_atoms)


@pytest.mark.parametrize('n,kw', [
    (1024, dict(n_clusters=48)),
    (900, dict(n_clusters=48)),                     # -inf padded tail
    (1024, dict(n_clusters=64, dist_cutoff=0.5)),   # stops on cutoff
], ids=['budget', 'padded', 'cutoff'])
def test_loop_matches_jax(n, kw):
    rng = np.random.default_rng(7)
    X = basin_data(rng, n, 8, n_basins=16)
    jprep = jengine.prepare_rmsd_frames(X, tile=128)
    ref = _jax_fused(jprep, **kw)
    port = _port_fused(jprep, **kw)
    _assert_results_equal(port, ref, jprep)
    if 'dist_cutoff' in kw:
        assert port.n_found < kw['n_clusters']


def test_warm_start_matches_jax():
    rng = np.random.default_rng(9)
    n = 1024
    X = basin_data(rng, n, 8, n_basins=30)
    jprep = jengine.prepare_rmsd_frames(X, tile=128)
    first = _jax_fused(jprep, n_clusters=20)
    kw = dict(n_clusters=36, init_distances=first.distances,
              init_assignments=first.assignments, n_init_centers=20,
              init_center_indices=first.center_indices)
    ref = _jax_fused(jprep, **kw)
    port = _port_fused(jprep, **kw)
    _assert_results_equal(port, ref, jprep)
    np.testing.assert_array_equal(port.center_indices[:20],
                                  first.center_indices)


def test_prepare_layout_matches_jax():
    rng = np.random.default_rng(11)
    n, a = 300, 13                           # A_pad 16, n_pad 384
    X = rng.normal(size=(n, a, 3)).astype(np.float32) + 2.0
    jprep = jengine.prepare_rmsd_frames(X, tile=128)
    prep = engine.prepare_rmsd_frames(X, tile=128)
    assert (prep.n, prep.n_atoms, prep.tile) == (n, a, 128)
    assert tuple(prep.frames_r.shape) == tuple(jprep.frames_r.shape) \
        == (48, 384)
    np.testing.assert_allclose(prep.frames_r.numpy(),
                               np.asarray(jprep.frames_r),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(prep.g.numpy(), np.asarray(jprep.g),
                               rtol=1e-5, atol=1e-6)
    assert (prep.g.numpy()[0, n:] == 1.0).all()
    assert (prep.frames_r.numpy()[:, n:] == 0).all()


def test_prepared_from_numpy_repads_frame_axis():
    """A JAX layout at tile 128 re-padded to the port's tile 256
    clusters exactly like the port's own ingest at tile 256."""
    rng = np.random.default_rng(13)
    n = 700
    X = basin_data(rng, n, 8, n_basins=10)
    jprep = jengine.prepare_rmsd_frames(X, tile=128)
    prep = convert.prepared_from_numpy(jprep.frames_r, jprep.g, n, 8,
                                       tile=256)
    assert tuple(prep.frames_r.shape) == (24, 768)
    np.testing.assert_array_equal(prep.frames_r.numpy()[:, :n],
                                  np.asarray(jprep.frames_r)[:, :n])
    assert (prep.g.numpy()[0, n:] == 1.0).all()
    res = engine.kcenters_device_fused(prep, n_clusters=24)
    ref = _jax_fused(jprep, n_clusters=24)
    _assert_results_equal(res, ref, jprep)


def test_functional_kcenters_matches_jax():
    rng = np.random.default_rng(17)
    X = rng.normal(size=(600, 12, 3)).astype(np.float32)
    ref = jax_kcenters(X, 'rmsd', n_clusters=20)
    port = kcenters(X, 'rmsd', n_clusters=20)
    np.testing.assert_array_equal(port.center_indices, ref.center_indices)
    np.testing.assert_array_equal(port.assignments, ref.assignments)
    assert_rmsd_close(port.distances, ref.distances,
                      2 * float((X * X).sum((1, 2)).max()), 12)
    for c, i in zip(port.centers, port.center_indices):
        np.testing.assert_array_equal(c, X[i])

    est = KCenters('rmsd', n_clusters=20).fit(torch.from_numpy(X))
    np.testing.assert_array_equal(est.labels_, port.assignments)
    np.testing.assert_array_equal(est.center_indices_, port.center_indices)
    np.testing.assert_array_equal(est.distances_, port.distances)
    assert len(est.centers_) == 20
    parts = port.partition([300, 300])
    assert parts.assignments.shape == (2, 300)


def test_unported_options_raise():
    """The feature metrics take (n, d) feature vectors: coordinates
    raise (tests/test_torch_features.py holds the metrics against the JAX
    package); ``init_centers`` is ported (tests/test_torch_assign.py)."""
    X = np.zeros((10, 3, 3), np.float32)
    for metric in ('euclidean', 'manhattan', 'hamming'):
        with pytest.raises(ValueError, match='feature vectors'):
            kcenters(X, metric, n_clusters=2)
