"""The port's PAM sweeps over a frame mesh held against the JAX package.

``engine_kmedoids._pam_sweeps`` over 2-, 4- and 8-shard CPU meshes (a
ragged last shard, and at 8 shards one that holds no frame) against the
JAX ``_pam_sweeps`` on the same data sharded over 4 of the suite's 8
virtual devices, fed the same ``jax.random.bits`` per sweep, for 'rmsd'
and the three feature metrics; the cache invariant over a mesh after
high-churn sweeps; the sharded distance blocks and collectives against
one device; and the seed's proposals independent of the mesh.

Bars: medoids and assignments exactly equal; RMSD distances on
``assert_rmsd_close``'s msd bar, feature distances within 1e-5
relative (hamming exactly).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enspara_tpu.cluster import engine as jengine
from enspara_tpu.cluster import engine_kmedoids as jek
from enspara_tpu.cluster import kcenters as jax_kcenters
from enspara_tpu.parallel import mesh as jmesh

from enspara_tpu_torch.cluster import engine, engine_kmedoids
from enspara_tpu_torch.ops import qcp_matrix
from enspara_tpu_torch.parallel import FrameMesh, ops

from test_torch_port import assert_rmsd_close, basin_data

N, K, SWEEPS, BATCH = 603, 20, 2, 8
METRICS = ['rmsd', 'euclidean', 'manhattan', 'hamming']


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


def _cpu_mesh(n):
    return FrameMesh(['cpu'] * n)


def data(metric, n=N, seed=0):
    """Seeded tie-free inputs: basin frames of 8 atoms for 'rmsd', blob
    features of 8 dimensions, or 3-state labels of 24 positions around
    blob templates for hamming."""
    rng = np.random.RandomState(seed)
    if metric == 'rmsd':
        return basin_data(np.random.default_rng(seed), n, 8, n_basins=40)
    if metric == 'hamming':
        tmpl = rng.randint(0, 3, size=(40, 24))
        X = tmpl[rng.randint(0, 40, n)]
        flip = rng.random_sample(X.shape) < 0.2
        return np.where(flip, rng.randint(0, 3, size=X.shape),
                        X).astype(np.int32)
    X = (rng.normal(size=(40, 8)) * 4.0)[rng.randint(0, 40, n)]
    return (X + rng.normal(size=(n, 8))).astype(np.float32)


def prepared(X, metric, mesh):
    """The port's container: RMSD frames at tile 32, so every mesh here
    leaves a ragged last shard."""
    if metric == 'rmsd':
        return engine.prepare_rmsd_frames(X, tile=32, mesh=mesh)
    return engine.prepare_sharded(X, metric, mesh=mesh)


def _gsum(X):
    Xc = X - X.mean(axis=1, keepdims=True)
    return 2 * float((Xc ** 2).sum((1, 2)).max())


def assert_distances(pd, jd, X, metric):
    if metric == 'rmsd':
        assert_rmsd_close(pd, jd, _gsum(X), X.shape[1])
    elif metric == 'hamming':
        np.testing.assert_array_equal(pd, jd)
    else:
        np.testing.assert_allclose(pd, jd, rtol=1e-5, atol=1e-6)


def _jax_bits(key, s, n):
    return np.asarray(jax.random.bits(jax.random.fold_in(key, s), (n,),
                                      jnp.uint32)).astype(np.int64)


@functools.lru_cache(maxsize=None)
def jax_run(metric):
    """The JAX sweeps over frame_mesh(4) from the JAX k-centers seed:
    ``(X, seed (d1, a1, medoids), bits per sweep, bucket, (d, a, m))``."""
    X = data(metric)
    seed = jax_kcenters(X, metric, n_clusters=K)
    d1 = seed.distances.astype(np.float32)
    a1 = seed.assignments.astype(np.int32)
    minds = np.asarray(seed.center_indices, np.int32)
    jm = jmesh.frame_mesh(4)
    data_sh, n = jengine.prepare_sharded(X, metric, jm)
    n_pad = data_sh.shape[0]
    valid = np.arange(n_pad) < n
    pad = n_pad - n
    d1_sh = jmesh.shard_frames(np.concatenate(
        [d1, np.full(pad, np.inf, np.float32)]), jm)[0]
    a1_sh = jmesh.shard_frames(np.concatenate(
        [a1, np.full(pad, -1, np.int32)]), jm)[0]
    key = jax.random.PRNGKey(11)
    bucket = int(min(n, max(64, 8 * ((n + K - 1) // K))))
    jd, ja, jmed = jek._pam_sweeps(
        data_sh, jmesh.shard_frames(valid, jm)[0], d1_sh, a1_sh,
        jnp.asarray(minds), key, metric, SWEEPS, bucket, batch=BATCH)
    bits = [_jax_bits(key, s, n_pad) for s in range(SWEEPS)]
    out = (np.asarray(jd)[:n], np.asarray(ja)[:n], np.asarray(jmed))
    return X, (d1, a1, minds), bits, bucket, out


def local(a, prep, fill):
    """This process's per-shard pieces of the global (n,) array ``a``."""
    n_pad = prep.n_local * prep.n_shards
    full = np.concatenate([a, np.full(n_pad - len(a), fill, a.dtype)])
    return [torch.from_numpy(full[s * prep.n_local:(s + 1) * prep.n_local]
                             .copy()) for s in range(prep.n_shards)]


@pytest.mark.parametrize('n_shards', [2, 4, 8])
@pytest.mark.parametrize('metric', METRICS)
def test_sharded_pam_sweeps_match_jax(metric, n_shards):
    """The sharded sweep, fed JAX's bits, accepts the swaps of the JAX
    sweep over frame_mesh(4): the same medoids and assignments."""
    X, (d1, a1, minds), bits, bucket, (jd, ja, jm) = jax_run(metric)
    mesh = _cpu_mesh(n_shards)
    prep = prepared(X, metric, mesh)
    assert prep.n_shards == n_shards
    n_real = [min(max(N - s * prep.n_local, 0), prep.n_local)
              for s in range(n_shards)]
    assert 0 < n_real[-1] < prep.n_local or n_real[-1] == 0, n_real
    syncs = engine_kmedoids._pam_sweeps.n_host_syncs
    q0 = qcp_matrix.qcp_rmsd_matrix_kernel.n_launches
    pd, pa, pm = engine_kmedoids._pam_sweeps(
        prep, local(d1, prep, np.float32(np.inf)),
        local(a1, prep, np.int32(-1)), minds.astype(np.int64),
        [torch.from_numpy(b) for b in bits], bucket, batch=BATCH, mesh=mesh)
    assert isinstance(pd, list) and len(pd) == n_shards
    assert qcp_matrix.qcp_rmsd_matrix_kernel.n_launches == q0
    assert engine_kmedoids._pam_sweeps.n_host_syncs > syncs
    pd, pa = torch.cat(pd).numpy(), torch.cat(pa).numpy()
    np.testing.assert_array_equal(pm.numpy(), jm)
    np.testing.assert_array_equal(pa[:N], ja)
    assert (pa[N:] == -1).all() and np.isinf(pd[N:]).all()
    assert_distances(pd[:N], jd, X, metric)
    assert not np.array_equal(jm, minds), 'no swap accepted'


def brute_force(X, metric, m):
    """float64 distances (n, k) of every frame to the medoid frames."""
    if metric == 'rmsd':
        Xc = X - X.mean(axis=1, keepdims=True)
        return qcp_matrix.pairwise_rmsd(Xc, Xc[m]).numpy().astype(np.float64)
    X64 = X.astype(np.float64)
    return np.sqrt(((X64[:, None] - X64[m][None]) ** 2).sum(-1))


@pytest.mark.parametrize('metric', ['rmsd', 'euclidean'])
def test_sharded_cache_consistency(metric):
    """After 8 high-churn sweeps over a 4-shard mesh the carried (d1, a1)
    equal a brute-force nearest-medoid recompute: the invariant a wrong
    owner mask on the self-distance zero or the repair would break."""
    rng = np.random.default_rng(21)
    X = rng.normal(size=(301, 6, 3) if metric == 'rmsd' else (301, 6)) \
        .astype(np.float32)       # no structure: many accepts and repairs
    mesh = _cpu_mesh(4)
    seed = engine.kcenters_device(X, metric, n_clusters=12, mesh=mesh)
    m, d, a = engine_kmedoids.kmedoids_sweeps_device(
        X, metric, seed.assignments, seed.distances, seed.center_indices,
        n_sweeps=8, seed=3, mesh=mesh)
    full = brute_force(X, metric, m)
    full[m, np.arange(len(m))] = 0.0       # PAM's self-distance clamp
    if metric == 'rmsd':
        assert_rmsd_close(d, full.min(axis=1), _gsum(X), 6)
        assert_rmsd_close(full[np.arange(len(X)), a], full.min(axis=1),
                          _gsum(X), 6)
    else:
        np.testing.assert_allclose(d, full.min(axis=1), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_array_equal(a, full.argmin(axis=1))
    assert np.mean(d ** 2) < np.mean(seed.distances ** 2)
    assert sorted(set(a.tolist())) == list(range(12))


def test_sharded_blocks_and_collectives():
    """Module 1's blocks: a shard's rows against columns by global index
    (their frames brought by one owner-masked sum) equal the one-device
    block's rows, RMSD and features, with and without ``rows=``; the
    row-block argmax and the vector gather equal numpy's."""
    mesh = _cpu_mesh(4)
    cols = torch.tensor([0, 602, 301, 5, 160, 599, 161])
    for metric in ('rmsd', 'manhattan'):
        X = data(metric)
        one = prepared(X, metric, None)
        whole = engine._pairwise_block(one, cols).numpy()
        prep = prepared(X, metric, mesh)
        rows = [torch.tensor([0, 3, 1]) for _ in range(4)]
        for r in (None, rows):
            blocks = engine._pairwise_block(prep, cols, r, mesh)
            assert len(blocks) == 4
            for s, blk in enumerate(blocks):
                lo = s * prep.n_local
                take = np.arange(lo, lo + prep.n_local) if r is None \
                    else lo + r[s].numpy()
                real = take < N
                np.testing.assert_array_equal(blk.numpy()[real],
                                              whole[take[real]])
        with pytest.raises(ValueError, match='mesh it was laid out for'):
            engine._pairwise_block(prep, cols, None, _cpu_mesh(2))

    rng = np.random.default_rng(2)
    P = rng.integers(0, 3, size=(20, 5)).astype(np.int64)   # ties planted
    P[:, 4] = 0                                             # all zero
    xs = [torch.from_numpy(P[s * 5:(s + 1) * 5]) for s in range(4)]
    best, idx = ops.global_argmax(xs, mesh)
    np.testing.assert_array_equal(best.numpy(), P.max(0))
    np.testing.assert_array_equal(idx.numpy(), P.argmax(0))
    gi = torch.tensor([19, 0, 7, 7, 12])
    got = ops.distribute_frames(xs, gi, mesh)
    assert len(got) == 4 and got[0].dtype == torch.int64
    for g in got:
        np.testing.assert_array_equal(g.numpy(), P[gi.numpy()])
    cols_t = [x.t().contiguous() for x in xs]
    got = ops.distribute_frames(cols_t, gi, mesh, dim=1)
    np.testing.assert_array_equal(got[3].numpy(), P[gi.numpy()].T)


def test_seed_gives_the_same_proposals_on_any_mesh(monkeypatch):
    """A seed draws exactly n values a sweep, so one device and meshes
    of 2 and 8 shards (other paddings) accept the same swaps."""
    drawn = []
    real = engine_kmedoids.sweep_bits

    def spy(seed, n_sweeps, n, device):
        for b in real(seed, n_sweeps, n, device):
            drawn.append(b.shape[0])
            yield b
    monkeypatch.setattr(engine_kmedoids, 'sweep_bits', spy)
    X = data('rmsd', n=450, seed=4)
    seed = engine.kcenters_device_fused(X, n_clusters=15, device='cpu')
    out = []
    for mesh in (None, _cpu_mesh(2), _cpu_mesh(8)):
        kw = dict(device='cpu') if mesh is None else dict(mesh=mesh)
        out.append(engine_kmedoids.kmedoids_sweeps_device(
            X, 'rmsd', seed.assignments, seed.distances,
            seed.center_indices, n_sweeps=2, seed=9, **kw))
    assert drawn == [450] * 6
    for m, d, a in out[1:]:
        np.testing.assert_array_equal(m, out[0][0])
        np.testing.assert_array_equal(a, out[0][2])
        assert_rmsd_close(d, out[0][1], _gsum(X), 8)
    assert not np.array_equal(out[0][0], seed.center_indices)
