"""enspara_tpu_torch tests that need no JAX: the import boundary, the
kernel build and its input guards, and (marked ``cuda``, skipped
without a card) the CUDA kernels against their plain versions and the
card's clustering paths against the same on the CPU.

This file imports no jax, so on a machine without it the card tests run
with ``python -m pytest --noconftest -m cuda tests/test_torch_port.py``.
It also holds the helpers the JAX parity tests share.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from enspara_tpu_torch.cluster import engine
from enspara_tpu_torch.convert import result_to_numpy
from enspara_tpu_torch.msm import (assigns_to_counts_device,
                                   transpose_timescales_device)
from enspara_tpu_torch.cluster import engine_kmedoids, hybrid_device
from enspara_tpu_torch.ops import _build, kcenters_step, qcp_matrix

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


def basin_data(rng, n, a, n_basins, noise=0.2, dwell=64):
    """Temporally ordered metastable-basin frames (the generator of
    tests/test_kcenters_skip.py), where tiles become skippable. The
    noise keeps RMSDs within a basin far above the fp32 floor, so
    farthest-point picks are tie-free in fp32."""
    templates = rng.normal(size=(n_basins, a, 3)).astype(np.float32)
    seg = np.cumsum(rng.random(n) < 1.0 / dwell)
    basin = rng.integers(0, n_basins, size=seg.max() + 1)[seg]
    return (templates[basin]
            + noise * rng.normal(size=(n, a, 3)).astype(np.float32))


def assert_rmsd_close(actual, desired, gsum_max, n_atoms):
    """RMSD arrays agree: the same +-inf entries, and elsewhere
    ``|a^2 - d^2| <= 1e-5 d^2 + 16 eps32 gsum_max / n_atoms``.

    fp32 QCP recovers the msd as ``gsum - 2*lambda_max``, so another
    summation order moves it by a few ulp of ``gsum / n_atoms`` whatever
    its size: near zero the bar is on the msd, not on the RMSD."""
    actual = np.asarray(actual, np.float64)
    desired = np.asarray(desired, np.float64)
    assert actual.shape == desired.shape
    inf = ~np.isfinite(desired)
    np.testing.assert_array_equal(actual[inf], desired[inf])
    a, d = actual[~inf], desired[~inf]
    floor = 16 * np.finfo(np.float32).eps * gsum_max / n_atoms
    err = np.abs(a * a - d * d)
    bad = err > 1e-5 * d * d + floor
    assert not bad.any(), 'msd differs by %g at %d entries (floor %g)' % (
        err.max(), bad.sum(), floor)


# Newton steps that bring the JAX package's QCP (12 from u = 1) to the
# root for structures that barely align, where the port's epilogue
# starts from an upper bound near the root (enspara_tpu_torch/ops/qcp.py)
JAX_CONVERGED_NEWTON = 24


@pytest.fixture
def jax_newton_converged(monkeypatch):
    """The JAX package's QCP with its Newton run to convergence, for
    holding the port to it on structures that barely align. The JAX
    module reads ``NEWTON_ITERS`` when it traces, so JAX's caches are
    cleared on both sides of the test."""
    import jax
    from enspara_tpu.ops import qcp as jqcp
    monkeypatch.setattr(jqcp, 'NEWTON_ITERS', JAX_CONVERGED_NEWTON)
    jax.clear_caches()
    yield
    jax.clear_caches()


def assert_gram_close(actual, desired, X, C):
    """Euclidean distances of the Gram form agree: for frame x,
    ``|a^2 - d^2| <= 1e-5 d^2 + 16 eps32 (|x|^2 + max |c|^2)``.

    fp32 ``|x|^2 + |c|^2 - 2 x.c`` cancels, so another summation order
    moves d^2 by a few ulp of ``|x|^2 + |c|^2`` whatever its size (a
    center frame's own distance is about ``sqrt(eps |x|^2)``, not 0)."""
    actual = np.asarray(actual, np.float64)
    desired = np.asarray(desired, np.float64)
    assert actual.shape == desired.shape
    X = np.asarray(X, np.float64).reshape(len(X), -1)
    C = np.asarray(C, np.float64).reshape(len(C), -1)
    scale = (X * X).sum(1) + (C * C).sum(1).max()
    if actual.ndim == 2:
        scale = scale[:, None]
    err = np.abs(actual ** 2 - desired ** 2)
    bad = err > 1e-5 * desired ** 2 + 16 * np.finfo(np.float32).eps * scale
    assert not bad.any(), 'd^2 differs by %g at %d entries' % (
        err.max(), bad.sum())


def fresh_arrays(n, n_pad):
    """A fresh run's (1, n_pad) dist (-inf past n) and assig."""
    dist = np.full((1, n_pad), np.inf, np.float32)
    dist[0, n:] = -np.inf
    return dist, np.full((1, n_pad), -1, np.int32)


def _state(prep, n_total, cutoff=0.0):
    dist, assig = fresh_arrays(prep.n, prep.frames_r.shape[1])
    dev = prep.frames_r.device
    return kcenters_step.start_state(
        torch.from_numpy(dist).to(dev), torch.from_numpy(assig).to(dev),
        prep.frames_r.shape[0], prep.tile, 0, n_total, cutoff)


def test_main_path_imports_no_jax():
    """Importing every module of the port, and what chip_smoke.py and
    chip_ablate_qcp.py import, brings in neither the JAX package nor jax, sklearn or
    psutil. A subprocess, because the test session itself has imported
    them."""
    code = (
        'import importlib, pkgutil, sys\n'
        'import enspara_tpu_torch\n'
        'for m in pkgutil.walk_packages(enspara_tpu_torch.__path__,\n'
        '                               "enspara_tpu_torch."):\n'
        '    importlib.import_module(m.name)\n'
        'import chip_smoke, chip_ablate_qcp\n'
        'bad = [m for m in sys.modules if m == "enspara_tpu"\n'
        '       or m.startswith("enspara_tpu.")\n'
        '       or m.split(".")[0] in ("jax", "sklearn", "psutil")]\n'
        'assert not bad, bad\n'
        'for name in ("msm.eigen_device", "parallel.mesh", "parallel.ops",\n'
        '             "parallel.io", "ops.qcp_update", "msm.msm",\n'
        '             "msm.timescales", "msm.bootstrap", "msm.bace",\n'
        '             "tpt.core", "tpt.tpt", "tpt.path",\n'
        '             "apps.implied_timescales", "ops.distances",\n'
        '             "geometry.libdist", "util.checkpoint",\n'
        '             "cluster.save_states", "apps.main",\n'
        '             "info_theory.libinfo", "info_theory.mutual_info",\n'
        '             "geometry.rotamer", "cards.cards",\n'
        '             "apps.collect_cards", "apps.shannon_entropy",\n'
        '             "geometry.sasa", "geometry.rmsf", "geometry.helix",\n'
        '             "geometry.pockets", "geometry.dyes_from_expt_dist",\n'
        '             "info_theory.exposons", "info_theory._affinity",\n'
        '             "util.array", "data", "apps.smFRET_point_clouds"):\n'
        '    assert "enspara_tpu_torch." + name in sys.modules, name\n')
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, '-c', code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def _small_prep_state(tile=64):
    X = basin_data(np.random.default_rng(1), 256, 8, n_basins=4)
    prep = engine.prepare_rmsd_frames(X, tile=tile)
    return prep, _state(prep, 8)


@pytest.mark.parametrize('bad', ['float64', 'rows', 'tile', 'strided_g',
                                 'tmax_shape', 'n_iters', 'meta'])
def test_chunk_rejects_what_the_kernel_does_not_take(bad):
    prep, state = _small_prep_state()
    if bad == 'float64':
        prep = prep._replace(frames_r=prep.frames_r.double())
    elif bad == 'rows':
        prep = prep._replace(frames_r=prep.frames_r[:21])
    elif bad == 'tile':
        prep = prep._replace(tile=48)
    elif bad == 'strided_g':
        prep = prep._replace(g=torch.ones(256, 2)[:, :1].t())
    elif bad == 'tmax_shape':
        state = state._replace(tmax=state.tmax[:, :64].contiguous())
    elif bad == 'meta':
        # neither CPU nor CUDA: refused, not run some other way
        prep = prep._replace(frames_r=prep.frames_r.to('meta'),
                             g=prep.g.to('meta'))
        state = kcenters_step.KCentersState(*(t.to('meta') for t in state))
    with pytest.raises(ValueError):
        kcenters_step.kcenters_chunk(prep, state,
                                     0 if bad == 'n_iters' else 4)


def test_cpu_path_launches_no_kernel():
    prep, state = _small_prep_state()
    before = kcenters_step.kcenters_chunk.n_launches
    ctr, skipcnt = kcenters_step.kcenters_chunk(prep, state, 4)
    assert (ctr.numpy() >= 0).all() and (skipcnt.numpy() >= 0).all()
    assert kcenters_step.kcenters_chunk.n_launches == before


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    """No nvcc: the builder raises a clear error and builds nothing
    (there is no fallback)."""
    monkeypatch.setenv('PATH', str(tmp_path))
    monkeypatch.setenv('CUDA_HOME', str(tmp_path))
    monkeypatch.setattr(_build, 'BUILD_DIR', str(tmp_path / 'build'))
    _build.load_library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match='nvcc not found'):
            _build.load_library('kcenters_step')
    finally:
        _build.load_library.cache_clear()
    assert not (tmp_path / 'build').exists()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (torch.cuda.is_available() is '
                    'False)')
    return torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('n,tile,cutoff', [
    (8192, 256, 0.0),
    (8000, 128, 0.0),        # -inf padded tail
    (8192, 1024, 0.0),
    (8192, 256, 0.9),        # stops on the cutoff inside the chunk
], ids=['t256', 'padded_t128', 't1024', 'cutoff'])
def test_cuda_kernel_matches_plain(cuda, n, tile, cutoff):
    """The CUDA kernel against the plain version on the card, and the
    kernel with skip on and off bit for bit."""
    X = basin_data(np.random.default_rng(3), n, 16, n_basins=24)
    prep = engine.prepare_rmsd_frames(X, tile=tile, device=cuda)

    def run(fn, **kw):
        state = _state(prep, 96, cutoff)
        ctr, skipcnt = fn(prep, state, 96, **kw)
        return result_to_numpy(state, ctr, skipcnt)

    before = kcenters_step.kcenters_chunk.n_launches
    on = run(kcenters_step.kcenters_chunk)
    off = run(kcenters_step.kcenters_chunk, skip=False)
    torch.cuda.synchronize()
    assert kcenters_step.kcenters_chunk.n_launches == before + 2 * 97
    plain = run(kcenters_step.kcenters_chunk_plain)
    for x, y in zip(on, off):
        np.testing.assert_array_equal(x, y)
    if tile <= 256:
        assert on[6][on[6] > 0].sum() > 0, 'basin data must skip tiles'
    for k in (1, 2, 3, 6):
        np.testing.assert_array_equal(on[k], plain[k])
    g = 2 * float(prep.g.max())
    for k in (0, 4, 5):
        assert_rmsd_close(on[k], plain[k], g, 16)
    placed = int((on[2] >= 0).sum())
    assert placed == 96 if cutoff == 0.0 else 0 < placed < 96


@pytest.mark.cuda
def test_cuda_pipeline_matches_cpu(cuda):
    """The whole small pipeline on the card against the same on the
    CPU (the plain versions)."""
    X = basin_data(np.random.default_rng(4), 6000, 16, n_basins=30)
    out = {}
    for dev in ('cpu', cuda):
        res = engine.kcenters_device_fused(X, n_clusters=80, device=dev)
        a = res.assignments.reshape(3, -1)
        counts = assigns_to_counts_device(a, np.ones_like(a, bool), 5, 80,
                                          device=dev)
        out[str(dev)] = (res, counts.cpu().numpy(),
                         transpose_timescales_device(counts, 8))
    (rc, cc, (_, wc, vc)), (rg, cg, (_, wg, vg)) = out.values()
    np.testing.assert_array_equal(rg.center_indices, rc.center_indices)
    np.testing.assert_array_equal(rg.assignments, rc.assignments)
    np.testing.assert_array_equal(cg, cc)
    np.testing.assert_allclose(wg, wc, atol=1e-4)
    np.testing.assert_allclose(vg[:, 0], vc[:, 0], atol=1e-5)


def _centered(rng, n, a):
    X = rng.normal(size=(n, a, 3)).astype(np.float32)
    return X - X.mean(axis=1, keepdims=True)


@pytest.mark.cuda
def test_cuda_qcp_matrix_matches_plain(cuda):
    """The all-pairs kernel against its plain version on the card, at a
    padding shape, a proposal block, a multi-block assignment and a
    single center: every entry within the msd bar, block argmins equal,
    one launch each."""
    for F, C, A in ((1000, 37, 61), (4096, 64, 64), (8192, 300, 16),
                    (256, 1, 3)):
        rng = np.random.default_rng(F + C)
        X = _centered(rng, F, A)
        Y = X[rng.integers(0, F, C)] + 0.01 * _centered(rng, C, A)
        Y -= Y.mean(axis=1, keepdims=True)
        a_pad = -(-A // 8) * 8
        fr, gf = qcp_matrix.to_layout(torch.from_numpy(X).to(cuda),
                                      qcp_matrix.pad_frames(F), a_pad)
        cr, gc = qcp_matrix.to_layout(torch.from_numpy(Y).to(cuda),
                                      qcp_matrix.pad_centers(C), a_pad)
        before = qcp_matrix.qcp_rmsd_matrix_kernel.n_launches
        k = qcp_matrix.qcp_rmsd_matrix_block(fr, gf, cr, gc, A)
        torch.cuda.synchronize()
        assert qcp_matrix.qcp_rmsd_matrix_kernel.n_launches == before + 1
        p = qcp_matrix.qcp_rmsd_matrix_plain(fr, gf, cr, gc, A)
        k, p = k.cpu().numpy(), p.cpu().numpy()
        assert np.isfinite(k).all()
        assert_rmsd_close(k, p, 2 * float(max(gf.max(), gc.max())), A)
        np.testing.assert_array_equal(k[:F, :C].argmin(1),
                                      p[:F, :C].argmin(1))


@pytest.mark.cuda
def test_cuda_cluster_path_matches_cpu(cuda, monkeypatch):
    """assign_device and the PAM sweeps on the card against the same on
    the CPU, fed the same random bits (the kernel launches on the card
    only); hybrid_device runs both kernels; and on CUDA tensors the S
    components come only from the kernel: the plain block, einsum and
    matmul are never called there."""
    X = basin_data(np.random.default_rng(6), 5000, 16, n_basins=60)
    g = 2 * float(((X - X.mean(1, keepdims=True)) ** 2).sum((1, 2)).max())
    centers = X[::50]
    n0 = qcp_matrix.qcp_rmsd_matrix_kernel.n_launches
    a_c, d_c = engine.assign_device(X, centers, 'rmsd')
    assert qcp_matrix.qcp_rmsd_matrix_kernel.n_launches == n0
    a_g, d_g = engine.assign_device(X, centers, 'rmsd', device=cuda)
    assert qcp_matrix.qcp_rmsd_matrix_kernel.n_launches == n0 + 1
    np.testing.assert_array_equal(a_g, a_c)
    assert_rmsd_close(d_g, d_c, g, 16)

    res = engine.kcenters_device_fused(X, n_clusters=70)
    out = {}
    for dev in ('cpu', cuda):
        prep = engine.prepare_rmsd_frames(X, device=dev)
        n_pad = prep.frames_r.shape[1]
        gen = torch.Generator().manual_seed(1)
        bits = [torch.randint(0, 2 ** 32, (n_pad,), generator=gen,
                              dtype=torch.long) for _ in range(2)]
        d1 = torch.full((n_pad,), float('inf'))
        d1[:5000] = torch.from_numpy(res.distances.astype(np.float32))
        a1 = torch.full((n_pad,), -1, dtype=torch.int32)
        a1[:5000] = torch.from_numpy(res.assignments.astype(np.int32))
        n0 = qcp_matrix.qcp_rmsd_matrix_kernel.n_launches
        (d,), (a,), m = engine_kmedoids._pam_sweeps(
            prep, [d1.to(dev)], [a1.to(dev)], res.center_indices, bits, 640)
        out[str(dev)] = (d.cpu().numpy()[:5000], a.cpu().numpy()[:5000],
                         m.cpu().numpy(),
                         qcp_matrix.qcp_rmsd_matrix_kernel.n_launches - n0)
    (dc, ac, mc, lc), (dg, ag, mg, lg) = out.values()
    assert lc == 0 and lg > 0
    np.testing.assert_array_equal(mg, mc)
    np.testing.assert_array_equal(ag, ac)
    assert_rmsd_close(dg, dc, g, 16)
    assert not np.array_equal(mc, res.center_indices)

    def refuse(*a, **k):
        raise AssertionError('plain S computation on the CUDA path')
    for mod, name in ((qcp_matrix, 'qcp_rmsd_matrix_plain'),
                      (torch, 'einsum'), (torch, 'matmul')):
        monkeypatch.setattr(mod, name, refuse)
    q0 = qcp_matrix.qcp_rmsd_matrix_kernel.n_launches
    k0 = kcenters_step.kcenters_chunk.n_launches
    hy = hybrid_device(X, n_clusters=70, n_iters=2, device=cuda)
    engine_kmedoids.kmedoids_sweeps_device(
        X, 'rmsd', res.assignments, res.distances, res.center_indices,
        n_sweeps=1, device=cuda)
    torch.cuda.synchronize()
    assert kcenters_step.kcenters_chunk.n_launches > k0
    assert qcp_matrix.qcp_rmsd_matrix_kernel.n_launches > q0 + 2
    assert (hy.distances ** 2).mean() <= (res.distances ** 2).mean()
    assert len(set(hy.center_indices)) == 70
