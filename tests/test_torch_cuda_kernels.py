"""Kernels 5 and 6 of enspara_tpu_torch on the card against their plain
versions, and the one-device path of kernel 2. Imports no jax: on the
card machine, run with
``python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py``.

The ``cuda`` tests skip without a card:

- kernel 6 (``csrc/ell_spmm.cu``) equals ``ell_spmm_plain`` under
  ``torch.equal`` for finite X, over row widths, column counts, shifts,
  explicit zeros, all-pad rows and a misaligned X; one test pins its one
  deliberate difference (a NaN reached only through a zero slot);
- kernel 5 (``csrc/qcp_matrix.cu``, 3xTF32 on the tensor cores) is
  within the msd bar of ``qcp_rmsd_matrix_plain`` (rtol 1e-5 on the msd
  plus 16 ulp of gsum / n_atoms), with argmins equal but for near ties,
  at small and large shapes, on self pairs and on coordinates x 100;
- on one device ``kcenters_device_fused(..., tri_skip=False)`` runs
  kernel 2 (the chunk kernel's twin that skips nothing), bit for bit
  the result of the default (on the CPU too, where both are plain).
"""

import numpy as np
import pytest
import torch

from enspara_tpu_torch.cluster import engine
from enspara_tpu_torch.ops import ell_spmm as ell_mod
from enspara_tpu_torch.ops import qcp_matrix

from test_torch_port import assert_rmsd_close


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (torch.cuda.is_available() is '
                    'False)')
    return torch.device('cuda')


def _ell(rng, n, w, n_pad):
    """An (n_pad, w) ELL: rows below n with random columns, values and
    explicit zeros in the middle of the row; rows from n on all pad
    slots (their own index, value 0), as the solver's bucketed ELL."""
    cols = np.repeat(np.arange(n_pad, dtype=np.int32)[:, None], w, 1)
    vals = np.zeros((n_pad, w), np.float32)
    cols[:n] = rng.integers(0, n_pad, (n, w))
    vals[:n] = rng.normal(size=(n, w))
    vals[:n][rng.random((n, w)) < 0.3] = 0.0
    return cols, vals


def _launch(cols, vals, X, shift):
    before = ell_mod.ell_spmm_kernel.n_launches
    Y = ell_mod.ell_spmm_kernel(cols, vals, X, shift)
    torch.cuda.synchronize()
    assert ell_mod.ell_spmm_kernel.n_launches == before + 1
    return Y


@pytest.mark.cuda
@pytest.mark.parametrize('w', [0, 1, 33, 40])
def test_cuda_ell_equals_plain(cuda, w):
    """Every k of the list, shift 0 and 0.25: bit for bit, all-pad rows
    exactly zero without a shift."""
    rng = np.random.default_rng(w)
    n, n_pad = 900, 1024
    cols_h, vals_h = _ell(rng, n, w, n_pad)
    cols = torch.from_numpy(cols_h).to(cuda)
    vals = torch.from_numpy(vals_h).to(cuda)
    for k in (1, 21, 64, 128, 192):
        X = torch.from_numpy(rng.normal(size=(n_pad, k))
                             .astype(np.float32)).to(cuda)
        for shift in (0.0, 0.25):
            Y = _launch(cols, vals, X, shift)
            assert torch.equal(Y, ell_mod.ell_spmm_plain(cols, vals, X,
                                                         shift)), (k, shift)
            if not shift:
                assert not Y[n:].any()


@pytest.mark.cuda
def test_cuda_ell_misaligned_x(cuda):
    """X and the output views at an offset of one float: the lanes fall
    back to scalar loads and the product is still bit for bit."""
    rng = np.random.default_rng(3)
    cols_h, vals_h = _ell(rng, 500, 40, 512)
    cols = torch.from_numpy(cols_h).to(cuda)
    vals = torch.from_numpy(vals_h).to(cuda)
    for k in (64, 128):
        flat = torch.from_numpy(rng.normal(size=512 * k + 1)
                                .astype(np.float32)).to(cuda)
        X = flat[1:].view(512, k)
        assert X.data_ptr() % 16
        assert ell_mod._lane_layout(k, X)[0] == 1
        for shift in (0.0, 0.25):
            assert torch.equal(_launch(cols, vals, X, shift),
                               ell_mod.ell_spmm_plain(cols, vals, X, shift))


@pytest.mark.cuda
def test_cuda_ell_nan_through_a_zero_slot(cuda):
    """The deliberate difference: the kernel gathers only slots whose
    value is not 0, so a NaN in an X row that a row reaches only through
    a zero slot stays out of it, where the plain version (0 * NaN) makes
    it NaN. Through a nonzero slot both give NaN."""
    n, k = 8, 64
    cols = torch.arange(n, dtype=torch.int32).repeat(2, 1).t().contiguous()
    vals = torch.zeros((n, 2))
    cols[0] = torch.tensor([5, 7], dtype=torch.int32)  # 7 through a 0
    vals[0, 0] = 1.0
    cols[1, 0], vals[1, 0] = 7, 2.0                     # 7 through a 2
    cols, vals = cols.to(cuda), vals.to(cuda)
    X = torch.randn((n, k), device=cuda)
    X[7] = float('nan')
    Y = _launch(cols, vals, X, 0.0)
    P = ell_mod.ell_spmm_plain(cols, vals, X)
    assert torch.equal(Y[0], X[5]) and P[0].isnan().all()
    assert Y[1].isnan().all() and P[1].isnan().all()
    assert torch.equal(Y[2:7], P[2:7])
    assert not Y[7].any() and P[7].isnan().all()        # its own pad slots


def test_lane_layout():
    """float4 lanes at the solver's widths: a half-warp a row at
    k = 64, a warp at k = 128; narrower loads for odd k or a misaligned
    pointer."""
    X = torch.zeros(4 * 256 + 1)
    aligned = X[:256].view(4, 64)
    assert aligned.data_ptr() % 16 == 0
    assert ell_mod._lane_layout(64, aligned) == (4, 16)
    assert ell_mod._lane_layout(128, aligned) == (4, 32)
    assert ell_mod._lane_layout(192, aligned) == (4, 32)
    assert ell_mod._lane_layout(22, aligned) == (2, 16)
    assert ell_mod._lane_layout(21, aligned) == (1, 32)
    assert ell_mod._lane_layout(1, aligned) == (1, 16)
    assert ell_mod._lane_layout(64, X[1:257]) == (1, 32)
    assert ell_mod._lane_layout(64, X[2:258]) == (2, 32)


def _qcp_check(cuda, frames, centers, A, max_flips=None):
    """Kernel 5 against its plain version on the padded layout of
    ``frames`` (F, A, 3) and ``centers`` (C, A, 3), both centered: the
    msd bar everywhere, argmin flips only at near ties (or at most
    ``max_flips``). Returns the (F, C) kernel block as float64 numpy."""
    F, C = len(frames), len(centers)
    a_pad = -(-A // 8) * 8
    fr, gf = qcp_matrix.to_layout(torch.from_numpy(frames).to(cuda),
                                  qcp_matrix.pad_frames(F), a_pad)
    cr, gc = qcp_matrix.to_layout(torch.from_numpy(centers).to(cuda),
                                  qcp_matrix.pad_centers(C), a_pad)
    before = qcp_matrix.qcp_rmsd_matrix_kernel.n_launches
    k = qcp_matrix.qcp_rmsd_matrix_block(fr, gf, cr, gc, A)
    torch.cuda.synchronize()
    assert qcp_matrix.qcp_rmsd_matrix_kernel.n_launches == before + 1
    p = qcp_matrix.qcp_rmsd_matrix_plain(fr, gf, cr, gc, A)
    k = k[:F, :C].cpu().numpy().astype(np.float64)
    p = p[:F, :C].cpu().numpy().astype(np.float64)
    assert np.isfinite(k).all()
    gsum = 2 * float(max(gf.max(), gc.max()))
    assert_rmsd_close(k, p, gsum, A)
    ak, ap = k.argmin(1), p.argmin(1)
    flips = np.flatnonzero(ak != ap)
    if max_flips is not None:
        assert len(flips) <= max_flips
    dk, dp = p[flips, ak[flips]], p[flips, ap[flips]]
    assert_rmsd_close(dk, dp, gsum, A)
    return k


def _centered(rng, n, a, scale=1.0):
    X = (scale * rng.normal(size=(n, a, 3))).astype(np.float32)
    return X - X.mean(axis=1, keepdims=True)


@pytest.mark.cuda
@pytest.mark.parametrize('F,C,A', [(64, 64, 8), (320, 64, 61),
                                   (4096, 256, 64)])
def test_cuda_qcp_within_msd_bar(cuda, F, C, A):
    """Random frames and centers near some of them."""
    rng = np.random.default_rng(F + C + A)
    frames = _centered(rng, F, A)
    centers = frames[rng.integers(0, F, C)] + 0.01 * _centered(rng, C, A)
    centers -= centers.mean(axis=1, keepdims=True)
    _qcp_check(cuda, frames, centers, A)


@pytest.mark.cuda
def test_cuda_qcp_self_pairs(cuda):
    """Centers taken exactly from the frames: where ``gsum - 2 lambda``
    cancels the msd stays within the floor of 0, and no argmin flips."""
    rng = np.random.default_rng(7)
    F, C, A = 2048, 128, 64
    frames = _centered(rng, F, A)
    idx = rng.permutation(F)[:C]
    k = _qcp_check(cuda, frames, frames[idx].copy(), A, max_flips=0)
    gsum = 2 * float((frames ** 2).sum((1, 2)).max())
    assert_rmsd_close(k[idx, np.arange(C)], np.zeros(C), gsum, A)
    np.testing.assert_array_equal(k[idx].argmin(1), np.arange(C))


@pytest.mark.cuda
def test_cuda_qcp_scaled_coordinates(cuda):
    """Coordinates x 100: the split keeps its relative error, so the bar
    (relative to gsum) holds at any scale."""
    rng = np.random.default_rng(11)
    F, C, A = 1024, 64, 40
    frames = _centered(rng, F, A, scale=100.0)
    centers = frames[rng.integers(0, F, C)] + _centered(rng, C, A)
    centers -= centers.mean(axis=1, keepdims=True)
    _qcp_check(cuda, frames, centers, A)


@pytest.mark.parametrize('where', ['cpu', pytest.param('cuda',
                                                       marks=pytest.mark.cuda)])
def test_one_device_tri_skip_off_runs_the_twin(where, monkeypatch):
    if where == 'cuda' and not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (torch.cuda.is_available() is '
                    'False)')
    seen = []
    real = engine.kcenters_chunk

    def spy(prep, state, n_iters, skip=True):
        seen.append(skip)
        return real(prep, state, n_iters, skip=skip)
    monkeypatch.setattr(engine, 'kcenters_chunk', spy)
    rng = np.random.default_rng(4)
    X = _centered(rng, 3000, 8)
    on = engine.kcenters_device_fused(X, n_clusters=100, device=where)
    assert seen and set(seen) == {True}
    del seen[:]
    off = engine.kcenters_device_fused(X, n_clusters=100, device=where,
                                       tri_skip=False)
    assert seen and set(seen) == {False}
    for a, b in zip(on, off):
        np.testing.assert_array_equal(a, b)
