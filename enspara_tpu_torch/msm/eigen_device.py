"""Eigensolves of reversible transition matrices on a device
(counterpart of ``enspara_tpu/msm/eigen_device.py``).

A reversible T (detailed balance against pi, as the ``transpose`` and
``mle`` builders produce) is similar to the symmetric
``S = D^{1/2} T D^{-1/2}`` with ``D = diag(pi)``, so its spectrum comes
from a symmetric eigensolve, and the left eigenvectors of T are
``phi_i = D^{1/2} u_i``. Dense problems take ``torch.linalg.eigh``;
large sparse ones take a Chebyshev-filtered subspace iteration whose
every sparse product is the ELL kernel of
:mod:`~enspara_tpu_torch.ops.ell_spmm` on the card, polished in fp64 on
the host.
"""

import contextlib
import logging
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import scipy.linalg
import scipy.sparse
import scipy.sparse.linalg
import torch

from ..ops.sparse import dense_on_device, ell_from_sparse, ell_spmm
from ..ops.sparse import round_up as _bucket
from ..util.device import full_fp32_matmul, resolve_device
from ..util.log import trace_region
from .transition_matrices import assigns_to_counts_device
from .transition_matrices import eigenspectrum as _eigenspectrum_host

logger = logging.getLogger(__name__)

__all__ = ['transpose_timescales_device', 'eigenspectrum_reversible',
           'implied_timescales_device', 'implied_timescales_batched',
           'bucketed_ell_shape']


def _transpose_tail(counts, k):
    """counts -> C + C^T -> row-stochastic T -> pi -> pi-symmetrized
    eigh -> top-k (eigenvalues, left eigenvectors), all in float32 on
    the counts' device."""
    C = counts.to(torch.float32)
    sym = C + C.T
    row_mass = sym.sum(dim=1)
    pi = row_mass / row_mass.sum()
    # S_ij = sqrt(pi_i) T_ij / sqrt(pi_j). Zero-count states (padding
    # up to n_states) keep a zero row and column instead of NaN
    sq = torch.sqrt(pi)
    one = torch.ones_like(row_mass)
    inv_mass = torch.where(row_mass > 0,
                           1.0 / torch.where(row_mass > 0, row_mass, one),
                           0.0)
    inv_sq = torch.where(sq > 0, 1.0 / torch.where(sq > 0, sq, one), 0.0)
    S = (sq[:, None] * (sym * inv_mass[:, None])) * inv_sq[None, :]
    w, u = torch.linalg.eigh((S + S.T) * 0.5)
    w = w.flip(0)[:k]
    phi = sq[:, None] * u.flip(1)[:, :k]
    # the leading mode is rescaled to unit mass (the equilibrium
    # populations); the others keep eigh's unit norm
    lead = phi[:, :1] / phi[:, :1].sum()
    return w, torch.cat([lead, phi[:, 1:]], dim=1)


def transpose_timescales_device(counts, n_eigs, lag_time=1, device=None):
    """Implied timescales of the transpose-builder MSM of a dense (n, n)
    count matrix, computed on ``device`` (default: where a tensor
    ``counts`` lies, the card for host data); only the ``n_eigs`` modes
    cross to the host.

    Returns ``(timescales, vals, left_vecs)`` as float64 host arrays,
    vals descending and ``left_vecs[:, 0]`` the equilibrium populations.
    """
    device = resolve_device(counts, device)
    counts = torch.as_tensor(counts, device=device)
    w, phi = _transpose_tail(counts, int(n_eigs))
    w = w.cpu().numpy().astype(np.float64)
    phi = phi.cpu().numpy().astype(np.float64)
    with np.errstate(divide='ignore', invalid='ignore'):
        timescales = -float(lag_time) / np.log(w[1:])
    return timescales, w, phi


def bucketed_ell_shape(n, w):
    """The padded (n_pad, w_pad) ELL shape the filtered solver uses for
    an n-state matrix of max row occupancy ``w``: n rounded up to a
    quantum of ~n/16 (a power of two, at least 256), w to a multiple of
    8, as the JAX package buckets them."""
    quantum = max(256, 1 << max(max(n - 1, 1).bit_length() - 4, 0))
    return _bucket(max(n, 1), quantum), _bucket(max(w, 1), 8)


def bucketed_ell(S):
    """The float32 ELL arrays ``(cols, vals)`` of scipy ``S`` padded to
    :func:`bucketed_ell_shape`: the operands of the filtered solver's
    sparse products. Padded rows index themselves with zero values, and
    the solver's random block is zero on them, so they stay zero through
    the filter, add nothing to the Gram and Ritz matrices, and are
    sliced off before stage 2."""
    cols_h, vals_h = ell_from_sparse(S, dtype=np.float32)
    n, w = cols_h.shape
    n_pad, w_pad = bucketed_ell_shape(n, w)
    if (n_pad, w_pad) != (n, w):
        cols_b = np.repeat(
            np.arange(n_pad, dtype=np.int32)[:, None], w_pad, 1)
        vals_b = np.zeros((n_pad, w_pad), dtype=np.float32)
        cols_b[:n, :w] = cols_h
        vals_b[:n, :w] = vals_h
        cols_h, vals_h = cols_b, vals_b
    return cols_h, vals_h


def eigenspectrum_reversible(T, pi=None, n_eigs=None, method='auto',
                             tol=1e-9, max_refine=30, return_info=False,
                             device=None):
    """Top eigenvalues and left eigenvectors of a reversible T.

    Parameters
    ----------
    T : (n, n) row-stochastic reversible matrix (dense or scipy sparse).
    pi : (n,) stationary distribution. If None, or if any entry is not
        positive, the host ``eigenspectrum`` solves T directly.
    n_eigs : number of leading eigenpairs (default: all).
    method : 'auto' | 'eigh' | 'arpack' | 'filtered' ('lobpcg' is an
        alias of 'filtered'). 'auto' takes the dense fp32 ``eigh`` on
        the device up to 4096 states; past that, sparse spectra with
        ``n_eigs < n // 8`` go to the Chebyshev-filtered subspace solver
        when the solve's device is CUDA (up to 131,072 states) and to
        host ARPACK otherwise, the choices of the JAX package.
    tol : residual bound ``||S u - w u||_2`` per requested mode for the
        filtered path (S has unit spectral radius). Modes that miss it
        after ``max_refine`` host refinement sweeps hand the problem to
        host ARPACK (``info['fallback']``).
    max_refine : refinement-sweep budget before that fallback.
    return_info : also return a dict with ``method``, ``residuals``
        (per returned mode), ``refine_sweeps``, ``fallback`` and, for
        the filtered path, the stage-1 and stage-2 telemetry.
    device : where the device stages run (default: the card, see
        :func:`~enspara_tpu_torch.util.device.resolve_device`; a CPU
        tensor or ``'cpu'`` runs them on the CPU, with every kernel's
        plain version).

    Unlike the JAX package, a failure inside the device stage of the
    filtered path (a kernel that does not build or launch, a device
    error) raises instead of falling back to host ARPACK; the numerical
    fallbacks (a non-finite block, a singular Gram matrix, an unmet
    residual budget) remain and report ``info['fallback']``.

    Returns ``(vals, vecs)`` with vals sorted descending and
    ``vecs[:, 0]`` normalized to sum 1 (the equilibrium populations),
    the contract of ``eigenspectrum(..., left=True)``.
    """
    device = resolve_device(T, device)
    sparse_in = scipy.sparse.issparse(T)
    n = T.shape[0]
    if n_eigs is None:
        n_eigs = n

    if pi is None or np.any(np.asarray(pi) <= 0):
        # no pi, or zero-population states: no similarity transform
        out = _eigenspectrum_host(T, n_eigs=n_eigs, left=True)
        return out + ({'method': 'host', 'residuals': None,
                       'refine_sweeps': 0, 'fallback': False},) \
            if return_info else out

    pi = np.asarray(pi, dtype=np.float64).reshape(-1)

    if method == 'lobpcg':
        method = 'filtered'

    if method == 'filtered':
        # the filter block must leave unwanted spectrum to damp; at
        # small n the dense eigh is the better engine anyway
        k_guard = int(min(n - 1, n_eigs + max(8, n_eigs // 2)))
        if 5 * k_guard >= n:
            method = 'eigh'

    if method == 'auto':
        if sparse_in and 4096 < n <= 131_072 and n_eigs < n // 8 \
                and device.type == 'cuda':
            method = 'filtered'
        elif sparse_in and n > 4096 and n_eigs < n // 8:
            method = 'arpack'
        else:
            method = 'eigh'

    sqrt_pi = np.sqrt(pi)
    info = {'method': method, 'residuals': None, 'refine_sweeps': 0,
            'fallback': False}

    if method == 'arpack':
        S = _symmetrized(T, sqrt_pi).astype(np.float64)
        if n_eigs >= n - 1:
            raise ValueError("method='arpack' needs n_eigs < n-1; "
                             "use method='eigh' for full spectra")
        w, u = scipy.sparse.linalg.eigsh(S, k=n_eigs, which='LA')
        order = np.argsort(-w)
        w, u = w[order], u[:, order]
        info['residuals'] = np.linalg.norm(S @ u - u * w[None, :],
                                           axis=0)
    elif method == 'eigh':
        if sparse_in:
            # the similarity transform is value-local: scale the COO
            # triplets on the host (O(nnz)) and scatter on the device
            Sd = dense_on_device(T, scale_rows=sqrt_pi,
                                 scale_cols=1.0 / sqrt_pi, device=device)
        else:
            S = (sqrt_pi[:, None] * np.asarray(T)) / sqrt_pi[None, :]
            Sd = torch.as_tensor(S, dtype=torch.float32, device=device)
        w, u = torch.linalg.eigh((Sd + Sd.T) * 0.5)
        # only the wanted modes cross to the host
        u = u.flip(1)[:, :n_eigs].cpu().numpy().astype(np.float64)
        w = w.flip(0)[:n_eigs].cpu().numpy().astype(np.float64)
    else:
        w, u, info = _lobpcg_refined(_symmetrized(T, sqrt_pi), n_eigs,
                                     tol=tol, max_refine=max_refine,
                                     device=device)

    # left eigenvectors of T: phi_i = sqrt(pi) * u_i
    vecs = sqrt_pi[:, None] * u
    vecs[:, 0] /= vecs[:, 0].sum()
    if return_info:
        return w, vecs, info
    return w, vecs


def _symmetrized(T, sqrt_pi):
    """``(S + S^T) / 2`` of ``S = D^{1/2} T D^{-1/2}`` as scipy CSR."""
    T_csr = T.tocsr() if scipy.sparse.issparse(T) \
        else scipy.sparse.csr_matrix(T)
    S = scipy.sparse.diags(sqrt_pi) @ T_csr @ \
        scipy.sparse.diags(1.0 / sqrt_pi)
    return ((S + S.T) * 0.5).tocsr()


def _orth(V, use_qr):
    """Orthonormal basis of the columns of V: three CholeskyQR passes
    (the first shifted), or Householder QR with ``use_qr``. A Cholesky
    factor that fails turns into NaN, with no host sync, so that the
    sweep loop sees a non-finite block and ends stage 1."""
    if use_qr:
        return torch.linalg.qr(V)[0]
    eye = torch.eye(V.shape[1], dtype=V.dtype, device=V.device)

    def chol_pass(V, shift):
        G = V.T @ V
        if shift:
            G = G + (shift * torch.trace(G) / V.shape[1]) * eye
        L, bad = torch.linalg.cholesky_ex(G)
        L = L.masked_fill(bad != 0, float('nan'))
        return torch.linalg.solve_triangular(L, V.T, upper=False).T

    V = chol_pass(V, 1e-5)
    V = chol_pass(V, 0.0)
    return chol_pass(V, 0.0)


def _filter_sweep(spmm, V, b, degree, use_qr):
    """One filtered-subspace sweep in fp32 on V's device: a Chebyshev
    filter of ``degree`` on the unwanted interval ``[-1, b]``, CholeskyQR3
    re-orthonormalization and a Rayleigh-Ritz ``eigh`` with per-mode
    residual norms. Returns ``(Ritz vectors, Ritz values descending,
    residuals)``; only the last two need to cross to the host."""
    b = np.float32(b)
    e = (b + np.float32(1.0)) * np.float32(0.5)      # filter half-width
    c = (b - np.float32(1.0)) * np.float32(0.5)      # filter center
    two_e = np.float32(2.0) / e
    e, c, two_e = float(e), float(c), float(two_e)
    Vp = V
    Vc = (spmm(V) - c * V) / e
    for _ in range(degree - 1):
        Vn = two_e * (spmm(Vc) - c * Vc) - Vp
        Vp, Vc = Vc, Vn
    Q = _orth(Vc, use_qr)
    SQ = spmm(Q)
    H = Q.T @ SQ
    # a non-finite block must reach the host as NaN Ritz values, not as
    # an eigh that fails on NaN input
    finite = torch.isfinite(H).all()
    H = torch.where(finite, H, torch.zeros_like(H))
    w_r, Z = torch.linalg.eigh((H + H.T) * 0.5)      # ascending
    w_r = torch.where(finite, w_r, torch.full_like(w_r, float('nan')))
    w_r, Z = w_r.flip(0), Z.flip(1)
    Vr = Q @ Z
    res = torch.linalg.norm(SQ @ Z - Vr * w_r[None, :], dim=0)
    return Vr, w_r, res


def _filtered_subspace_device(S, n_eigs, tol=5e-6, max_sweeps=24,
                              device=None):
    """Stage 1 of the sparse eigensolve: fp32 Chebyshev-filtered
    subspace iteration on ``device`` down to the fp32 residual floor.
    Returns the (n, k_block) fp64 host basis for the fp64 refinement,
    plus a telemetry dict.

    The sweep's sparse products are ELL SpMMs (the CUDA kernel on the
    card); a hub-dominated graph, whose ELL padding would blow up, takes
    a ``torch.sparse`` CSR product instead. Near-degenerate clusters
    wider than the block (metastable MSMs put ``n_blocks`` eigenvalues
    within 1e-8 of 1) stall the filter by construction: the sweep loop
    detects the stall and grows the block past the cluster.
    """
    n = S.shape[0]
    nnz_row = np.diff(S.indptr)
    w_max = int(nnz_row.max()) if n else 0
    use_ell = bool(w_max and
                   w_max <= max(32.0, 8.0 * float(nnz_row.mean())))

    if use_ell:
        cols_h, vals_h = bucketed_ell(S)
        n_pad, w_pad = cols_h.shape
        cols_d = torch.as_tensor(cols_h, device=device)
        vals_d = torch.as_tensor(vals_h, device=device)

        def spmm(X):
            return ell_spmm(cols_d, vals_d, X)
    else:
        S32 = S.astype(np.float32)
        S_d = torch.sparse_csr_tensor(
            torch.as_tensor(S32.indptr.astype(np.int64)),
            torch.as_tensor(S32.indices.astype(np.int64)),
            torch.as_tensor(S32.data), size=S32.shape,
            check_invariants=True).to(device)
        n_pad, w_pad = n, 0

        def spmm(X):
            return S_d @ X

    rng = np.random.default_rng(0)
    k_block = int(min(max(n // 6, 1), max(64, 2 * n_eigs + 16)))
    k_block = max(k_block, min(n_eigs + 4, n - 2))
    if n > 256:
        k_block = min(_bucket(k_block, 64), n - 2)   # bucket the block
    grow_left = 2

    def fresh(V_keep=None):
        # host fp64 CholeskyQR2 of a random block (plus the kept
        # columns), once per (re)start
        extra = k_block - (0 if V_keep is None else V_keep.shape[1])
        Vr = rng.normal(size=(n_pad, extra))
        Vr[n:] = 0.0
        V = Vr if V_keep is None else np.concatenate(
            [V_keep.cpu().numpy().astype(np.float64), Vr], axis=1)
        for _ in range(2):
            G = V.T @ V
            L = np.linalg.cholesky(
                G + (1e-12 * np.trace(G) / G.shape[0])
                * np.eye(G.shape[0]))
            V = scipy.linalg.solve_triangular(L, V.T, lower=True).T
        return torch.as_tensor(V, dtype=torch.float32, device=device)

    use_qr = os.environ.get('ENSPARA_TPU_EIG_ORTH') == 'qr'
    V = fresh()
    # plain power step (degree 1, b=0) seeds the Ritz estimates
    V, w_r, res = _filter_sweep(spmm, V, 0.0, 1, use_qr)
    best, stall, sweeps, grew = np.inf, 0, 0, 0
    for _ in range(max_sweeps):
        w_h = w_r.cpu().numpy().astype(np.float64)
        res_h = res.cpu().numpy().astype(np.float64)
        if not (np.all(np.isfinite(w_h))
                and np.all(np.isfinite(res_h))):
            # a collapsed or overflowed fp32 block: hand what we have
            # to stage 2 / the ARPACK fallback
            break
        cur = float(res_h[:n_eigs].max())
        if cur < tol:
            break
        stall = stall + 1 if cur > 0.7 * best else 0
        best = min(best, cur)
        if stall >= 2:
            if cur < 1e-3:
                # on the fp32 rounding floor: the subspace is converged
                # even though the fp32 certificate cannot show it
                break
            grown_k = int(min(2 * k_block, 512, n - 2))
            if grow_left and grown_k > k_block \
                    and 2 * k_block < max(n // 3, k_block + 1):
                # cluster wider than the block: double past it
                k_block = grown_k
                V = fresh(V)
                grow_left -= 1
                grew += 1
                best, stall = np.inf, 0
                V, w_r, res = _filter_sweep(spmm, V, 0.0, 1, use_qr)
                sweeps += 1
                continue
            break                       # gapless: stage 2 / ARPACK
        # filter cutoff: the smallest Ritz value in the block, kept
        # strictly below the wanted modes and above -1
        b = min(float(w_h[k_block - 1]),
                float(w_h[n_eigs - 1]) - 1e-7)
        b = float(np.clip(b, -1.0 + 1e-6, 1.0 - 1e-9))
        # the degree bound keeps the fp32 filter from overflowing: the
        # amplification at the top of the spectrum is
        # cosh(d * acosh(t(1))) with t(1) = (3 - b) / (1 + b);
        # CholeskyQR squares column norms, so ~e^14 per sweep, while
        # Householder QR tolerates e^70
        target = 70.0 if use_qr else 14.0
        t1 = (3.0 - b) / (1.0 + b)
        d = int(np.clip(target / max(np.arccosh(max(t1, 1.0)), 1e-3),
                        3, 16))
        V, w_r, res = _filter_sweep(spmm, V, b, d, use_qr)
        sweeps += 1

    # slice the padded rows off before the fp64 host stage
    return (V[:n].cpu().numpy().astype(np.float64),
            {'stage1_sweeps': sweeps, 'stage1_res':
             float(res[:n_eigs].max()),
             'stage1_block': k_block, 'stage1_grown': grew,
             'stage1_n_padded': n_pad, 'stage1_w_padded': w_pad})


def _lobpcg_refined(S, n_eigs, tol=1e-9, max_refine=30, device=None):
    """Top-``n_eigs`` eigenpairs of a sparse symmetric S with spectrum
    in [-1, 1]: fp32 Chebyshev-filtered subspace iteration on ``device``
    (:func:`_filtered_subspace_device`), then Chebyshev-filtered fp64
    subspace refinement on the host until every requested mode's
    residual ``||S u - w u||`` is below ``tol``, with a host ARPACK
    fallback if the budget runs out, if the Gram matrix turns singular
    or if stage 1 ends on a non-finite block. An exception raised in
    stage 1 propagates.

    Returns ``(w, u, info)`` with w descending, u column-orthonormal.
    """
    n = S.shape[0]

    # --- stage 1: fp32 filtered subspace iteration on the device
    t0 = time.perf_counter()
    # the filter's Gram and Rayleigh-Ritz products need all of fp32
    with full_fp32_matmul():
        V, s1 = _filtered_subspace_device(S, n_eigs, device=device)
    if device.type == 'cuda':
        torch.cuda.synchronize(device)
    s1['stage1_s'] = round(time.perf_counter() - t0, 3)
    if not np.all(np.isfinite(V)):
        S64 = S.astype(np.float64)
        w, u = scipy.sparse.linalg.eigsh(S64, k=n_eigs, which='LA')
        order = np.argsort(-w)
        w, u = w[order], u[:, order]
        res = np.linalg.norm(S64 @ u - u * w[None, :], axis=0)
        return w, u, {'method': 'filtered', 'residuals': res,
                      'refine_sweeps': 0, 'fallback': True, **s1}
    k_guard = V.shape[1]

    # --- stage 2: host fp64 Chebyshev-filtered refinement, GEMM-only:
    # the generalized Rayleigh-Ritz eigh(H, G) returns a G-orthonormal
    # rotation Z, so V @ Z is orthonormal without a tall-skinny QR
    t0 = time.perf_counter()
    S64 = S.astype(np.float64)
    V = np.asarray(V, dtype=np.float64)
    V /= np.linalg.norm(V, axis=0)

    def rayleigh_ritz(V, SV):
        G = V.T @ V
        H = V.T @ SV
        try:
            w_all, Z = scipy.linalg.eigh((H + H.T) * 0.5,
                                         (G + G.T) * 0.5)
        except (np.linalg.LinAlgError, scipy.linalg.LinAlgError):
            # numerically singular Gram matrix: a hard filter can
            # collapse the unit-normalized block onto a few
            # eigendirections; the ARPACK fallback below takes over
            return None
        order = np.argsort(-w_all)
        w_all, Z = w_all[order], Z[:, order]
        Vr = V @ Z                     # orthonormal: Z^T G Z = I
        R = SV @ Z - Vr * w_all[None, :]
        return w_all, Vr, np.linalg.norm(R, axis=0)

    rr = rayleigh_ritz(V, S64 @ V)
    if rr is None:
        w_all, res = None, np.full(max(n_eigs, 1), np.inf)
        max_refine = 0                 # straight to the fallback
    else:
        w_all, V, res = rr
    sweeps = 0
    stalled = 0
    degree = 8
    for sweeps in range(1, max_refine + 1):
        if np.all(res[:n_eigs] < tol):
            break
        prev = float(res[:n_eigs].max())
        # filter interval [-1, b]: everything below the guard block's
        # smallest Ritz value is unwanted; b strictly below the wanted
        # modes and strictly above -1
        b = float(w_all[k_guard - 1])
        b = min(b, float(w_all[n_eigs - 1]) - 1e-12)
        b = max(b, -1.0 + 1e-12)
        e = (b - (-1.0)) / 2.0          # half-width
        c = (b + (-1.0)) / 2.0          # center
        # Chebyshev filter V_j+1 = 2/e (S - c) V_j - V_j-1
        Vp = V
        Vc = (S64 @ V - c * V) / e
        for _ in range(degree - 1):
            Vn = (2.0 / e) * (S64 @ Vc - c * Vc) - Vp
            Vp, Vc = Vc, Vn
        # unit columns keep the generalized RR well conditioned
        Vc /= np.linalg.norm(Vc, axis=0)
        rr = rayleigh_ritz(Vc, S64 @ Vc)
        if rr is None:
            break                      # keep last good V; fallback fires
        w_all, V, res = rr
        cur = float(res[:n_eigs].max())
        if tol < cur < prev:
            # per-matvec contraction this sweep -> the degree that
            # lands the next sweep at ~tol/3
            f = (cur / prev) ** (1.0 / (degree + 1))
            if f < 0.95:
                need = np.log(cur / (tol / 10.0)) / -np.log(f)
                degree = int(np.clip(np.ceil(need), 4, 24))
        # gapless (bulk) spectra stall: bail to ARPACK early
        if float(res[:n_eigs].max()) > 0.5 * prev:
            stalled += 1
            if stalled >= 3:
                break
        else:
            stalled = 0
    else:
        sweeps = max_refine

    s1['stage2_s'] = round(time.perf_counter() - t0, 3)

    if not np.all(res[:n_eigs] < tol):
        logger.warning(
            'filtered subspace iteration + %d fp64 Chebyshev refinement '
            'sweeps left max residual %.2e > tol %.2e at n=%d; falling '
            'back to host ARPACK', sweeps, float(res[:n_eigs].max()), tol,
            n)
        w, u = scipy.sparse.linalg.eigsh(S64, k=n_eigs, which='LA',
                                         v0=V[:, 0].copy())
        order = np.argsort(-w)
        w, u = w[order], u[:, order]
        res = np.linalg.norm(S64 @ u - u * w[None, :], axis=0)
        return w, u, {'method': 'filtered', 'residuals': res,
                      'refine_sweeps': sweeps, 'fallback': True, **s1}

    return (w_all[:n_eigs], V[:, :n_eigs],
            {'method': 'filtered', 'residuals': res[:n_eigs],
             'refine_sweeps': sweeps, 'fallback': False, **s1})


def implied_timescales_device(assigns, lag_times, method, n_times=None,
                              sliding_window=True, trim=False,
                              device=None):
    """Implied timescales with :func:`eigenspectrum_reversible` on
    ``device`` (default: the card) at each lag.

    ``method`` is a builder (``builders.transpose`` or ``builders.mle``)
    that returns a reversible T with its equilibrium probabilities; a
    lag whose T fails the detailed-balance check takes the host
    ``eigenspectrum`` instead. Returns (n_lags, n_times) float64, NaN
    where an eigenvalue is not positive.
    """
    from ..tpt.core import _is_reversible
    from .transition_matrices import assigns_to_counts, trim_disconnected

    device = resolve_device(assigns, device)
    if hasattr(assigns, '_data'):
        n_states = int(assigns._data.max()) + 1
    else:
        n_states = int(np.max(np.asarray(assigns))) + 1
    if n_times is None:
        n_times = int(np.floor(n_states / 10.0)) + 1
    if n_times > n_states - 1:
        n_times = n_states - 1

    out = []
    for lag in lag_times:
        C = assigns_to_counts(assigns, max_n_states=n_states,
                              lag_time=lag,
                              sliding_window=sliding_window)
        if trim:
            _, C = trim_disconnected(C)
        _, T, pi = method(C)
        # the symmetrized solver would silently change the spectrum of
        # a non-reversible T: check detailed balance first
        T_csr = (T if scipy.sparse.issparse(T)
                 else scipy.sparse.csr_matrix(np.asarray(T)))
        if pi is None or np.any(np.asarray(pi) <= 0) \
                or not _is_reversible(T_csr, np.asarray(pi)):
            vals = _eigenspectrum_host(T, n_eigs=n_times + 1)[0]
        else:
            vals, _ = eigenspectrum_reversible(T, pi=pi,
                                               n_eigs=n_times + 1,
                                               device=device)
        vals = np.asarray(vals[1:n_times + 1], dtype=np.float64)
        # a negative eigenvalue has no timescale: NaN, as the host path
        with np.errstate(divide='ignore', invalid='ignore'):
            ts = -lag / np.log(vals)
        ts[~(vals > 0)] = np.nan
        out.append(ts)
    return np.array(out)


def _batched_lags(a, m, lags, prior, n_states, n_times, sliding_window):
    """The timescales at every lag of ``lags`` on ``a``'s device: lag-pair
    counts stacked to (n_lags, n, n) float32, the transpose builder's
    algebra on the stack (``T = rownorm(C + C^T)``, the zero-row guard,
    pi from the row sums), one batched symmetrized ``eigvalsh`` and
    ``-lag / log(w)`` of the top modes after the stationary one."""
    C = torch.stack([assigns_to_counts_device(
        a, m, int(lag), n_states, sliding_window=sliding_window)
        for lag in lags]).to(torch.float32) + prior
    C_sym = C + C.transpose(1, 2)
    row = C_sym.sum(dim=2)
    one = torch.ones_like(row)
    T = C_sym * torch.where(row > 0, 1.0 / torch.where(row > 0, row, one),
                            0.0)[:, :, None]
    pi = row / row.sum(dim=1, keepdim=True)
    sq = torch.sqrt(pi)
    inv_sq = torch.where(sq > 0, 1.0 / torch.where(sq > 0, sq, one), 0.0)
    S = sq[:, :, None] * T * inv_sq[:, None, :]
    w = torch.linalg.eigvalsh((S + S.transpose(1, 2)) * 0.5)   # ascending
    top = w.flip(1)[:, 1:n_times + 1]
    # the reference formula: a negative eigenvalue gives NaN, a unit one
    # an infinite timescale, as on the host
    lag_t = torch.as_tensor(np.asarray(lags, np.float32), device=a.device)
    return -lag_t[:, None] / torch.log(top)


def implied_timescales_batched(assigns, lag_times, n_times=None,
                               sliding_window=True, prior_counts=None,
                               n_states=None, mesh=None, device=None):
    """Implied timescales at every lag with the transpose builder, in
    one batched solve (counterpart of the JAX package's
    ``implied_timescales_batched``): the lag-pair counts of each lag are
    stacked and the reversible eigensolve runs as ONE batched
    symmetrized ``torch.linalg.eigvalsh`` over the (n_lags, n, n) stack,
    in float32.

    Transpose builder only, no ergodic trimming; gapped (-1) data
    follows the padded-counting semantics, not the reference's gap
    compaction. Runs on ``device`` (default: the card). With ``mesh``
    the lags are split over its shards (padded with lag 1 to fill the
    last one) and the assignments replicated on every shard; each shard
    solves its lags, and the results are gathered.

    Returns (n_lags, n_times) float64, like ``implied_timescales``.
    """
    from ..parallel.mesh import host_fetch, pad_to_multiple, replicated
    from ..ra import to_padded

    # host work before the first launch, the card idle through it
    with trace_region('enspara/msm.prepare'):
        padded = to_padded(assigns)
        a = np.asarray(padded.data, dtype=np.int32)
        m = np.asarray(padded.mask, dtype=bool)
        if n_states is None:
            n_states = int(a[m].max()) + 1
        if n_times is None:
            n_times = int(np.floor(n_states / 10.0)) + 1
        if n_times > n_states - 1:
            n_times = n_states - 1
        lags = np.asarray(lag_times, dtype=np.int64)
        if (lags < 1).any():
            raise ValueError('lag times must be >= 1, got %s' % (lags,))
        prior = float(np.float32(0.0 if prior_counts is None
                                 else prior_counts))
        args = (prior, int(n_states), int(n_times), bool(sliding_window))
        if mesh is None:
            dev = resolve_device(None, device)
            a_d = torch.as_tensor(a, device=dev)
            m_d = torch.as_tensor(m, device=dev)
        else:
            # each shard's lags cut on the host, not read back from its
            # card
            n_local = pad_to_multiple(max(len(lags), mesh.size),
                                      mesh.size) // mesh.size
            lag_pad = np.ones(n_local * mesh.size, np.int64)
            lag_pad[:len(lags)] = lags
            a_r, m_r = replicated(a, mesh), replicated(m, mesh)

    if mesh is None:
        out = _batched_lags(a_d, m_d, lags, *args)
        return out.cpu().numpy().astype(np.float64)

    def solve(s):
        lo = (mesh.first_shard + s) * n_local
        dev = mesh.devices[s]
        with torch.cuda.device(dev) if dev.type == 'cuda' \
                else contextlib.nullcontext():
            return _batched_lags(a_r[s], m_r[s], lag_pad[lo:lo + n_local],
                                 *args)
    # one host thread a shard: eigvalsh waits for its card, and one
    # shard's wait must not hold back the others' launches
    with ThreadPoolExecutor(mesh.n_local) as ex:
        outs = list(ex.map(solve, range(mesh.n_local)))
    return host_fetch(outs, mesh).astype(np.float64)[:len(lags)]
