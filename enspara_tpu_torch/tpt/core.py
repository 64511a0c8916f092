"""Committor probabilities and mean first passage times (counterpart of
``enspara_tpu/tpt/core.py``; reference: enspara/tpt/core.py).

On a CUDA device the absorbing-state linear solves run as one dense fp32
LU on the card (``torch.linalg.lu_factor``), refined to fp64 accuracy
against the exact sparse system on the host, reusing the factors —
direct SuperLU factorization of MSM graphs suffers catastrophic fill-in
(ring + shortcut topologies take seconds to minutes at 10k states).

A device failure (a factorization that errors, an out-of-memory)
raises: unlike the JAX package (``enspara_tpu/tpt/core.py:405-411``),
nothing here catches it and carries on on the host. Only a refinement
that stalls (the fp32 factors too inaccurate for the system) hands over
to the host engines.

Systems too big to densify use the reversibility of the chain: with
pi_i T_ij = pi_j T_ji, the absorbing system (I - Q) is
pi-symmetrizable to a sparse SPD M-matrix, and Jacobi-preconditioned
fp64 CG solves it where direct factorization is fill-in-bound.
Non-reversible or CG-stalling systems fall back to SuperLU or GMRES
on the host. On the CPU every solve takes the host engines, as the JAX
package does on its CPU backend.
"""

import logging
import warnings

import numpy as np
import scipy.sparse
import scipy.sparse.linalg
import torch

from ..citation import cite
from ..msm.transition_matrices import (_eq_probs_detailed_balance,
                                       eq_probs)
from ..ops.sparse import dense_on_device
from ..util.device import resolve_device

logger = logging.getLogger(__name__)

__all__ = ['committors', 'mfpts']

# densify absorbing-state solves on the device up to this many states.
# This is the JAX package's cap (enspara_tpu/tpt/core.py:36-44), set on a
# TPU v5e: XLA's blocked LU overflowed its 16 MB scoped VMEM in the
# 11-16k decade, so the cap sits at the largest size verified to factor
# there (10k, BASELINE config 4). No card figure has set it yet; past it
# the host sparse engines take over.
_DENSE_SOLVE_MAX_STATES = 10240

# above this, direct sparse LU fill-in is assumed intractable and the
# non-reversible fallback goes to GMRES before SuperLU
_DIRECT_SOLVE_MAX_STATES = 262144


def _device_lu(device):
    """Whether the solves on ``device`` take the dense LU: on a CUDA
    device (in place of the JAX package's ``_device_solve_profitable``,
    ``enspara_tpu/tpt/core.py:47-55``); on the CPU the host engines win."""
    return device.type == 'cuda'


def _absorbing_csr_system(tprob, sinks, sources, all_absorbing):
    """Build (I - Q) with absorbing rows/cols zeroed and unit diagonal,
    plus the SUMMED right-hand-side vector ``b`` (committors are
    linear in the sink columns, so one solve of the summed RHS
    replaces a solve per sink), entirely in CSR arithmetic — O(nnz).

    Duplicated entries in ``sinks``/``sources`` are deduplicated: the
    committor to a sink SET cannot depend on how often a member is
    listed."""
    n = tprob.shape[0]
    Tc = tprob.tocsr()
    sinks_u = np.unique(sinks)
    b = np.asarray(Tc[:, sinks_u].sum(axis=1),
                   dtype=np.float64).ravel()
    b[sinks_u] = 1.0
    b[np.unique(sources)] = 0.0

    # unique: a state listed in both sources and sinks (or duplicated
    # within either) must still get diagonal exactly 1.0, matching the
    # reference's LIL assignment semantics (tpt/core.py:60-67) rather
    # than accumulating one per occurrence
    absorbing_unique = np.unique(all_absorbing)
    keep = np.ones(n)
    keep[absorbing_unique] = 0.0
    D = scipy.sparse.diags(keep)
    A = scipy.sparse.eye(n, format='csr') - Tc
    A = (D @ A @ D).tocsr()
    A = A + scipy.sparse.coo_matrix(
        (np.ones(absorbing_unique.shape[0]),
         (absorbing_unique, absorbing_unique)), shape=(n, n))
    A = A.tocsr()
    A.eliminate_zeros()
    return A, b


def _refined_solve(A_dense32, B, A_exact=None, max_refine=10,
                   rtol=1e-10, device=None):
    """Solve A x = B via one fp32 LU factorization on ``device``
    (``torch.linalg.lu_factor``) plus fp64 iterative refinement on the
    host: r = B - A x is computed in fp64 against ``A_exact`` (sparse or
    dense), and the correction reuses the factors (``lu_solve``).

    Refinement stops when the residual meets both the JAX package's
    bound, ``|r| <= rtol |B|``, and the fp64 normwise backward error of
    LAPACK's mixed-precision ``dsgesv``, ``|r| <= sqrt(n) eps64 |A| |x|``
    (max norms): the first alone left committors 6e-10 from a host
    SuperLU solve at BASELINE config 4 on the card (``chip_smoke.py``
    phase 10e), where the residual met 1e-10 after one step.

    ``A_dense32`` is a float32 tensor (it runs where it lies) or an
    array (it goes to ``device``, default: the card). Returns fp64 x
    with ~fp64 accuracy for the well-conditioned M-matrix systems TPT
    produces, or None if refinement stalls (the caller falls back to a
    host solve). A failure of the device raises."""
    if A_exact is None:
        A_exact = A_dense32
    if isinstance(A_exact, torch.Tensor):
        A_exact = A_exact.cpu().numpy().astype(np.float64)
    B = np.asarray(B, dtype=np.float64)
    b1d = B.ndim == 1
    Bm = B[:, None] if b1d else B

    if isinstance(A_dense32, torch.Tensor):
        A32 = A_dense32.to(torch.float32)
    else:
        A32 = torch.as_tensor(np.asarray(A_dense32, dtype=np.float32),
                              device=resolve_device(A_dense32, device))
    lu, piv = torch.linalg.lu_factor(A32)

    def solve(rhs):
        r32 = torch.as_tensor(rhs.astype(np.float32), device=A32.device)
        return torch.linalg.lu_solve(lu, piv, r32).cpu().numpy().astype(
            np.float64)

    x = solve(Bm)
    bnorm = max(np.abs(Bm).max(), 1e-300)
    backward = (np.sqrt(Bm.shape[0]) * np.finfo(np.float64).eps
                * float(abs(A_exact).sum(axis=1).max()))
    prev = np.inf
    for _ in range(max_refine):
        r = Bm - A_exact @ x
        rnorm = np.abs(r).max()
        if rnorm <= rtol * bnorm and rnorm <= backward * np.abs(x).max():
            return x[:, 0] if b1d else x
        if rnorm >= prev * 0.5:     # stalled: fp32 LU too inaccurate
            return None
        prev = rnorm
        x = x + solve(r)
    return None


def _I_m_Q(tprob, absorbing_states, n_states=None):
    """(I - Q) with absorbing rows/cols zeroed and unit diagonal.
    (reference: tpt/core.py:25)"""
    T = np.asarray(tprob, dtype=float)
    n = T.shape[0] if n_states is None else n_states
    transient = np.ones(n, dtype=bool)
    transient[absorbing_states] = False
    # off-diagonal blocks: -T restricted to transient x transient
    A = np.where(transient[:, None] & transient[None, :], -T, 0.0)
    # diagonal: 1 - T_ii on transient states, exactly 1 on absorbing
    np.fill_diagonal(A, np.where(transient, 1.0 - T.diagonal(), 1.0))
    return A


def _stationary_estimate(T_csr):
    """Stationary distribution of a sparse row-stochastic T via ARPACK
    (k=1 Arnoldi on T^T). Returns None when it fails or the leading
    eigenvector is not sign-consistent.

    The restart budget is BOUNDED (scipy's default is 10*n implicit
    restarts — effectively unbounded at 10^6 states, and metastable
    chains have eigengaps ~1/timescale where Arnoldi can grind
    forever): a generous Krylov width plus a few hundred restarts
    either converges in seconds-to-minutes or we fall back. Callers
    who HAVE pi (any builder output) should pass it and skip this."""
    # reversible chains never need Arnoldi: detailed balance fixes pi
    # along a spanning tree in O(nnz), certified on every entry
    pi = _eq_probs_detailed_balance(T_csr)
    if pi is not None:
        return pi
    n = T_csr.shape[0]
    try:
        w, v = scipy.sparse.linalg.eigs(
            T_csr.T.astype(np.float64), k=1, which='LM',
            v0=np.full(n, 1.0), ncv=min(n - 1, 40), maxiter=300,
            tol=1e-10)
    except (scipy.sparse.linalg.ArpackError, ValueError):
        return None
    if abs(w[0] - 1.0) > 1e-6:
        return None
    pi = np.real(v[:, 0])
    if pi.sum() < 0:
        pi = -pi
    if np.any(pi <= 0):
        return None
    return pi / pi.sum()


def _is_reversible(T_csr, pi, rtol=1e-8):
    """max |pi_i T_ij - pi_j T_ji| <= rtol * max flux, in O(nnz)."""
    F = scipy.sparse.diags(pi) @ T_csr
    D = (F - F.T).tocoo()
    if D.nnz == 0:
        return True
    return np.abs(D.data).max() <= rtol * np.abs(F.data).max()


def _cg_absorbing_solve(A, b, pi, rtol=1e-9):
    """Solve the absorbing-state system ``A x = b`` (A from
    :func:`_absorbing_csr_system`) by pi-symmetrized Jacobi-CG.

    For a reversible chain, D A D^{-1} with D = diag(sqrt(pi)) is a
    sparse SPD M-matrix (keep-block pi-flux symmetry; unit absorbing
    diagonal), so fp64 CG converges superlinearly. Returns fp64 x with
    the residual verified against the EXACT unsymmetrized system, or
    None if CG fails to reach ``rtol``.
    """
    pi = np.asarray(pi, dtype=np.float64)
    # trimmed MSMs commonly carry zero-population states; d=0 would
    # poison the symmetrized operator with inf/nan
    if pi.shape[0] != A.shape[0] or not np.all(pi > 0):
        return None
    d = np.sqrt(pi)
    As = scipy.sparse.diags(d) @ A.astype(np.float64) @ \
        scipy.sparse.diags(1.0 / d)
    As = ((As + As.T) * 0.5).tocsr()
    diag = As.diagonal()
    if np.any(diag <= 0):
        return None
    Mj = scipy.sparse.linalg.LinearOperator(As.shape,
                                            lambda v: v / diag)
    b = np.asarray(b, dtype=np.float64)

    # scipy's CG stops on its recurrence residual (2-norm, b-relative),
    # which keeps contracting to this target even when the true residual
    # has floored at ~eps * |A| * |x|; the acceptance check below scales
    # with |x| instead (mean first passage solves have |x| ~ 1/gap >> |b|)
    y, code = scipy.sparse.linalg.cg(As, d * b, M=Mj, rtol=1e-13,
                                     atol=0.0, maxiter=50_000)
    if code != 0:
        return None
    x = y / d

    # accept on the normwise backward error of the EXACT unsymmetrized
    # system: |Ax - b| <= rtol * (|b| + |A|*|x|)
    anorm = float(np.abs(A).sum(axis=1).max())
    scale = float(np.abs(b).max()) + anorm * float(np.abs(x).max())
    resid = float(np.abs(A @ x - b).max())
    # NaN-safe: 'resid <= bound' is False for NaN, so a poisoned
    # solve is rejected rather than silently accepted
    if not (resid <= rtol * max(scale, 1e-300)):
        return None
    return x


def _gmres_absorbing_solve(A, b, rtol=1e-9):
    """Jacobi-preconditioned GMRES on the raw (unsymmetrized)
    absorbing system: no pi needed, memory-light (restart 50), slower
    than the CG path but immune to the fill-in explosion that makes
    direct factorization intractable at ~10^6 states.
    Residual-verified; None on failure."""
    A64 = A.tocsr().astype(np.float64)
    b = np.asarray(b, dtype=np.float64)
    diag = A64.diagonal()
    if np.any(diag == 0):
        return None
    Mj = scipy.sparse.linalg.LinearOperator(A64.shape,
                                            lambda v: v / diag)

    # accept on the normwise backward error of the original system,
    # |Ax-b| <= rtol*(|b| + |A||x|) — same criterion as the CG path —
    # checked at every restart, bailing out of gmres as soon as it holds
    anorm = float(np.abs(A64).sum(axis=1).max())
    bmax = float(np.abs(b).max())

    def _backward_error_ok(x):
        resid = float(np.abs(A64 @ x - b).max())
        bound = rtol * max(bmax + anorm * float(np.abs(x).max()),
                           1e-300)
        return resid <= bound  # NaN-safe: False for NaN resid

    class _Converged(Exception):
        def __init__(self, x):
            self.x = x

    def _check_restart(xk):
        if _backward_error_ok(xk):
            raise _Converged(np.array(xk, dtype=np.float64))

    try:
        x, _code = scipy.sparse.linalg.gmres(
            A64, b, M=Mj, rtol=1e-13, atol=0.0, restart=50,
            maxiter=4000, callback=_check_restart, callback_type='x')
    except _Converged as conv:
        return conv.x
    # maxiter exhausted or scipy's own stop fired between callbacks:
    # judge the final iterate on the same backward-error bound
    if _backward_error_ok(x):
        return x
    return None


def _large_sparse_absorbing_solve(tprob_csr, A, b, pi):
    """Best host engine for absorbing solves: pi-symmetrized CG when the
    chain is reversible (estimating pi via ARPACK when not given);
    otherwise SuperLU (A+A^T minimum-degree ordering) up to ~262k
    states, Jacobi-GMRES past that, each falling back to the other, then
    spsolve as the last resort."""
    if pi is None:
        pi = _stationary_estimate(tprob_csr)
    if pi is not None and len(pi) == tprob_csr.shape[0] \
            and _is_reversible(tprob_csr, np.asarray(pi, np.float64)):
        x = _cg_absorbing_solve(A, b, pi)
        if x is not None:
            return x
        logger.info('pi-symmetrized CG stalled; falling back to '
                    'the direct host path')

    engines = ['splu', 'gmres']
    if A.shape[0] > _DIRECT_SOLVE_MAX_STATES:
        engines.reverse()
    for engine in engines:
        if engine == 'gmres':
            x = _gmres_absorbing_solve(A, b)
            if x is not None:
                return x
            logger.info('Jacobi-GMRES stalled on the absorbing '
                        'system; trying the next engine')
        else:
            with warnings.catch_warnings():
                warnings.simplefilter('ignore')
                try:
                    # MSM graphs have (near-)symmetric patterns: the
                    # A+A^T minimum-degree ordering cuts SuperLU
                    # fill-in ~3x vs the default COLAMD
                    lu = scipy.sparse.linalg.splu(
                        A.tocsc(), permc_spec='MMD_AT_PLUS_A')
                    return lu.solve(np.asarray(b, dtype=np.float64))
                except RuntimeError:
                    logger.info('SuperLU failed on the absorbing '
                                'system; trying the next engine')
    x = scipy.sparse.linalg.spsolve(A, np.asarray(b, dtype=np.float64))
    return np.asarray(x)


def _sparse_absorbing_solve(tprob, A, b, pi, dev):
    """``A x = b`` for a sparse absorbing system: the device LU with
    refinement on a CUDA device up to ``_DENSE_SOLVE_MAX_STATES``, the
    host engines otherwise or when the refinement stalls."""
    if A.shape[0] <= _DENSE_SOLVE_MAX_STATES and _device_lu(dev):
        # one solve of the summed RHS vector; the dense matrix is
        # scattered from its COO triplets on the device
        x = _refined_solve(dense_on_device(A, device=dev), b, A_exact=A)
        if x is not None:
            return x
        logger.info('fp32 refinement stalled; using the host sparse '
                    'path')
    return _large_sparse_absorbing_solve(tprob.tocsr(), A, b, pi)


@cite('tpt')
def committors(tprob, sources, sinks, pi=None, device=None):
    """Forward committors q+ of the reaction sources -> sinks: the
    probability each state reaches a sink before a source, from the
    absorbing-state linear solve (I-Q) x = R. (counterpart of
    ``enspara_tpu/tpt/core.py:377``; reference: tpt/core.py:40)

    ``pi``, the stationary distribution of a reversible ``tprob``, lets
    large sparse systems take the pi-symmetrized CG path without the
    ARPACK estimate. The solve runs on ``device`` (default: the card,
    see :func:`~enspara_tpu_torch.util.device.resolve_device`): the
    dense LU on a CUDA device, the host engines on the CPU."""
    sources = np.array(sources, dtype=int).reshape(-1)
    sinks = np.array(sinks, dtype=int).reshape(-1)
    all_absorbing = np.append(sources, sinks)
    dev = resolve_device(tprob, device)
    n_states = tprob.shape[0]

    if scipy.sparse.issparse(tprob):
        I_m_Q, b = _absorbing_csr_system(tprob, sinks, sources,
                                         all_absorbing)
        q = _sparse_absorbing_solve(tprob, I_m_Q, b, pi, dev)
    else:
        dense = np.asarray(tprob, dtype=float)
        sinks_u = np.unique(sinks)
        b = dense[:, sinks_u].sum(axis=1)
        b[sinks_u] = 1.0
        b[np.unique(sources)] = 0.0
        I_m_Q = _I_m_Q(dense, all_absorbing, n_states=n_states)
        q = None
        if n_states >= 64 and _device_lu(dev):
            q = _refined_solve(I_m_Q, b, device=dev)
        if q is None:
            q = np.linalg.solve(I_m_Q, b)

    q = np.asarray(q)
    q[sinks] = 1.0
    return q


def mfpts(tprob, sinks=None, populations=None, lagtime=1., device=None):
    """Mean first passage times, all-to-all (fundamental matrix) or to a
    sink set (absorbing solve). (counterpart of
    ``enspara_tpu/tpt/core.py:441``; reference: tpt/core.py:105)

    Sparse inputs with a sink set stay sparse: the absorbing solve
    (I-Q) x = 1 runs through the same dispatch as :func:`committors`
    (the device LU scattered from the sparse system on a CUDA device,
    the host engines otherwise), so no n^2 host array is built."""
    dev = resolve_device(tprob, device)
    if scipy.sparse.issparse(tprob) and sinks is not None:
        sinks = np.array(sinks, dtype=int).reshape(-1)
        n_states = tprob.shape[0]
        A, _ = _absorbing_csr_system(tprob, sinks,
                                     np.empty(0, dtype=int), sinks)
        c = np.ones(n_states)
        c[sinks] = 0.0
        pi = np.asarray(populations, dtype=np.float64).reshape(-1) \
            if populations is not None else None
        x = _sparse_absorbing_solve(tprob, A, c, pi, dev)
        x[sinks] = 0.0
        return lagtime * x

    tprob = tprob.toarray() if scipy.sparse.issparse(tprob) \
        else np.asarray(tprob, dtype=float)
    n_states = len(tprob)
    if populations is None and sinks is None:
        populations = eq_probs(tprob)

    if sinks is None:
        W = np.array([populations] * n_states)
        Z = np.linalg.inv(np.eye(n_states) - tprob + W)
        return lagtime * (np.diag(Z) - Z) / W

    sinks = np.array(sinks, dtype=int).reshape(-1)
    I_m_Q = _I_m_Q(tprob, sinks, n_states=n_states)
    c = np.ones(n_states)
    c[sinks] = 0
    if n_states >= 64 and _device_lu(dev):
        x = _refined_solve(I_m_Q, c, device=dev)
        if x is not None:
            return lagtime * x
    return lagtime * np.linalg.solve(I_m_Q, c)
