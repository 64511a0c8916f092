"""Counts -> transition-probability builders, uniform signature
``(C, prior_counts, calculate_eq_probs) -> (C, T, eq_probs)``.

Capability parity with enspara/msm/builders.py (estimators: ``mle``,
``transpose``, ``normalize``), designed around two small container
helpers so every estimator is polymorphic over scipy sparse types and
ndarrays: whatever container goes in comes back out. (Counterpart of
``enspara_tpu/msm/builders.py``: host code, but for ``mle_device``.)

``mle_device`` is the Jacobi reformulation of the Prinz MLE on a device:
every (i, j) pair updates from the current row sums simultaneously
(elementwise float64 torch ops over the whole matrix), converging to the
same detailed-balance fixed point as the sequential Gauss-Seidel kernel.
"""

import logging
import warnings

import numpy as np
import scipy.sparse
import torch

from ..citation import cite
from ..exception import ConvergenceWarning
from ..util.device import resolve_device
from .transition_matrices import eq_probs
from .libmsm import _mle_prinz_dense

logger = logging.getLogger(__name__)

__all__ = ['mle', 'transpose', 'normalize', 'mle_device']


def _with_pseudocounts(counts, pseudo):
    """Add a scalar or matrix of pseudocounts, densifying only when
    scipy can't represent the result (sparse + nonzero scalar touches
    every cell, which scipy refuses to do implicitly)."""
    if pseudo is None:
        return counts
    must_densify = (scipy.sparse.issparse(counts)
                    and np.ndim(pseudo) == 0 and pseudo != 0)
    if must_densify:
        counts = np.array(counts.todense())
    return counts + pseudo


def _stochasticize(counts):
    """Row-normalize a counts container into transition probabilities.

    Zero rows stay zero (their reciprocal weight is defined as 0), and
    the container type is preserved: sparse in -> same sparse type out,
    array-like in -> ndarray out.
    """
    row_mass = np.ravel(np.asarray(counts.sum(axis=1), dtype=np.float64))
    recip = np.where(row_mass > 0, 1.0, 0.0)
    recip /= np.where(row_mass > 0, row_mass, 1.0)

    if scipy.sparse.issparse(counts):
        scaled = scipy.sparse.diags(recip) @ \
            scipy.sparse.csr_matrix(counts).asfptype()
        return type(counts)(scaled)
    return np.asarray(counts) * recip[:, None]


@cite('prinz-mle')
def mle(C, prior_counts=None, calculate_eq_probs=True):
    """Detailed-balance maximum-likelihood estimator (Prinz et al.,
    J. Chem. Phys. 134, 174105, 2011). Capability match for the
    reference's ``builders.mle``; the Gauss-Seidel inner loop runs in
    the native kernel (see native/prinz.cpp).

    The stationary distribution falls out of the solve itself, so
    ``calculate_eq_probs=False`` can only drop it (with a warning),
    never skip the work.
    """
    C = _with_pseudocounts(C, prior_counts)

    repack = np.array
    if scipy.sparse.issparse(C):
        repack = type(C)
        C = np.asarray(C.todense())

    T, stationary = _mle_prinz_dense(C)
    if not calculate_eq_probs:
        warnings.warn('MLE method cannot suppress calculation of '
                      'equilibrium probabilities, since they are '
                      'calculated together.', category=RuntimeWarning)
        stationary = None

    return repack(C), repack(T), stationary


def _estimate(C, pseudo, want_eq, symmetrize):
    """Shared core of the two closed-form estimators.

    With ``symmetrize`` the counts are reversibilized as (C + Cᵀ)/2
    first, which makes the stationary distribution a cheap row-mass
    ratio; without it the stationary distribution needs the top left
    eigenvector of T.
    """
    counts = _with_pseudocounts(C, pseudo)
    work = counts + counts.T if symmetrize else counts
    T = _stochasticize(work)

    # symmetrization widens some sparse containers (e.g. dia -> csr);
    # pin both outputs back to the caller's container
    if not isinstance(T, type(counts)):
        T = type(counts)(T)
        work = type(counts)(work)

    if symmetrize:
        pi = None
        if want_eq:
            pi = np.ravel(np.asarray(work.sum(axis=1) / work.sum()))
        # halve via scalar multiply: integer sparse types then upcast
        # to float instead of truncating the half-counts
        return work * 0.5, T, pi

    return counts, T, (eq_probs(T) if want_eq else None)


def transpose(C, prior_counts=None, calculate_eq_probs=True):
    """Symmetrization estimator: detailed balance imposed by averaging
    forward and reverse counts, T = rownorm(C + Cᵀ)."""
    return _estimate(C, prior_counts, calculate_eq_probs,
                     symmetrize=True)


def normalize(C, prior_counts=None, calculate_eq_probs=True):
    """Plain row normalization (no detailed-balance constraint); the
    stationary distribution comes from the top left eigenvector, which
    is the expensive part and can be skipped."""
    return _estimate(C, prior_counts, calculate_eq_probs,
                     symmetrize=False)


# sweeps of mle_device between two host reads of its stop flag
_SWEEP_BLOCK = 32


def _jacobi_mle(Cj, tol, max_iter, block=_SWEEP_BLOCK):
    """The Jacobi sweeps of :func:`mle_device` on ``Cj``'s device, with the
    JAX package's stopping rule (``enspara_tpu/msm/builders.py:209-222``):
    stop after the first sweep whose ``|logl change| <= tol`` (a NaN change
    stops too), or after ``max_iter`` sweeps. Sweeps run in blocks of
    ``block`` with a device ``done`` flag that freezes ``X`` once set, so
    the host reads the flag once a block and the result is the ``X`` of a
    per-sweep check. Returns ``(X, n_sweeps, last |logl change|)``."""
    n = Cj.shape[0]
    off = ~torch.eye(n, dtype=torch.bool, device=Cj.device)
    C_rs = Cj.sum(dim=1)
    Csym = Cj + Cj.T
    dC = torch.diagonal(Cj)
    denom = C_rs - dC
    a = (C_rs[:, None] - Cj) + (C_rs[None, :] - Cj.T)
    a_ok = a.abs() > 1e-30

    def sweep(X):
        X_rs = X.sum(dim=1)
        dX = torch.diagonal(X)
        # diagonal update (independent per state)
        diag_new = torch.where(
            denom > 0, dC * (X_rs - dX) / torch.clamp(denom, min=1e-30), dX)
        X = torch.where(off, X, torch.diag(diag_new))
        X_rs = X.sum(dim=1)
        # all-pairs quadratic-root update from current row sums
        b = (C_rs[:, None] * (X_rs[None, :] - X)
             + C_rs[None, :] * (X_rs[:, None] - X)
             - Csym * (X_rs[:, None] + X_rs[None, :] - 2 * X))
        c = -Csym * (X_rs[:, None] - X) * (X_rs[None, :] - X)
        disc = torch.clamp(b * b - 4 * a * c, min=0.0)
        v = torch.where(a_ok, (-b + torch.sqrt(disc)) / (2 * a), X)
        # keep the diagonal from the diagonal pass; Jacobi-average the
        # off-diagonal update for stability
        v = 0.5 * (v + v.T)
        return torch.where(off, 0.5 * X + 0.5 * v, X)

    def logl_of(X):
        # the host kernels' stopping metric (reference libmsm.pyx:46,
        # incl. its log10 base and off-diagonal divide-outside-the-log
        # quirk), vectorized
        X_rs = X.sum(dim=1)
        d = torch.diagonal(X)
        diag_term = torch.where(
            d > 0, dC * torch.log10(torch.clamp(d, min=1e-300) / X_rs),
            0.0).sum()
        off_term = torch.where(
            off & (X > 0),
            Cj * torch.log10(torch.clamp(X, min=1e-300)) / X_rs[:, None],
            0.0).sum()
        return diag_term + off_term

    X = Csym
    old = logl_of(X)
    delta = torch.full((), float('inf'), dtype=Cj.dtype, device=Cj.device)
    done = torch.zeros((), dtype=torch.bool, device=Cj.device)
    n_sweeps = torch.zeros((), dtype=torch.int64, device=Cj.device)
    i = 0
    while i < max_iter:
        for _ in range(min(block, max_iter - i)):
            X_new = sweep(X)
            new = logl_of(X_new)
            change = (new - old).abs()
            X = torch.where(done, X, X_new)
            delta = torch.where(done, delta, change)
            old = torch.where(done, old, new)
            n_sweeps += (~done).to(torch.int64)
            done = done | ~(change > tol)
            i += 1
        if bool(done):
            break
    return X, int(n_sweeps), float(delta)


def mle_device(C, prior_counts=None, calculate_eq_probs=True,
               tol=1e-11, max_iter=2000, device=None):
    """Jacobi-style on-device Prinz MLE (counterpart of
    ``enspara_tpu/msm/builders.py:134-238``): all (i, j) pair updates
    computed simultaneously from the current row sums, then row sums
    refreshed exactly — a fixed-point iteration with the same
    detailed-balance stationary point as the Gauss-Seidel kernel, on
    ``device`` (default: the card, see
    :func:`~enspara_tpu_torch.util.device.resolve_device`). Roughly
    O(n^2) per sweep with no sequential dependence.

    The sweeps run in float64, where the JAX package's run in float32:
    with fp32 sweeps the stopping rule (``|logl change| <= tol``) reads
    the change of a sum of ~1e6 terms at fp32 resolution, and it read 0
    after a few sweeps on phase 5's 1000-state labels of ``chip_smoke.py``
    with T still 1.9e-3 from the host MLE; in float64 the same rule
    stops after 60-90 sweeps within ~1e-10 of it.

    Returns the same (C, T, eq) triple as :func:`mle`.
    """
    C_in = _with_pseudocounts(C, prior_counts)
    if scipy.sparse.issparse(C_in):
        C_arr = np.asarray(C_in.todense(), dtype=np.float32)
        recast = type(C_in)
    else:
        C_arr = np.asarray(C_in, dtype=np.float32)
        recast = np.array
    if (C_arr.sum(axis=1) <= 0).any() \
            or ((C_arr + C_arr.T).sum(axis=1) <= 0).any():
        # match the host kernel's contract: a zero-count state would
        # otherwise NaN-poison T silently (0/0 row)
        raise ValueError(
            'Prinz MLE requires every state to have at least one '
            'transition. Trim disconnected states first.')

    dev = resolve_device(C, device)
    X, n_sweeps, delta = _jacobi_mle(
        torch.as_tensor(C_arr, dtype=torch.float64, device=dev), tol,
        max_iter)
    logger.info('mle_device: %d sweeps on %s, last |logl change| %g',
                n_sweeps, dev, delta)
    if n_sweeps >= max_iter and delta > tol:
        warnings.warn(
            'Prinz MLE (device) reached max_iter=%d without the '
            'log-likelihood change dropping below tol=%g (last '
            'change %g)' % (max_iter, tol, delta),
            ConvergenceWarning)
    X_rs = X.sum(dim=1)
    T = (X / X_rs[:, None]).cpu().numpy()
    T /= T.sum(axis=1, keepdims=True)
    pi = (X_rs / X_rs.sum()).cpu().numpy()
    pi /= pi.sum()
    eq = pi if calculate_eq_probs else None
    return recast(C_arr), recast(T), eq
