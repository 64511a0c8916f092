"""Counts -> transition-probability builders, uniform signature
``(C, prior_counts, calculate_eq_probs) -> (C, T, eq_probs)``.

Capability parity with enspara/msm/builders.py (estimators: ``mle``,
``transpose``, ``normalize``), designed around two small container
helpers so every estimator is polymorphic over scipy sparse types and
ndarrays: whatever container goes in comes back out. (Counterpart of
``enspara_tpu/msm/builders.py``, host code; ``mle_device`` is not
ported yet.)
"""

import logging
import warnings

import numpy as np
import scipy.sparse

from ..citation import cite
from .transition_matrices import eq_probs
from .libmsm import _mle_prinz_dense

logger = logging.getLogger(__name__)

__all__ = ['mle', 'transpose', 'normalize']


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
