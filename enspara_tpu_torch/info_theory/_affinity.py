"""Affinity propagation over a precomputed similarity matrix, the
labels of ``sklearn.cluster.AffinityPropagation(affinity='precomputed')``
(scikit-learn's ``cluster/_affinity_propagation.py``) without scikit-learn:
the same degeneracy noise from ``RandomState(random_state)``, the same
damped updates in the same order of operations, the same
``convergence_iter`` stopping rule and the same refinement of the
exemplars. Host numpy: a sweep is n^2 work on n residues.
"""

import warnings

import numpy as np

from ..exception import ConvergenceWarning

__all__ = ['affinity_propagation']


def _equal_similarities_and_preferences(S, preference):
    off = ~np.eye(S.shape[0], dtype=bool)
    return (np.all(preference == preference.flat[0])
            and np.all(S[off] == S[off][0]))


def affinity_propagation(S, damping=0.5, preference=None, max_iter=200,
                         random_state=0):
    """Labels (n,) int of the clusters of similarity matrix ``S`` (n, n):
    sorted, gapless, ``-1`` everywhere when no exemplar emerges (with a
    :class:`~enspara_tpu_torch.exception.ConvergenceWarning`). It stops
    when the exemplars have not changed for sklearn's 15 sweeps."""
    convergence_iter = 15
    S = np.array(S, copy=True)
    if not np.issubdtype(S.dtype, np.floating):
        S = S.astype(np.float64)
    if S.ndim != 2 or S.shape[0] != S.shape[1]:
        raise ValueError('S must be a square array, got shape %s'
                         % (S.shape,))
    if not np.isfinite(S).all():
        raise ValueError('S contains NaN or infinity')
    if not 0.5 <= damping < 1:
        raise ValueError('damping must be in [0.5, 1), got %r' % (damping,))
    n = S.shape[0]
    preference = np.asarray(np.median(S) if preference is None
                            else preference)

    if n == 1 or _equal_similarities_and_preferences(S, preference):
        warnings.warn('All samples have mutually equal similarities. '
                      'Returning arbitrary cluster center(s).')
        if preference.flat[0] > S.flat[n - 1]:
            return np.arange(n)
        return np.zeros(n, dtype=int)

    S.flat[::n + 1] = preference
    A = np.zeros((n, n))
    R = np.zeros((n, n))
    tmp = np.zeros((n, n))
    # remove degeneracies
    rng = np.random.RandomState(random_state)
    S += ((np.finfo(S.dtype).eps * S + np.finfo(S.dtype).tiny * 100)
          * rng.standard_normal(size=(n, n)))

    e = np.zeros((n, convergence_iter))
    ind = np.arange(n)
    for it in range(max_iter):
        # responsibilities
        np.add(A, S, tmp)
        I = np.argmax(tmp, axis=1)
        Y = tmp[ind, I]
        tmp[ind, I] = -np.inf
        Y2 = np.max(tmp, axis=1)
        np.subtract(S, Y[:, None], tmp)
        tmp[ind, I] = S[ind, I] - Y2
        tmp *= 1 - damping
        R *= damping
        R += tmp
        # availabilities
        np.maximum(R, 0, out=tmp)
        tmp.flat[::n + 1] = R.flat[::n + 1]
        tmp -= np.sum(tmp, axis=0)
        dA = np.diag(tmp).copy()
        tmp.clip(0, np.inf, tmp)
        tmp.flat[::n + 1] = dA
        tmp *= 1 - damping
        A *= damping
        A -= tmp
        # convergence: the exemplar set unchanged for convergence_iter sweeps
        E = (np.diag(A) + np.diag(R)) > 0
        e[:, it % convergence_iter] = E
        K = np.sum(E, axis=0)
        if it >= convergence_iter:
            se = np.sum(e, axis=1)
            unconverged = (np.sum((se == convergence_iter) + (se == 0))
                           != n)
            if not unconverged and K > 0:
                never_converged = False
                break
    else:
        never_converged = True

    I = np.flatnonzero(E)
    K = I.size
    if K == 0:
        warnings.warn('Affinity propagation did not converge and this model '
                      'will not have any cluster centers.',
                      ConvergenceWarning)
        return np.full(n, -1)
    if never_converged:
        warnings.warn('Affinity propagation did not converge, this model may '
                      'return degenerate cluster centers and labels.',
                      ConvergenceWarning)
    c = np.argmax(S[:, I], axis=1)
    c[I] = np.arange(K)
    # refine the exemplars, then the clusters
    for k in range(K):
        ii = np.flatnonzero(c == k)
        j = np.argmax(np.sum(S[ii[:, None], ii], axis=0))
        I[k] = ii[j]
    c = np.argmax(S[:, I], axis=1)
    c[I] = np.arange(K)
    labels = I[c]
    return np.searchsorted(np.unique(labels), labels)
