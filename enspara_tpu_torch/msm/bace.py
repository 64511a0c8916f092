"""BACE: Bayesian Agglomerative Clustering Engine for coarse-graining
MSMs (counterpart of ``enspara_tpu/msm/bace.py``, host numpy; reference:
enspara/msm/bace.py; Bowman, J. Chem. Phys. 137, 134111 (2012)).

States with insufficient statistics (Bayes factor < 3 vs a uniform
pseudo-state) are first absorbed into their kinetically nearest
neighbors; then the pair of states with the lowest merge Bayes factor
is iteratively merged until ``n_macrostates`` remain.

The per-pair Bayes-factor evaluation (the hot loop the reference
parallelizes with a process pool, bace.py:216-253) is vectorized over
all candidate partners of a state at once.
"""

import logging

import numpy as np
import scipy.sparse
import scipy.special

from .. import exception
from ..citation import cite

logger = logging.getLogger(__name__)

__all__ = ['bace', 'baysean_prune', 'absorb']


def _xlogy(x, y):
    """x * log(y) with the 0*log(anything) = 0 convention (C kernel;
    the boolean-gather formulation cost ~3.6 s of a 600-state
    agglomeration)."""
    return scipy.special.xlogy(x, y)


def _merge_bayes_factors(c1, w1, c2_rows, w2):
    """Bayes factors for merging profile (c1, w1) with each row of
    (c2_rows, w2): D = sum c1 log(p1/cp) + sum c2 log(p2/cp).
    (vectorized form of reference bace.py:235 multiDistHelper)

    Rewritten per element as count-fraction log ratios — with
    s = c1 + c2,

        D = Σ xlogy(c1, c1/s) + Σ xlogy(c2, c2/s)
          + (Σc1)·log((w1+w2)/w1) + (Σc2)·log((w1+w2)/w2)

    which keeps every term a moderate log-ratio (NO cancellation of
    large self-entropies — an aggregate-entropy identity form flipped
    near-tie merge decisions) while costing two xlogy passes instead
    of the original three guarded ones (this function is the
    agglomeration hot loop). xlogy(0, ·) = 0 covers the s = 0 cells."""
    c1 = np.asarray(c1, dtype=np.float64)
    c2 = np.asarray(c2_rows, dtype=np.float64)
    w2 = np.asarray(w2, dtype=np.float64)
    s = c1[None, :] + c2
    # s = 0 implies both counts are 0 (terms vanish), but 0/0 = nan
    # and xlogy(0, nan) is nan, not 0 — substitute a harmless 1
    s = np.where(s > 0, s, 1.0)
    t1 = _xlogy(np.broadcast_to(c1[None, :], c2.shape),
                c1[None, :] / s).sum(axis=1)
    t2 = _xlogy(c2, c2 / s).sum(axis=1)
    wsum = w1 + w2
    return (t1 + t2 + c1.sum() * np.log(wsum / w1)
            + c2.sum(axis=1) * np.log(wsum / w2))


def _row(c, i):
    if scipy.sparse.issparse(c):
        return np.asarray(c[i, :].todense()).ravel()
    return np.asarray(c[i, :]).ravel()


def renumberMap(state_map, stateDrop):
    """Shift all labels >= stateDrop down by one.
    (reference: bace.py:162)"""
    state_map = np.asarray(state_map)
    state_map[state_map >= stateDrop] -= 1
    return state_map


def absorb(c, absorb_states):
    """Absorb each listed state into its kinetically nearest neighbor
    (largest off-diagonal counts). (reference: bace.py:255)

    Returns ``(c, labels)``: counts with absorbed rows/cols zeroed and
    a relabeling of every original state.
    """
    is_sparse = scipy.sparse.issparse(c)
    c = c.tolil() if is_sparse else np.array(c, dtype=float, copy=True)
    labels = np.arange(c.shape[0])

    def fold_into(dest, src, diag_mass):
        """Accumulate src's row/col into dest's, restore the stored
        diagonal mass, zero src out of the matrix."""
        if is_sparse:
            c[dest, :] = c[dest, :] + c[src, :]
            c[:, dest] = c[:, dest] + c[:, src]
        else:
            c[dest, :] += c[src, :]
            c[:, dest] += c[:, src]
        c[dest, dest] += diag_mass
        c[src, :] = 0
        c[:, src] = 0

    for s in absorb_states:
        diag_mass = c[s, s]
        c[s, s] = 0     # self counts must not win the argmax below

        neighbors = _row(c, s)
        if not neighbors.sum():
            if diag_mass:
                raise exception.DataInvalid(
                    "State %s can't be absorbed into a neighbor because "
                    'it is disconnected.' % s)
            labels[s] = -1     # empty row: drop the state entirely
            continue

        dest = int(neighbors.argmax())
        fold_into(dest, s, diag_mass)
        labels = renumberMap(labels, labels[s])
        labels[s] = labels[dest]

    return c, labels


def baysean_prune(c, n_procs=1, factor=np.log(3)):
    """Absorb states whose evidence of distinctness from a uniform
    pseudo-state falls below ``factor``. (reference: bace.py:310)

    Returns ``(c, labels, kept_states)``.
    """
    dense = not scipy.sparse.issparse(c)
    c_arr = np.asarray(c.todense() if not dense else c, dtype=np.float64)
    n = c_arr.shape[0]

    w = c_arr.sum(axis=1) + 1
    pseud = np.full(n, 1.0 / n, dtype=np.float64)
    unmerged = np.ones(n, dtype=np.int8)

    c2 = c_arr + np.outer(unmerged, unmerged) / n
    d = _merge_bayes_factors(pseud, 1.0, c2, w)

    statesPrune = np.where(d < factor)[0]
    statesKeep = np.where(d >= factor)[0]

    c_out, labels = absorb(c if not dense else c_arr, statesPrune)
    return c_out, labels, statesKeep


@cite('bace')
def bace(c, n_macrostates, chunk_size=100, n_procs=1):
    """Coarse-grain a counts matrix down to ``n_macrostates``.
    (reference: bace.py:45)

    Returns
    -------
    bayes_factors : dict  {n_macrostates_at_step: bayes_factor}
    labels : dict {n_macrostates: (n_states,) micro->macro labels}
    """
    logger.info('Checking for states with insufficient statistics')
    c, state_map, statesKeep = baysean_prune(c, n_procs)
    if scipy.sparse.issparse(c):
        c = np.asarray(c.todense(), dtype=np.float64)
    else:
        c = np.asarray(c, dtype=np.float64)
    n = c.shape[0]
    logger.info('Merged %d states with insufficient statistics into '
                'their kinetically-nearest neighbor',
                n - len(statesKeep))

    w = c.sum(axis=1)
    w[statesKeep] += 1

    unmerged = np.zeros(n, dtype=np.float64)
    unmerged[statesKeep] = 1

    bayes_factors = {}
    labels = {}

    # inverted Bayes factor matrix: larger = more similar
    dMat = np.zeros((n, n), dtype=np.float64)

    def profile(i, keep):
        return c[i, keep] + unmerged[i] * unmerged[keep] / n

    def recalc(states, single=None):
        """(Re)fill dMat rows for the given source states against
        their >1-count partners."""
        keep = statesKeep
        for s in states:
            dest = np.where(c[s, :] > 1)[0]
            if single is not None:
                dest = dest[dest != single]
            else:
                dest = dest[dest > s]
            if len(dest) == 0:
                continue
            c1 = profile(s, keep)
            # one gather for all destination profiles (a per-row
            # profile() loop + stack cost ~3 s of a 600-state run)
            c2 = (c[np.ix_(dest, keep)]
                  + np.outer(unmerged[dest], unmerged[keep]) / n)
            d = _merge_bayes_factors(c1, w[s], c2, w[dest])
            with np.errstate(divide='ignore'):
                dMat[s, dest] = 1.0 / d

    recalc(statesKeep)

    def find_min_pair():
        indMin = dMat.argmax()
        minX, minY = np.unravel_index(indMin, dMat.shape)
        bayes_factors[statesKeep.shape[0] - 1] = 1. / dMat[minX, minY]
        return int(minX), int(minY)

    minX, minY = find_min_pair()

    logger.info('Coarse-graining...')
    for cycle in range(n - n_macrostates):
        # fold the pseudo-count row into states being merged
        for m in (minX, minY):
            if unmerged[m]:
                c[m, statesKeep] += unmerged[statesKeep] / n
                c[statesKeep, m] += unmerged[statesKeep] / n
                unmerged[m] = 0

        c[minX, statesKeep] += c[minY, statesKeep]
        c[statesKeep, minX] += c[statesKeep, minY]
        c[statesKeep, minY] = 0
        c[minY, statesKeep] = 0
        dMat[minX, :] = dMat[:, minX] = 0
        dMat[minY, :] = dMat[:, minY] = 0

        w[minX] += w[minY]
        w[minY] = 0
        statesKeep = statesKeep[statesKeep != minY]

        indChange = np.where(state_map == state_map[minY])[0]
        state_map = renumberMap(state_map, state_map[minY])
        state_map[indChange] = state_map[minX]

        recalc([minX], single=minX)
        minX, minY = find_min_pair()

        labels[n - cycle - 1] = state_map.astype(int).copy()

    return bayes_factors, labels
