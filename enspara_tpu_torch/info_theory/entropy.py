"""Entropies, divergences and MSM relative entropy (counterpart of
``enspara_tpu/info_theory/entropy.py``; reference:
enspara/info_theory/entropy.py). Host numpy and scipy.

Formulated on :mod:`scipy.special`'s exactly-zero-handling primitives
(``rel_entr``, ``xlogy``) rather than masked ``log`` arithmetic — the
x·log x = 0 limit at x = 0 is handled by the primitive itself, so no
NaN patching or warning suppression is needed.
"""

import warnings

import numpy as np
from scipy.special import rel_entr, softmax, xlogy

from .. import exception
from ..msm import builders
from ..msm.transition_matrices import eq_probs, assigns_to_counts

__all__ = ['Q_from_assignments', 'relative_entropy_per_state',
           'relative_entropy_msm', 'energy_to_probability',
           'shannon_entropy', 'kl_divergence', 'js_divergence']


def shannon_entropy(p, normalize=True):
    """Shannon entropy (in nats) of a distribution of any shape.

    With ``normalize=True`` the input is scaled to unit mass first
    (without mutating the caller's array).
    """
    dist = np.array(p, dtype=np.float64)
    if normalize:
        dist = dist / dist.sum()
    return -xlogy(dist, dist).sum()


def kl_divergence(P, Q, base=2):
    """Kullback–Leibler divergence D(P‖Q) in units of log-``base``.

    1-D inputs give a scalar; 2-D inputs are treated as stacks of
    distributions (one per row) and give a vector of row divergences.
    Cells with P = 0 contribute zero regardless of Q (the x·log x
    limit); cells with P > 0 and Q = 0 contribute +inf.
    """
    P, Q = np.asarray(P, dtype=float), np.asarray(Q, dtype=float)
    if P.shape != Q.shape:
        raise exception.DataInvalid(
            'P and Q must have the same shape; got %s and %s'
            % (P.shape, Q.shape))
    if (P < 0).any() or (Q < 0).any():
        bad = P if (P < 0).any() else Q
        raise exception.DataInvalid(
            'The supplied matrix contained a negative '
            'probability:\n%s' % bad)

    # rel_entr(p, q) = p*log(p/q) with the 0-limits built in
    return rel_entr(P, Q).sum(axis=-1) / np.log(base)


def js_divergence(p, q):
    """Jensen–Shannon divergence (bits): symmetrized KL of each input
    against their even mixture."""
    p, q = np.asarray(p, float), np.asarray(q, float)
    mix = (p + q) / 2
    both = rel_entr(p, mix).sum(axis=-1) + rel_entr(q, mix).sum(axis=-1)
    return both / (2 * np.log(2))


def energy_to_probability(u, kT=2.479):
    """Boltzmann-weight free energies ``u`` (kJ/mol) into populations.

    softmax(-u/kT) — shift-invariance makes any baseline choice (mean,
    max, ...) equivalent.
    """
    return softmax(np.asarray(u, dtype=float) / -kT)


def Q_from_assignments(assignments, n_states=None, lag_time=1,
                       builder=builders.normalize, prior_counts=None):
    """Estimate the comparison matrix Q for relative-entropy work
    directly from state assignments.

    The default pseudocount is one observation spread over the whole
    dataset (1 / total transition count), which keeps every Q cell
    positive so D(P‖Q) stays finite.
    """
    if prior_counts is None:
        n_transitions = sum(len(traj) - 1 for traj in assignments)
        prior_counts = 1.0 / n_transitions

    counts = assigns_to_counts(assignments, max_n_states=n_states,
                               lag_time=lag_time)
    dense = np.asarray(counts.todense(), dtype=float) + prior_counts

    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        probs = builder(dense, calculate_eq_probs=False)[1]
    return probs


def relative_entropy_per_state(P, Q=None, assignments=None, weights=1,
                               state_subset=None, base=2.0, **kwargs):
    """Per-state relative entropy: D(P(i)‖Q(i)) for each row i,
    optionally weighted and restricted to ``state_subset``.

    Q may be given directly or estimated from ``assignments`` via
    :func:`Q_from_assignments` (kwargs forwarded).
    """
    if Q is None:
        if assignments is None:
            raise exception.ImproperlyConfigured(
                'must specify Q or calculate Q from assignments')
        Q = Q_from_assignments(assignments, n_states=P.shape[0],
                               **kwargs)

    row_divs = kl_divergence(P, Q, base=base)
    if state_subset is not None:
        row_divs = row_divs[state_subset]
    return row_divs * weights


def relative_entropy_msm(P, Q=None, assignments=None, populations=None,
                         state_subset=None, base=2.0, **kwargs):
    """Total relative entropy between MSMs:
    D(P‖Q) = Σ_i π_i · D(P(i)‖Q(i)), with π the stationary
    distribution of the reference matrix P (renormalized over the
    subset when one is given).
    """
    per_state = relative_entropy_per_state(
        P, Q=Q, assignments=assignments, state_subset=state_subset,
        base=base, **kwargs)

    if populations is None:
        pi = eq_probs(P)
        if state_subset is not None:
            pi = pi[state_subset]
        populations = pi / pi.sum()

    return float(np.asarray(populations) @ per_state)
