"""Reactive fluxes and populations from transition path theory
(counterpart of ``enspara_tpu/tpt/tpt.py``, host code; capability parity
with enspara/tpt/tpt.py). For an equilibrium MSM the
flux of A->B reactive trajectories through edge (i, j) factorizes into
independent row and column weights around T:

    f_ij = [pi_i q-_i] * T_ij * [q+_j],   q- = 1 - q+

so both the dense and sparse paths here apply one row-vector and one
column-vector scaling; the sparse path stays O(nnz) throughout (the
net-flux clip happens in CSR data, never through a dense mask).
"""

import numpy as np
from scipy import sparse

from .core import committors
from ..msm.transition_matrices import eq_probs

__all__ = ['reactive_fluxes', 'net_fluxes', 'reactive_populations']


def _flux_ingredients(tprob, populations, sources, sinks):
    """Stationary distribution and forward committors for a TPT query
    (the reverse committors are ``1 - q+`` at equilibrium)."""
    if populations is None:
        pi = eq_probs(tprob)
    else:
        pi = np.asarray(populations)
    q_fwd = committors(tprob, np.ravel(sources), np.ravel(sinks))
    return pi, q_fwd


def reactive_fluxes(tprob, sources, sinks, populations=None):
    """Flux of reactive (A->B) trajectories along every edge,
    f_ij = pi_i q-_i T_ij q+_j with a zeroed diagonal.

    Sparse input gives a LIL matrix back; anything else gives an
    ndarray.
    """
    pi, q_fwd = _flux_ingredients(tprob, populations, sources, sinks)
    src_weight = pi * (1.0 - q_fwd)        # pi_i * q-_i, per row

    if sparse.issparse(tprob):
        flux = tprob.multiply(src_weight[:, None]) \
                    .multiply(q_fwd).tolil()
        flux.setdiag(0.0)
    else:
        flux = np.asarray(tprob) * np.outer(src_weight, q_fwd)
        np.fill_diagonal(flux, 0.0)
    return flux


def net_fluxes(tprob, sources, sinks, populations=None):
    """Net flux per edge: max(f - fᵀ, 0).

    The sparse path clips in CSR data directly — O(nnz), never
    materializing the dense matrix (the reference masks a lil matrix
    with a dense boolean array, tpt/tpt.py:94+).
    """
    gross = reactive_fluxes(tprob, sources, sinks, populations)
    if not sparse.issparse(gross):
        out = gross - gross.T
        np.clip(out, 0.0, None, out=out)
        return out
    csr = gross.tocsr()
    out = (csr - csr.T).tocsr()
    out.data[out.data < 0] = 0.0
    out.eliminate_zeros()
    return out.tolil()          # container parity with the reference


def reactive_populations(tprob, sources, sinks, populations=None):
    """Probability that state i lies on a reactive A->B path at any
    instant: proportional to pi_i q+_i q-_i."""
    pi, q_fwd = _flux_ingredients(tprob, populations, sources, sinks)
    on_path = pi * q_fwd * (1.0 - q_fwd)
    return on_path / on_path.sum()
