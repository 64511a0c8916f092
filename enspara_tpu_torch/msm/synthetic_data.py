"""Synthetic MSM data (counterpart of ``enspara_tpu/msm/synthetic_data.py``,
host code; reference: enspara/msm/synthetic_data.py):
block-metastable sparse counts and the host kinetic Monte Carlo chain.
"""

import numpy as np
import scipy.sparse

from .. import exception

__all__ = ['synthetic_trajectory', 'sparse_metastable_counts']


def sparse_metastable_counts(n_states, n_blocks=25, seed=3,
                             extra_per_state=6):
    """Sparse symmetric counts matrix with realistic metastable MSM
    structure: ``n_blocks`` wells with fast intra-well mixing (chain
    backbone + random intra-block links) and weak, block-varying
    inter-well couplings. The resulting transition matrix has
    ``n_blocks`` eigenvalues clustered near 1, cleanly separated from
    the bulk — the spectral shape of real MSMs (used as the synthetic
    workload for BASELINE config-5 scale points; the reference has no
    generator for this, cf. enspara/msm/synthetic_data.py).

    Returns a symmetric ``scipy.sparse.csr_matrix`` of float counts
    with ``n_blocks * (n_states // n_blocks)`` states; feed it to a
    builder (e.g. ``builders.transpose``) for (T, pi).
    """
    rng = np.random.default_rng(seed)
    m = n_states // n_blocks
    n = m * n_blocks
    block = np.arange(n) // m

    # intra-block chain backbone (skip the last state of each block)
    i = np.arange(n - 1)
    keep = block[i] == block[i + 1]
    ij = [np.stack([i[keep], i[keep] + 1])]
    vals = [rng.integers(10, 30, keep.sum()).astype(float)]

    # random intra-block links -> expander within each well (fast
    # intra-well relaxation: the bulk sits well below the slow modes)
    ne = extra_per_state * n
    src = rng.integers(0, n, ne)
    dst = block[src] * m + rng.integers(0, m, ne)
    ij.append(np.stack([src, dst]))
    vals.append(rng.integers(5, 15, ne).astype(float))

    # weak inter-block couplings between consecutive wells, with
    # per-pair strengths varied so the slow eigenvalues are distinct
    for b in range(n_blocks - 1):
        nl = 3
        s = b * m + rng.integers(0, m, nl)
        d = (b + 1) * m + rng.integers(0, m, nl)
        ij.append(np.stack([s, d]))
        vals.append(np.full(nl, 0.05 * (1.0 + 0.7 * rng.random())))

    ij = np.concatenate(ij, axis=1)
    v = np.concatenate(vals)
    C = scipy.sparse.coo_matrix((v, (ij[0], ij[1])), shape=(n, n))
    return (C + C.T).tocsr()


def synthetic_trajectory(T, start_state, n_steps, random_state=None):
    """Kinetic Monte Carlo chain of ``n_steps`` states (including the
    start state) from row-stochastic T. (reference:
    synthetic_data.py:15)"""
    # per-row CDFs up front: each KMC step becomes one uniform draw +
    # binary search instead of an O(n_states) rng.choice
    rows = np.asarray(
        T.todense() if scipy.sparse.issparse(T) else T, dtype=float)
    cdf = np.cumsum(rows, axis=1)
    n_states = rows.shape[0]

    rng = np.random.default_rng(random_state)
    draws = rng.random(max(n_steps - 1, 0))

    path = np.empty(n_steps, dtype=int)
    path[0] = start_state
    for i, u in enumerate(draws):
        row_cdf = cdf[path[i]]
        # a state with no outgoing probability mass cannot be sampled
        # from — fail loudly rather than silently emitting a chain
        if row_cdf[-1] <= 0:
            raise exception.DataInvalid(
                'Transition matrix row %d has zero total probability; '
                'cannot continue the synthetic trajectory from it.'
                % int(path[i]))
        # scale by the row total so imperfectly-normalized rows still
        # sample proportionally
        path[i + 1] = min(
            np.searchsorted(row_cdf, u * row_cdf[-1], side='right'),
            n_states - 1)
    return path
