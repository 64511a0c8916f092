"""Synthetic MSM data (counterpart of ``enspara_tpu/msm/synthetic_data.py``;
reference: enspara/msm/synthetic_data.py): block-metastable sparse
counts, the host kinetic Monte Carlo chain, the device KMC over many
chains and the host ensemble evolution.
"""

import numpy as np
import scipy.sparse
import scipy.sparse.linalg
import torch

from .. import exception
from ..util.device import resolve_device

__all__ = ['synthetic_trajectory', 'synthetic_ensemble',
           'synthetic_trajectory_device', 'sparse_metastable_counts']


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


def synthetic_trajectory_device(T, start_states, n_steps, generator=None):
    """Vectorized kinetic Monte Carlo on a device (counterpart of
    ``enspara_tpu/msm/synthetic_data.py:101-135``): simulate
    ``len(start_states)`` independent chains of ``n_steps`` states each.

    The chains run on ``generator``'s device; without one, on the device
    of ``T`` when it is a tensor, else on the card (see
    :func:`~enspara_tpu_torch.util.device.resolve_device`), with a
    generator seeded 0 there. All uniforms are drawn up front,
    ``(n_steps - 1, n_chains)`` (the JAX package takes a PRNG key
    instead, so the streams differ). Each step gathers the chains' rows
    of the float64 per-row CDFs of T and takes ``searchsorted`` of the
    uniform scaled by the row's total, clamped to the row's last
    positive entry: every step follows an edge with ``T > 0``.

    Parameters
    ----------
    T : (n_states, n_states) row-stochastic matrix (dense or scipy sparse).
    start_states : (n_chains,) int array.
    generator : torch.Generator on the device the chains run on.

    Returns
    -------
    (n_chains, n_steps) int32 array of state sequences; column 0 is
    ``start_states``.
    """
    if generator is not None:
        dev = generator.device
    else:
        dev = resolve_device(T)
        generator = torch.Generator(device=dev).manual_seed(0)
    rows = T.toarray() if scipy.sparse.issparse(T) else T
    P = torch.as_tensor(rows, device=dev).to(torch.float64)
    n_states = P.shape[0]
    cdf = torch.cumsum(P, dim=1)
    total = cdf[:, -1]
    positive = P > 0
    # the last column with T > 0 of each row (0 for a row without one)
    last = torch.where(positive, torch.arange(n_states, device=dev),
                       0).amax(dim=1)

    state = torch.as_tensor(np.asarray(start_states), device=dev).to(
        torch.int64).reshape(-1)
    u = torch.rand((max(n_steps - 1, 0), state.shape[0]), generator=generator,
                   device=dev, dtype=torch.float64)
    path = [state]
    for k in range(u.shape[0]):
        nxt = torch.searchsorted(cdf[state], (u[k] * total[state])[:, None],
                                 right=True)[:, 0]
        state = torch.minimum(nxt, last[state])
        path.append(state)
    chain = torch.stack(path, dim=1)[:, :n_steps]
    # a state with no outgoing probability mass cannot be sampled from
    stuck = (total[chain[:, :-1]] <= 0).nonzero()
    if stuck.shape[0]:
        raise exception.DataInvalid(
            'Transition matrix row %d has zero total probability; cannot '
            'continue the synthetic trajectory from it.'
            % int(chain[stuck[0, 0], stuck[0, 1]]))
    return chain.to(torch.int32).cpu().numpy()


def synthetic_ensemble(T, init_pops, n_steps, observable_per_state=None):
    """Evolve populations p <- p T for n_steps; optionally project onto
    a per-state observable. (counterpart of
    ``enspara_tpu/msm/synthetic_data.py:138-158``, host code; reference:
    synthetic_data.py:49)"""
    if scipy.sparse.issparse(T):
        T_op = scipy.sparse.linalg.aslinearoperator(T.tocsr())
    else:
        T_op = scipy.sparse.linalg.aslinearoperator(np.asarray(T))

    p = np.asarray(init_pops, dtype=float).copy()
    if observable_per_state is not None:
        observations = [p.dot(observable_per_state)]
        for _ in range(n_steps - 1):
            p = T_op.rmatvec(p)
            observations.append(p.dot(observable_per_state))
    else:
        observations = [p]
        for _ in range(n_steps - 1):
            p = T_op.rmatvec(p)
            observations.append(p)

    return p, np.array(observations)
