"""Device MSM tail for the transpose builder (counterpart of
``transpose_timescales_device`` in ``enspara_tpu/msm/eigen_device.py``).

A reversible T (detailed balance against pi) is similar to the
symmetric ``S = D^{1/2} T D^{-1/2}`` with ``D = diag(pi)``, so its
spectrum comes from a symmetric eigensolve, and the left eigenvectors
of T are ``phi_i = D^{1/2} u_i``.
"""

import numpy as np
import torch

from ..util.device import resolve_device

__all__ = ['transpose_timescales_device']


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
    count matrix, computed on ``device`` (default: where ``counts``
    lies); only the ``n_eigs`` modes cross to the host.

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
