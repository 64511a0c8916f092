"""Plain MSM tail for the reference: lag-pair counts and the implied
timescales of the transpose-symmetrized MSM.

Counts pair ``a[t]`` with ``a[t + lag]`` inside each trajectory (the
sliding window). The transpose estimate takes ``T = rownorm(C + C^T)``,
which is reversible with ``pi`` the row sums of ``C + C^T``; its
eigenvalues are those of the symmetric ``C_sym_ij / sqrt(r_i r_j)``.
Implied timescales are ``-lag / ln(lambda_i)`` of the eigenvalues after
the stationary one, largest first. Float64 throughout; the control
rounds the symmetrized matrix to ``dtype`` first.
"""

import numpy as np
import torch


def counts(assigns, lengths, lag, n_states, device):
    """``(n_states, n_states)`` int64 lag-pair counts of the concatenated
    assignments ``assigns`` split into trajectories of ``lengths``."""
    a = torch.as_tensor(np.asarray(assigns), device=device).long()
    total = torch.zeros(n_states * n_states, dtype=torch.long, device=device)
    lo = 0
    for n in lengths:
        seg = a[lo:lo + n]
        if n > lag:
            total += torch.bincount(seg[:-lag] * n_states + seg[lag:],
                                    minlength=n_states * n_states)
        lo += n
    return total.reshape(n_states, n_states)


def eigenvalues(C, n_eigs, dtype=torch.float64):
    """The ``n_eigs`` largest eigenvalues of the transpose-symmetrized T of
    ``C`` (descending), from the symmetric form in float64; ``dtype``
    other than float64 rounds that form to it first (the control)."""
    Cs = C.to(torch.float64)
    Cs = Cs + Cs.T
    r = Cs.sum(dim=1)
    inv = torch.where(r > 0, 1.0 / torch.sqrt(torch.where(r > 0, r, 1.0)),
                      0.0)
    S = inv[:, None] * Cs * inv[None, :]
    if dtype != torch.float64:
        S = S.to(dtype).to(torch.float32)
        S = 0.5 * (S + S.T)
    w = torch.linalg.eigvalsh(S)
    return w.flip(0)[:n_eigs].to(torch.float64)


def timescales(C, lag, n_times, dtype=torch.float64):
    """``n_times`` implied timescales of the transpose-symmetrized MSM."""
    w = eigenvalues(C, n_times + 1, dtype)[1:]
    return (-float(lag) / torch.log(w)).cpu().numpy()


def relative_gap(program, reference):
    """Largest ``|p - r| / |r|`` over the entries; equal NaNs agree, a
    NaN on one side only is an infinite gap."""
    p = np.asarray(program, np.float64)
    r = np.asarray(reference, np.float64)
    if p.shape != r.shape:
        return float('inf')
    both = np.isnan(p) & np.isnan(r)
    one = np.isnan(p) ^ np.isnan(r)
    if one.any():
        return float('inf')
    with np.errstate(divide='ignore', invalid='ignore'):
        gap = np.where(both, 0.0, np.abs(p - r) / np.abs(r))
    return float(np.max(gap)) if gap.size else 0.0
