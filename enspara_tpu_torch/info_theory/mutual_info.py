"""Mutual-information machinery: MI matrices, weighted MI, NMI/APC
normalizations, network deconvolution (counterpart of
``enspara_tpu/info_theory/mutual_info.py``; reference:
enspara/info_theory/mutual_info.py).

The joint counts are one-hot products on the device
(:mod:`.libinfo`); the MI itself is float64 numpy on the host, as in the
JAX package. ``weighted_mi`` forms its weighted joint distribution as a
float64 one-hot product on the device at every size.
"""

import warnings

import numpy as np
import torch

from .. import exception
from ..util.device import resolve_device
from . import libinfo

__all__ = ['mi_matrix', 'weighted_mi', 'mi_matrix_serial', 'joint_counts',
           'mutual_information', 'mi_to_nmi_apc', 'deconvolute_network',
           'mi_to_nmi', 'mi_to_apc', 'channel_capacity_normalization',
           'check_features_states']


def mi_matrix(Xs, Ys, n_x, n_y, normalize=True, mesh=None, device=None):
    """All-pairs MI across trajectories of assigned (discretized)
    features. With ``mesh``, joint counting shards the frame axis over
    the mesh (see ``libinfo.matrix_bincount2d``).
    (capability match: mutual_info.py:23)"""
    hi_x, hi_y = int(np.max(n_x)), int(np.max(n_y))

    total = None
    for k, (X, Y) in enumerate(zip(Xs, Ys)):
        block = joint_counts(X, Y, hi_x, hi_y, mesh=mesh, device=device)
        if total is None:
            total = block.astype(np.int64)
            continue
        if total.shape != block.shape:
            raise exception.DataInvalid(
                'joint-count block %d has shape %s where %s was '
                'expected -- do all trajectories carry the same '
                'feature set?' % (k, block.shape, total.shape))
        total += block

    mi = mutual_information(total)
    if normalize:
        return channel_capacity_normalization(mi, n_x, n_y)
    return mi


def joint_counts(X, Y=None, n_x=None, n_y=None, mesh=None, device=None):
    """Joint counts of all feature pairs: (Fa, Fb, n_x, n_y).
    (reference: mutual_info.py:212)"""
    if not hasattr(X, 'shape'):
        X = np.asarray(X)
    if Y is not None and not hasattr(Y, 'shape'):
        Y = np.asarray(Y)
    if len(X.shape) == 1:
        X = X[..., None]
    if Y is not None and len(Y.shape) == 1:
        Y = Y[..., None]

    if n_x is None:
        n_x = int(X.max()) + 1

    if Y is None:
        if n_y is not None:
            warnings.warn('n_y unused if Y is None.')
        return libinfo.matrix_bincount2d(X, X, n_x, n_x, mesh=mesh,
                                         device=device)

    if n_y is None:
        n_y = int(Y.max()) + 1
    return libinfo.matrix_bincount2d(X, Y, n_x, n_y, mesh=mesh,
                                     device=device)


def mutual_information(jc):
    """MI of a 4-D array of joint count matrices -> (Fa, Fb), float64.
    (reference: mutual_info.py:272, devectorized there)"""
    jc = _require_4d_joint_counts(jc).astype(np.float64)

    n_obs_a = jc.sum(axis=-1)             # (Fa, Fb, n_x)
    n_obs_b = jc.sum(axis=-2)             # (Fa, Fb, n_y)
    n_obs = n_obs_a.sum(axis=-1)          # (Fa, Fb)

    denom = np.where(n_obs > 0, n_obs, 1.0)
    P_a = n_obs_a / denom[..., None]
    P_b = n_obs_b / denom[..., None]
    P_ab = jc / denom[..., None, None]

    prod = P_a[..., :, None] * P_b[..., None, :]
    valid = (P_ab > 0) & (prod > 0)
    ratio = np.divide(P_ab, prod, where=valid,
                      out=np.ones_like(P_ab))
    terms = P_ab * np.log(ratio, where=valid, out=np.zeros_like(P_ab))
    return np.where(valid, terms, 0.0).sum(axis=(-1, -2))


def mi_matrix_serial(states_a_list, states_b_list, n_a_states,
                     n_b_states, normalize=True):
    """Feature-pair-at-a-time MI on the host (the testing reference).
    (reference: mutual_info.py:186)"""
    n_traj = len(states_a_list)
    n_features = states_a_list[0].shape[1]
    mi = np.zeros((n_features, n_features))

    for i in range(n_features):
        for j in range(i, n_features):
            jc = libinfo.bincount2d(
                states_a_list[0][:, i], states_b_list[0][:, j],
                n_a_states[i], n_b_states[j]).astype(np.int64)
            for k in range(1, n_traj):
                jc += libinfo.bincount2d(
                    states_a_list[k][:, i], states_b_list[k][:, j],
                    n_a_states[i], n_b_states[j])
            mi[i, j] = mutual_information(jc[None, None])[0, 0]
            mi[j, i] = mi[i, j]

    if normalize:
        mi = channel_capacity_normalization(mi, n_a_states, n_b_states)
    return mi


def _exact_parts(w):
    """float64 weights ``w`` (>= 0) as three parts that sum to ``w``
    exactly: two on the grids ``2^(e-30)`` and ``2^(e-60)``
    (``2^e >= sum(w)``), where every partial sum of fewer than 2^23 terms,
    in any order, is exact, and a remainder below ``2^(e-61)``."""
    e = int(np.ceil(np.log2(max(float(w.sum()), np.finfo(float).tiny))))
    parts, r = [], w
    for g in (e - 30, e - 60):
        q = np.ldexp(np.rint(np.ldexp(r, -g)), g)
        parts.append(q)
        r = r - q
    return parts + [r]


def weighted_joint(features, weights, s_max, device=None):
    """``P[u, v, i, j] = sum_t w_t [x_ti == u] [x_tj == v]``, (s_max,
    s_max, F, F) float64 numpy: float64 one-hot products on ``device``
    (default: the card), a chunk of frames at a time.

    The weights are summed in the three parts of :func:`_exact_parts`, the
    two on grids exactly, so that the result does not depend on the order
    of the sums: the card's products give the CPU's bits (affinity
    propagation over the MI turns last-bit differences of near ties into
    other labels)."""
    dev = resolve_device(features, device)
    X = libinfo.as_label_tensor(features)
    parts = [torch.as_tensor(p, device=dev)
             for p in _exact_parts(np.asarray(weights, np.float64))]
    T, F = X.shape
    chunk = libinfo.chunk_frames(2 * F * s_max)
    P = torch.zeros((3, F * s_max, F * s_max), dtype=torch.float64,
                    device=dev)
    for lo in range(0, T, chunk):
        O = libinfo.onehot(X[lo:lo + chunk].to(dev), s_max, torch.float64)
        for k, w in enumerate(parts):
            P[k] += (O * w[lo:lo + chunk, None]).T @ O
    P = (P[0] + P[1]) + P[2]
    return P.reshape(F, s_max, F, s_max).permute(1, 3, 0, 2).cpu().numpy()


def weighted_mi(features, weights, n_feature_states=None, normalize=True,
                device=None):
    """MI matrix of weighted observations from the weighted joint
    distribution ``(onehot(X) * w)ᵀ @ onehot(X)``, computed in float64 on
    ``device`` (default: the card).
    (reference: mutual_info.py:78; matmul form :149-153)"""
    features = np.asarray(features)
    if weights is None:
        # uniform weighting (the documented exposons_from_sasas
        # contract: "If None, frames will be weighted equally",
        # reference exposons.py:100-103)
        weights = np.full(features.shape[0],
                          1.0 / max(features.shape[0], 1))
    weights = np.array(weights, dtype=np.float64, copy=True)

    assert features.ndim == 2
    assert weights.ndim == 1
    assert np.all(weights >= 0)

    if weights.shape[0] != features.shape[0]:
        raise exception.DataInvalid(
            "The number of features (%s in array with shape %s) didn't "
            'match the number of weights (%s)'
            % (features.shape[0], features.shape, weights.shape[0]))

    if weights.sum() != 1:
        weights = weights / np.linalg.norm(weights, ord=1)

    if n_feature_states is None:
        n_feature_states = np.full(features.shape[1],
                                   features.max() + 1, dtype='int16')
    else:
        n_feature_states = np.array(n_feature_states)

    if n_feature_states.shape[0] != features.shape[1]:
        raise exception.DataInvalid(
            'The length of feature states number vector (%s) must equal '
            'the number of features given (%s)'
            % (n_feature_states.shape[0], features.shape[1]))

    s_max = int(max(n_feature_states))
    P_joint = weighted_joint(features, weights, s_max, device)
    return weighted_mi_from_joint(P_joint, features, weights,
                                  n_feature_states, normalize)


def weighted_mi_from_joint(P_joint, features, weights, n_feature_states,
                           normalize=True):
    """The MI matrix of ``weighted_mi`` from its joint distribution
    ``P_joint`` (s_max, s_max, F, F) on the host, float64."""
    n_feat = features.shape[1]
    s_max = P_joint.shape[0]
    P_marg = np.vstack([
        np.bincount(features[:, i], weights=weights, minlength=s_max)
        for i in range(n_feat)])   # (n_feat, s_max)

    P_prod = (P_marg.T[:, None, :, None]       # u, -, i, -
              * P_marg.T[None, :, None, :])    # -, v, -, j

    mi_mats = np.zeros_like(P_joint)
    np.divide(P_joint, P_prod, where=(P_prod != 0), out=mi_mats)
    np.log(mi_mats, where=mi_mats != 0, out=mi_mats)
    np.multiply(P_joint, mi_mats, out=mi_mats)

    assert not np.any(np.isnan(mi_mats))
    mi_mtx = mi_mats.sum(axis=(0, 1))
    assert not np.any(np.isinf(mi_mtx))

    if normalize:
        mi_mtx = channel_capacity_normalization(
            mi_mtx, n_feature_states, n_feature_states)
    np.clip(mi_mtx, a_min=0, a_max=np.inf, out=mi_mtx)
    return mi_mtx


def mi_to_nmi_apc(mutual_information, H_marginal=None):
    """NMI-APC score of Lopez et al. 2017: (MI - APC) / H_joint.

    H_joint is recovered from the NMI itself (NMI = MI / H_joint, so
    H_joint = MI / NMI); cells where it degenerates to 0/0 are defined
    as carrying no information.
    """
    _require_square_symmetric(mutual_information)
    mi = np.asarray(mutual_information, dtype=np.float64)

    nmi = mi_to_nmi(mi, H_marginal)
    with np.errstate(divide='ignore', invalid='ignore'):
        pair_H = mi / nmi
        score = (mi - mi_to_apc(mi)) / pair_H
    return np.where(np.isnan(score), 0.0, score)


def deconvolute_network(G_obs):
    """Network deconvolution (Feizi et al. 2013).

    Solves G_obs = G_dir + G_dir^2 + ... for the direct network: in the
    eigenbasis of G_obs each eigenvalue shrinks as v -> v / (1 + v).
    """
    lam, V = np.linalg.eig(G_obs)
    shrunk = lam / (lam + 1.0)
    return (V * shrunk) @ np.linalg.inv(V)


def mi_to_nmi(mutual_information, H_marginal=None):
    """Normalized MI: NMI(i,j) = MI(i,j) / H_joint(i,j), with
    H_joint(i,j) = H_i + H_j - MI(i,j) from the marginal entropies
    (taken from the MI diagonal when not given)."""
    _require_square_symmetric(mutual_information)
    # a copy: the caller's matrix stays as it was
    mi = np.array(mutual_information, dtype=np.float64)

    if H_marginal is None:
        H_marginal = np.diag(mi).copy()
    H_marginal = np.asarray(H_marginal)

    if (H_marginal == 0).any():
        warnings.warn('H_marginal contains zero entries. This may lead '
                      'to negative information.')
    if H_marginal.shape[0] != mi.shape[0]:
        raise exception.DataInvalid(
            'need one marginal entropy per feature: %d marginals for a '
            '%d-feature MI matrix' % (H_marginal.shape[0], mi.shape[0]))
    if np.isnan(H_marginal).any() or not H_marginal.any():
        raise exception.DataInvalid(
            'marginal entropies must be nan-free and not all zero; got '
            '%s' % (H_marginal,))

    np.fill_diagonal(mi, H_marginal)
    pair_H = np.add.outer(H_marginal, H_marginal) - mi
    with np.errstate(divide='ignore', invalid='ignore'):
        nmi = mi / pair_H

    np.fill_diagonal(nmi, 1.0)
    return np.where(np.isnan(nmi), 0.0, nmi)


def mi_to_apc(mi_arr):
    """Average product correction of Dunn et al. 2008:
    APC(i,j) = sum_r MI(i,r) MI(j,r) / n^2, i.e. (MI @ MI) / n^2."""
    _require_square_symmetric(mi_arr)
    scaled = np.asarray(mi_arr) / len(mi_arr)
    return scaled @ scaled


def channel_capacity_normalization(mi, n_x, n_y):
    """Scale each MI cell by its channel capacity, the log of the
    smaller alphabet of the pair (orientation follows the reference:
    cell (i, j) is capped by min(n_x[j], n_y[i]))."""
    rows = _require_alphabet_sizes(n_x, np.shape(mi)[0])
    cols = _require_alphabet_sizes(n_y, np.shape(mi)[1])

    cap = np.minimum(rows[None, :], cols[:, None])
    return np.asarray(mi, dtype=np.float64) / np.log(cap)


def check_features_states(states, n_states):
    """Sanity-check that every trajectory of assigned features is as
    wide as the number-of-states vector."""
    widths = [len(traj[0]) for traj in states]
    if widths[0] != len(n_states):
        raise exception.DataInvalid(
            'number-of-states vector has %d entries but the state '
            'assignments are %d features wide' % (len(n_states),
                                                  widths[0]))
    if len(set(widths)) != 1:
        raise exception.DataInvalid(
            'feature count differs across trajectories: widths were %s'
            % (widths,))


def _require_4d_joint_counts(jc):
    jc = np.asarray(jc)
    if jc.ndim != 4:
        hint = (' -- a single joint-counts matrix can be lifted with '
                'jc[None, None, ...]' if jc.ndim == 2 else '')
        raise exception.DataInvalid(
            'joint counts must be 4-D (f_a, f_b, s_a, s_b); got '
            '%d-D%s' % (jc.ndim, hint))
    return jc


def _require_square_symmetric(mi):
    shape = np.shape(mi)
    if len(shape) != 2:
        raise exception.DataInvalid(
            'an MI matrix is 2-D; this array is %d-D' % len(shape))
    if shape[0] != shape[1]:
        raise exception.DataInvalid(
            'an MI matrix is square; this one is %s' % (shape,))
    if not np.allclose(np.transpose(mi), mi):
        raise exception.DataInvalid('an MI matrix is symmetric')


def _require_alphabet_sizes(n, mi_dim):
    n = np.asarray(n)
    if n.ndim == 0:
        n = np.repeat(n, mi_dim)

    if (n < 2).any():
        raise exception.DataInvalid(
            'channel capacity is undefined for features with fewer '
            'than 2 states; alphabet sizes were %s' % (n,))
    if n.shape[0] != mi_dim:
        raise exception.DataInvalid(
            'need one alphabet size per feature: got %d sizes for MI '
            'dimension %d' % (n.shape[0], mi_dim))
    if not np.issubdtype(n.dtype, np.integer):
        raise exception.DataInvalid(
            'alphabet sizes must be integers (dtype was %s)' % n.dtype)
    return n
