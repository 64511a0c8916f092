"""CARDS: Correlation of All Rotameric and Dynamical States (counterpart
of ``enspara_tpu/cards/cards.py``; reference: enspara/cards/cards.py).

Pipeline: rotamer featurization (the hysteresis scan on the device) ->
order/disorder segmentation (transition frames found on the device,
likelihood scoring on the host, the labels painted on the device) -> four
MI matrices (ss, dd, sd, ds) from one-hot joint counts on the device.
"""

import logging

import numpy as np
import torch

from ..citation import cite
from ..info_theory import mutual_info
from ..util.device import resolve_device
from . import disorder
from .featurizers import RotamerFeaturizer

logger = logging.getLogger(__name__)

__all__ = ['cards', 'cards_matrices']


@cite('cards')
def cards(trajectories, buffer_width=15, n_procs=1, mesh=None):
    """Structural, disorder, and cross MI matrices for all dihedral
    pairs across a set of trajectories. Returns
    ``(structural_mi, disorder_mi, struct_to_disorder_mi,
    disorder_to_struct_mi, atom_inds)``, float64 numpy. With ``mesh``,
    the MI joint counting shards the frame axis over the mesh.
    (reference: cards.py:17)"""
    featurizer = RotamerFeaturizer(
        buffer_width=buffer_width, n_procs=n_procs).fit(trajectories)
    mats = cards_matrices(featurizer.feature_trajectories_,
                          featurizer.n_feature_states_,
                          n_procs, mesh=mesh)
    return mats + (featurizer.atom_indices_,)


def _paint_labels_device(n_frames, n_features, starts, ends, feats,
                         device):
    """``disorder._paint_labels`` on ``device``: the +1/-1 segment
    boundaries are scattered into an int8 (n_frames + 1, n_features)
    grid and summed down the frames there, so the (T, F) labels are
    never built on the host or uploaded. Integer ops throughout: equal
    to the host painter bit for bit. Returns (n_frames, n_features) int8."""
    idx = np.concatenate([starts, ends]) * n_features \
        + np.concatenate([feats, feats])
    sgn = np.concatenate([np.ones(len(starts), np.int8),
                          -np.ones(len(ends), np.int8)])
    delta = torch.zeros((n_frames + 1) * n_features, dtype=torch.int8,
                        device=device)
    delta.index_add_(0, torch.as_tensor(idx, dtype=torch.int64,
                                        device=device),
                     torch.as_tensor(sgn, device=device))
    return torch.cumsum(delta.view(n_frames + 1, n_features)[:-1], dim=0,
                        dtype=torch.int8)


def _disorder_labels(feature_trajs, device):
    """Disorder labels of every trajectory on ``device`` and their state
    counts (always 2), as ``disorder.assign_order_disorder`` gives them:
    the transition frames found where the trajectories lie, the float64
    likelihood scoring on the host, the labels painted on the device."""
    n_features = feature_trajs[0].shape[1]
    transition_times, mean_ord, mean_disord = \
        disorder.transition_stats(feature_trajs)
    labels = [_paint_labels_device(
        trj.shape[0], n_features,
        *disorder._marked_segments(transition_times[i], mean_ord,
                                   mean_disord), device=device)
        for i, trj in enumerate(feature_trajs)]
    return labels, 2 * np.ones(n_features, dtype='int16')


def _stage(t, device):
    """A rotamer trajectory on ``device`` in its own integer width."""
    if not isinstance(t, torch.Tensor):
        t = np.asarray(t)
        t = torch.from_numpy(t if np.issubdtype(t.dtype, np.integer)
                             else t.astype(np.int32))
    return t.to(device)


@cite('cards')
def cards_matrices(feature_trajs, n_feature_states, n_procs=None,
                   mesh=None, device=None):
    """The four CARDS MI matrices from rotamer state trajectories, on
    ``device`` (default: where the first trajectory lies; host input
    goes to the card) or, with ``mesh``, on its shards: the labels are
    staged on the mesh's lead device and each joint-count chunk is cut
    over the shards. (reference: cards.py:61)"""
    if mesh is not None and device is not None:
        raise ValueError('pass device= or mesh=, not both')
    dev = mesh.lead if mesh is not None \
        else resolve_device(feature_trajs[0], device)
    # the rotamer states cross to the device once, for the transition
    # search and all four matrices
    staged = [_stage(t, dev) for t in feature_trajs]
    disordered, disorder_n_states = _disorder_labels(staged, dev)

    # the four MI channels: (row source, column source), where 's' is
    # the rotamer-state featurization and 'd' the disorder labels
    channel = {'s': (staged, n_feature_states),
               'd': (disordered, disorder_n_states)}
    mats = []
    for row_key, col_key in (('s', 's'), ('d', 'd'),
                             ('s', 'd'), ('d', 's')):
        logger.debug('Calculating %s->%s mutual information',
                     row_key, col_key)
        rows, n_rows = channel[row_key]
        cols, n_cols = channel[col_key]
        mats.append(mutual_info.mi_matrix(rows, cols, n_rows, n_cols,
                                          mesh=mesh))
    return tuple(mats)
