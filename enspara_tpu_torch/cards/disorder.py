"""Order/disorder segmentation of rotamer time series (counterpart of
``enspara_tpu/cards/disorder.py``; reference: enspara/cards/disorder.py).
Host numpy, but for the transition frames of trajectories that lie on a
device, which are found there.

A dihedral is 'disordered' during intervals where transitions are fast
relative to its ordered waiting time; segments between transitions are
labeled by a likelihood ratio (>= 3 favors disordered), scored in
float64 on the host: the compare decides labels, and an ``exp`` one ulp
away from numpy's could flip a segment.
"""

import numpy as np
import torch

from .. import ra

__all__ = ['transitions', 'traj_ord_disord_times',
           'create_disorder_traj', 'assign_order_disorder',
           'transition_stats', 'aggregate_mean_times']


def transitions(assignments):
    """Frames at which a state transition occurs. Accepts a 1-D array
    (returns the transition frames), a 2-D array, or a RaggedArray with
    unequal rows (returns a RaggedArray of per-row transition frames).
    (reference: disorder.py:9)"""
    if not isinstance(assignments, ra.RaggedArray):
        assignments = np.asarray(assignments)
        if assignments.ndim == 1:
            d = assignments[1:] - assignments[:-1]
            return np.where(d != 0)[0]
    # 2-D ndarray and ragged RA share one path: ra.where falls through
    # to np.where for plain ndarrays
    d = assignments[:, 1:] - assignments[:, :-1]
    rows, columns = ra.where(d != 0)
    lengths = np.bincount(np.asarray(rows, dtype=np.intp),
                          minlength=len(assignments))
    return ra.RaggedArray(columns, lengths=lengths)


def _feature_transitions(traj):
    """``[transitions(traj[:, j]) for j in range(n_features)]`` of one
    (n_frames, n_features) trajectory, found for all features at once:
    on its device for a tensor (ordered by feature there), on the host
    for an array."""
    if isinstance(traj, torch.Tensor):
        feat, frame = (i.cpu().numpy() for i in torch.nonzero(
            (traj[1:] != traj[:-1]).T, as_tuple=True))
    else:
        traj = np.asarray(traj)
        frame, feat = np.nonzero(traj[1:] != traj[:-1])
        order = np.argsort(feat, kind='stable')
        frame, feat = frame[order], feat[order]
    counts = np.bincount(feat, minlength=traj.shape[1])
    return np.split(frame, np.cumsum(counts)[:-1])


def traj_ord_disord_times(transition_times):
    """Ordered/disordered characteristic times from a single dihedral's
    transition frames, plus their frame weights.
    (reference: disorder.py:46)"""
    tt = np.asarray(transition_times)

    if tt.shape[0] == 0:
        return 0.0, 0.0, 0.0, 0.0

    if tt.shape[0] == 1:
        # a single event: triangular waiting-time sum, unnormalized
        # (matching the reference's single-transition convention)
        first = float(tt[0])
        return first * (first + 1.0) / 2, first, 0.0, 0.0

    gaps = np.diff(tt)
    # waiting times: start -> first event, then event -> event
    waits = np.concatenate([tt[:1], gaps]).astype(float)
    per_segment = waits * (waits + 1.0) / 2

    return (per_segment.sum() / waits.sum(),   # ordered time
            float(tt[-1]),                     # frames counting ordered
            gaps.mean(),                       # disordered time
            float(tt[-1] - tt[0]))             # frames counting disord.


def create_disorder_traj(transition_times, traj_len, ord_time,
                         disord_time):
    """Per-frame 0 (ordered) / 1 (disordered) labels for one dihedral.
    (reference: disorder.py:105)"""
    num_transitions = transition_times.shape[0]
    traj = np.zeros(traj_len)

    if num_transitions < 2:
        return traj

    seg_starts = transition_times[:-1]
    seg_ends = transition_times[1:]
    spans = seg_ends - seg_starts
    with np.errstate(all='ignore'):
        lr = (ord_time / disord_time
              * np.exp(-spans * (1. / disord_time - 1. / ord_time)))
    for start, end, ratio in zip(seg_starts, seg_ends, lr):
        if ratio >= 3.0:
            traj[start:end] = 1.
    return traj


def _marked_segments(transition_times, ord_times, disord_times):
    """Disordered segments of one trajectory across all features.

    Scores every inter-transition segment with the reference's
    likelihood ratio (float64 on host, bit-identical to the scalar
    loop, disorder.py:128-133) and returns the segments that are
    labeled disordered as flat ``(starts, ends, features)`` index
    arrays — the sparse form the label painters consume."""
    starts, ends, feats = [], [], []
    for j, tt in enumerate(transition_times):
        tt = np.asarray(tt)
        if tt.shape[0] < 2:
            continue
        s, e = tt[:-1], tt[1:]
        spans = e - s
        with np.errstate(all='ignore'):
            ot, dt = ord_times[j], disord_times[j]
            lr = ot / dt * np.exp(-spans * (1. / dt - 1. / ot))
        m = lr >= 3.0                   # nan compares False, as in the
        if m.any():                     # scalar loop
            starts.append(s[m])
            ends.append(e[m])
            feats.append(np.full(int(m.sum()), j, dtype=np.int64))

    if not starts:
        z = np.empty(0, dtype=np.int64)
        return z, z, z
    return (np.concatenate(starts), np.concatenate(ends),
            np.concatenate(feats))


def _paint_labels(n_frames, n_features, starts, ends, feats):
    """0/1 labels from marked segments via a +1/-1 boundary-delta
    cumsum. Segments within a feature are disjoint [start, end)
    intervals, so the running count is 0/1 and int8 is exact."""
    delta = np.zeros((n_frames + 1, n_features), dtype=np.int8)
    np.add.at(delta, (starts, feats), 1)
    np.add.at(delta, (ends, feats), -1)
    return np.cumsum(delta[:-1], axis=0, dtype=np.int8).astype('int16')


def assign_order_disorder(rotamer_trajs):
    """Disorder labels for every trajectory + the per-feature state
    counts (always 2). (reference: disorder.py:138)"""
    n_features = rotamer_trajs[0].shape[1]
    transition_times, mean_ord, mean_disord = transition_stats(
        rotamer_trajs)

    disordered_trajs = []
    for i, trj in enumerate(rotamer_trajs):
        seg = _marked_segments(transition_times[i], mean_ord, mean_disord)
        disordered_trajs.append(
            _paint_labels(trj.shape[0], n_features, *seg))

    disorder_n_states = 2 * np.ones(n_features, dtype='int16')
    return disordered_trajs, disorder_n_states


def transition_stats(rotamer_trajs):
    """Transition frames plus trajectory-weighted mean ordered and
    disordered times per feature. (reference: disorder.py:185)"""
    n_features = rotamer_trajs[0].shape[1]

    # stats[i, j] = (ord_time, n_ord, disord_time, n_disord) for
    # feature j of trajectory i
    transition_times = []
    stats = np.zeros((len(rotamer_trajs), n_features, 4))
    for i, traj in enumerate(rotamer_trajs):
        per_feature = _feature_transitions(traj)
        transition_times.append(per_feature)
        stats[i] = [traj_ord_disord_times(tt) for tt in per_feature]

    spans = np.asarray([len(t) for t in rotamer_trajs])
    mean_ordered = aggregate_mean_times(stats[..., 0], stats[..., 1],
                                        spans)
    mean_disordered = aggregate_mean_times(stats[..., 2],
                                           stats[..., 3], spans)
    return transition_times, mean_ordered, mean_disordered


def aggregate_mean_times(times, n_times, weight):
    """Trajectory-length-weighted mean of per-trajectory times.
    (reference: disorder.py:239)"""
    nl_weight = weight / np.sum(weight)
    with np.errstate(all='ignore'):
        return (times * nl_weight[:, None]).sum(axis=0)
