"""Plain k-centers, and the judge of a clustering's centers and
assignments, from the frozen QCP RMSD of :mod:`.qcp`.

The judge follows the program's own centers in their order: for each
center ``c_i`` after the first it works out the largest distance from
any frame to its nearest earlier center, ``M_i``, and the same distance
of ``c_i`` itself, ``v_i``; farthest-first picks ``M_i - v_i = 0`` up to
rounding. It works out every frame's nearest center too, and reads the
program's label and distance of each frame against it. Frames can be
judged in stripes (one a process) whose partial results
:func:`combine` joins.
"""

import numpy as np
import torch

from .qcp import rmsd_block

BLOCK_PAIRS = 1 << 24


def kcenters(frames, n_clusters, first, keep_columns=False):
    """Gonzalez farthest-first from frame ``first`` over ``frames`` (a
    :class:`~.qcp.Frames`): the next center is the first frame of
    largest distance to its nearest center; a frame moves to a new
    center whose distance is strictly smaller. Returns ``(centers (k,),
    assignments (n,), distances (n,), columns)``, ``columns`` the
    ``(n, k)`` distances to every center when ``keep_columns``."""
    n = len(frames)
    dev = frames.x.device
    dist = torch.full((n,), float('inf'), dtype=frames.x.dtype, device=dev)
    assig = torch.full((n,), -1, dtype=torch.long, device=dev)
    cols = (torch.empty((n, n_clusters), dtype=frames.x.dtype, device=dev)
            if keep_columns else None)
    centers = []
    nxt = int(first)
    step = BLOCK_PAIRS
    for i in range(n_clusters):
        centers.append(nxt)
        col = torch.cat([frames.rmsd(slice(lo, lo + step),
                                     torch.tensor([nxt], device=dev))[:, 0]
                         for lo in range(0, n, step)])
        if cols is not None:
            cols[:, i] = col
        closer = col < dist
        dist = torch.where(closer, col, dist)
        assig = torch.where(closer, i, assig)
        nxt = int(torch.argmax(dist))
    return np.asarray(centers), assig, dist, cols


def judge_stripe(frames, offset, centers, labels, distances, picks=True):
    """Partial results over one stripe of frames: ``frames`` (a
    :class:`~.qcp.Frames` of the stripe), ``offset`` its first global
    frame, ``centers`` the program's ``(k,)`` global center indices in
    their order with their centered coordinates and G, as ``(indices,
    x, g)``; ``labels`` and ``distances`` the program's, for the
    stripe's frames (host arrays).

    Every gap is of squared RMSDs (mean square deviations): near zero a
    float32 RMSD is the square root of rounding, and the squares keep
    the gaps on the scale of the arithmetic's error.

    Returns a dict: ``label_gap`` (the largest excess of the square
    distance to the program's label over the nearest), ``dist_gap`` (the
    largest difference between the square of the program's distance and
    the reference's to the same center), ``sq_sum`` (the sum of squared
    nearest distances), and with ``picks`` ``pick_max`` (k,) and
    ``pick_val`` (k,) (squared ``M_i`` over the stripe, squared ``v_i``
    where the stripe holds ``c_i``, -inf elsewhere)."""
    idx, cx, cg = centers
    n = len(frames)
    k = cx.shape[0]
    dev = frames.x.device
    dt = frames.x.dtype
    rows = max(1, BLOCK_PAIRS // k)
    labels = torch.as_tensor(np.asarray(labels), device=dev).long()
    dists = torch.as_tensor(np.asarray(distances), device=dev).to(dt)
    pos = {int(c): i for i, c in enumerate(np.asarray(idx))}
    label_gap = torch.zeros((), dtype=dt, device=dev)
    dist_gap = torch.zeros((), dtype=dt, device=dev)
    sq_sum = torch.zeros((), dtype=torch.float64, device=dev)
    pick_max = torch.full((k,), -float('inf'), dtype=dt, device=dev)
    pick_val = torch.full((k,), -float('inf'), dtype=dt, device=dev)
    inf_col = None
    for lo in range(0, n, rows):
        hi = min(n, lo + rows)
        D = rmsd_block(frames.x[lo:hi], frames.g[lo:hi], cx, cg,
                       frames.tf32)
        lab = labels[lo:hi]
        if bool(((lab < 0) | (lab >= k)).any()):
            return dict(label_gap=float('inf'), dist_gap=float('inf'),
                        sq_sum=float('inf'), pick_max=[float('inf')] * k,
                        pick_val=[0.0] * k)
        at = D.gather(1, lab[:, None])[:, 0] ** 2
        dmin = D.min(dim=1).values ** 2
        label_gap = torch.maximum(label_gap, (at - dmin).max())
        dist_gap = torch.maximum(dist_gap,
                                 (dists[lo:hi] ** 2 - at).abs().max())
        sq_sum += dmin.double().sum()
        if picks:
            if inf_col is None or inf_col.shape[0] != hi - lo:
                inf_col = torch.full((hi - lo, 1), float('inf'), dtype=dt,
                                     device=dev)
            before = torch.cat(
                (inf_col, torch.cummin(D, dim=1).values[:, :-1] ** 2),
                dim=1)
            pick_max = torch.maximum(pick_max, before.max(dim=0).values)
            for g, i in pos.items():
                if offset + lo <= g < offset + hi:
                    pick_val[i] = before[g - offset - lo, i]
        del D
    out = dict(label_gap=float(label_gap), dist_gap=float(dist_gap),
               sq_sum=float(sq_sum))
    if picks:
        out['pick_max'] = pick_max.cpu().tolist()
        out['pick_val'] = pick_val.cpu().tolist()
    return out


def combine(parts):
    """Join the stripes' partial results into the judge's numbers."""
    out = dict(label_gap=max(p['label_gap'] for p in parts),
               dist_gap=max(p['dist_gap'] for p in parts))
    if 'pick_max' in parts[0]:
        M = np.max([p['pick_max'] for p in parts], axis=0)
        v = np.max([p['pick_val'] for p in parts], axis=0)
        # center 0 is the seeded start, not a pick
        out['pick_gap'] = float(np.max(M[1:] - v[1:])) if len(M) > 1 else 0.0
    return out
