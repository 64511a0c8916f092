"""Job kind ``kcenters_msm``: k-centers RMSD clustering on one card of
frames that lie on that card, then lag counts and the eigensolve, through
the public API of ``enspara_tpu_torch``, as a user of enspara's one-GPU
``KCenters`` writes it.

Set-up makes every frame on the card from the seed
(``msmbench/data/basins.py``) and keeps them there for the whole run. A
job, with the job's ``random_state``:

1. ``KCenters(metric='rmsd', n_clusters, random_first_center=True,
   random_state).fit(X)``, ``X`` the card-resident ``(n, n_atoms, 3)``
   float32 tensor: no ``device=`` or ``mesh=``, so the estimator runs
   where the tensor lies;
2. ``assigns_to_counts_device`` of the labels cut into trajectories, at
   the configuration's lag;
3. ``transpose_timescales_device(counts, n_eigs, lag_time)``.

The judge (plain float64 torch on the card, after the window) reads
every frame as one stripe, as the four-rank cell's judge reads a rank's
(``kcenters_msm_sharded.py``): the program's centers step by step (each
the farthest frame from the earlier ones, ``kcenters_pick_gap``), every
frame's label and distance (``kcenters_label_gap``,
``kcenters_dist_gap``), the first center against the one the seed draws
(``kcenters_first``), the counts from the program's labels
(``msm_counts_gap``, exact) and the implied timescales
(``msm_its_gap``).

The control (:func:`control`) puts the reference in the program's
place, one precision down: farthest-first with RMSD in TF32 (float32
otherwise), and the MSM's symmetric matrix in bfloat16.
"""

import numpy as np
import torch

from msmbench.data import basins
from msmbench.jobs.kcenters_msm_sharded import (  # noqa: F401
    NUMBERS, _msm, _padded, numbers)
from msmbench.reference import kcenters as ref_kc
from msmbench.reference import msm as ref_msm
from msmbench.reference.qcp import Frames


class State:
    pass


def setup(ctx):
    cfg = ctx.config
    s = State()
    s.cfg = cfg
    s.device = ctx.device
    s.X = basins.frames(ctx.seed, cfg['n_frames'], cfg['n_atoms'],
                        **cfg['assumed']['generator'], device=ctx.device)
    s.lengths = basins.lengths(cfg['n_frames'],
                               cfg['assumed']['traj_frames'])
    return s


def run(s, random_state, spans):
    from enspara_tpu_torch.cluster import KCenters
    from enspara_tpu_torch.msm.eigen_device import \
        transpose_timescales_device
    from enspara_tpu_torch.msm.transition_matrices import \
        assigns_to_counts_device

    c, m = s.cfg['cluster'], s.cfg['msm']
    with spans('cluster'):
        est = KCenters(metric=c['metric'], n_clusters=c['n_clusters'],
                       random_first_center=True,
                       random_state=random_state).fit(s.X)
    res = est.result_
    out = dict(random_state=random_state,
               centers=np.asarray(res.center_indices, np.int64),
               labels=np.asarray(res.assignments),
               dists=np.asarray(res.distances))
    with spans('msm'):
        a, mask = _padded(out['labels'], s.lengths)
        C = assigns_to_counts_device(a, mask, m['lag_time'], c['n_clusters'])
        its, _, _ = transpose_timescales_device(C, m['n_eigs'],
                                                lag_time=m['lag_time'])
        out.update(counts=C.cpu().numpy(), its=its)
    return out


def judge(s, out, ctx):
    """The judge's partial results for one job: every frame, one stripe."""
    k = s.cfg['cluster']['n_clusters']
    n = s.cfg['n_frames']
    centers = np.asarray(out['centers'], np.int64)
    if centers.shape != (k,) or centers.min() < 0 or centers.max() >= n:
        return dict(valid=False)
    frames = Frames(s.X)
    idx = torch.as_tensor(centers, device=s.device)
    part = ref_kc.judge_stripe(frames, 0, (centers, frames.x[idx],
                                           frames.g[idx]),
                               out['labels'], out['dists'])
    del frames
    part['valid'] = True
    first = np.random.default_rng(out['random_state']).integers(n)
    part['first'] = float(int(centers[0]) != int(first))
    part.update(_msm(s, out))
    return part


def control(s, random_state):
    """The reference in the program's place, one precision down:
    farthest-first with TF32 RMSD products (float32 otherwise), counts,
    and the MSM's symmetric matrix in bfloat16."""
    c, m = s.cfg['cluster'], s.cfg['msm']
    n = s.cfg['n_frames']
    frames = Frames(s.X, dtype=torch.float32, tf32=True)
    first = int(np.random.default_rng(random_state).integers(n))
    centers, labels, dists, _ = ref_kc.kcenters(frames, c['n_clusters'],
                                                first)
    del frames
    labels = labels.cpu().numpy()
    C = ref_msm.counts(labels, s.lengths, m['lag_time'], c['n_clusters'],
                       s.device)
    its = ref_msm.timescales(C, m['lag_time'], m['n_eigs'] - 1,
                             dtype=torch.bfloat16)
    return dict(random_state=random_state, centers=centers, labels=labels,
                dists=dists.double().cpu().numpy(),
                counts=C.cpu().numpy(), its=its)
