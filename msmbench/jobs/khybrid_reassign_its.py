"""Job kind ``khybrid_reassign_its``: enspara's documented k-hybrid
workflow on one card, through the public API of ``enspara_tpu_torch``.

Set-up makes the configuration's frames on the card from the seed
(``msmbench/data/basins.py``) and takes every ``subsample``-th frame of
each trajectory. A job, with the job's ``random_state``:

1. ``KHybrid(metric='rmsd', n_clusters, kmedoids_updates,
   random_first_center=True, random_state).fit(X_sub)``;
2. ``assign_device(X, centers, metric='rmsd')`` over every frame;
3. ``implied_timescales_batched(assignments, lag_times, n_times)``.

The judge (plain float64 torch on the same card, after the window):

- every frame's label and distance against the reference's RMSD to the
  program's medoids (``assign_*``), and the same for the subsample's
  labels and distances that the fit returns (``cluster_*``);
- the k-hybrid run again in the reference from the same seeds
  (farthest-first from the same first frame, then PAM sweeps with the
  program's documented proposal rule), and the mean square distance to
  the program's medoids against the reference's (``cluster_cost_gap``);
- the implied timescales from the program's (judged) labels against
  the reference's transpose-symmetrized MSM (``msm_its_gap``).

The control (:func:`control`) puts the reference in the program's place
with its RMSD in TF32 and the MSM's symmetric matrix in bfloat16.
"""

import sys
import time

import numpy as np
import torch

from msmbench.data import basins
from msmbench.reference import kcenters as ref_kc
from msmbench.reference import msm as ref_msm
from msmbench.reference import pam as ref_pam
from msmbench.reference.qcp import Frames


class State:
    pass


def _lags(cfg):
    lo, hi, step = cfg['msm']['lag_times']
    return list(range(lo, hi, step))


def setup(ctx):
    cfg = ctx.config
    s = State()
    s.cfg = cfg
    s.device = ctx.device
    s.X = basins.frames(ctx.seed, cfg['n_frames'], cfg['n_atoms'],
                        **cfg['assumed']['generator'], device=ctx.device)
    s.lengths = basins.lengths(cfg['n_frames'],
                               cfg['assumed']['traj_frames'])
    s.sub_idx = basins.subsample(s.lengths, cfg['cluster']['subsample']) \
        .to(ctx.device)
    s.X_sub = s.X[s.sub_idx]
    return s


def _split(labels, lengths):
    return np.split(np.asarray(labels), np.cumsum(lengths)[:-1])


def run(s, random_state, spans):
    from enspara_tpu_torch.cluster import KHybrid
    from enspara_tpu_torch.cluster.engine import assign_device
    from enspara_tpu_torch.msm.eigen_device import \
        implied_timescales_batched

    c = s.cfg['cluster']
    with spans('cluster'):
        est = KHybrid(metric=c['metric'], n_clusters=c['n_clusters'],
                      kmedoids_updates=c['kmedoids_updates'],
                      random_first_center=True,
                      random_state=random_state).fit(s.X_sub)
    res = est.result_
    centers = np.stack([np.asarray(x) for x in res.centers])
    with spans('assign'):
        labels, dists = assign_device(s.X, centers, metric=c['metric'])
    with spans('msm'):
        its = implied_timescales_batched(
            _split(labels, s.lengths), _lags(s.cfg),
            n_times=s.cfg['msm']['n_times'])
    return dict(random_state=random_state,
                medoids=np.asarray(res.center_indices, np.int64),
                sub_labels=np.asarray(res.assignments),
                sub_dists=np.asarray(res.distances),
                labels=labels, dists=dists, its=its)


def _seeds(random_state, n_sub):
    """The first frame and the PAM seed that the estimator draws from
    ``random_state`` (a ``RandomState``: the k-centers stage's seed, then
    the sweeps' seed; the first frame ``default_rng(seed).integers(n)``)."""
    rs = np.random.RandomState(random_state)
    s1, s2 = int(rs.randint(2 ** 31)), int(rs.randint(2 ** 31))
    return int(np.random.default_rng(s1).integers(n_sub)), s2


def _khybrid(s, sub, random_state):
    """The k-hybrid run of the reference on ``sub`` (a Frames of the
    subsample): medoids and their (n_sub, k) distance columns."""
    c = s.cfg['cluster']
    first, pam_seed = _seeds(random_state, len(sub))
    centers, _, _, cols = ref_kc.kcenters(sub, c['n_clusters'], first,
                                          keep_columns=True)
    medoids = ref_pam.sweeps(sub, cols, centers, pam_seed,
                             c['kmedoids_updates'])
    return np.asarray(medoids, np.int64), cols


def judge(s, out, ctx):
    """The judge's partial results for one job (one card: the whole)."""
    dev = s.device
    sub_idx = s.sub_idx.cpu().numpy()
    medoids = np.asarray(out['medoids'], np.int64)
    k = s.cfg['cluster']['n_clusters']
    if medoids.shape != (k,) or medoids.min() < 0 or \
            medoids.max() >= len(sub_idx):
        return dict(valid=False)
    tick = [time.time()]

    def lap(name):
        now = time.time()
        laps.append('%s %.1f s' % (name, now - tick[0]))
        tick[0] = now
    laps = []
    full = Frames(s.X)
    g_med = torch.as_tensor(sub_idx[medoids], device=dev)
    cx, cg = full.x[g_med], full.g[g_med]
    part = dict(valid=True)
    part['assign'] = ref_kc.judge_stripe(
        full, 0, (g_med.cpu().numpy(), cx, cg), out['labels'], out['dists'],
        picks=False)
    del full
    lap('assignment')
    sub = Frames(s.X_sub)
    c = ref_kc.judge_stripe(sub, 0, (medoids, cx, cg), out['sub_labels'],
                            out['sub_dists'], picks=False)
    part['cluster'] = c
    lap('subsample')
    # the mean square distance to the program's medoids and to the
    # reference's, both by the reference's RMSD
    ref_medoids, cols = _khybrid(s, sub, out['random_state'])
    cost_ref = float((cols.min(dim=1).values ** 2).mean())
    part['cost_gap'] = abs(c['sq_sum'] / len(sub) - cost_ref) / cost_ref
    del cols, sub
    lap('k-hybrid')
    part['its_gap'] = _its_gap(s, out['labels'], out['its'])
    lap('timescales')
    print('msmbench: judge: %s' % ', '.join(laps), file=sys.stderr,
          flush=True)
    return part


def _its_gap(s, labels, its):
    lags = _lags(s.cfg)
    k = s.cfg['cluster']['n_clusters']
    n_times = s.cfg['msm']['n_times']
    labels = np.asarray(labels)
    n_states = int(labels.max()) + 1 if labels.size else k
    ref = [ref_msm.timescales(ref_msm.counts(labels, s.lengths, lag,
                                             n_states, s.device),
                              lag, n_times) for lag in lags]
    return ref_msm.relative_gap(its, np.stack(ref))


def numbers(parts):
    p = parts[0]
    if not p['valid']:
        return {n: float('inf') for n in NUMBERS}
    return {'assign_label_gap': p['assign']['label_gap'],
            'assign_dist_gap': p['assign']['dist_gap'],
            'cluster_label_gap': p['cluster']['label_gap'],
            'cluster_dist_gap': p['cluster']['dist_gap'],
            'cluster_cost_gap': p['cost_gap'],
            'msm_its_gap': p['its_gap']}


NUMBERS = ('assign_label_gap', 'assign_dist_gap', 'cluster_label_gap',
           'cluster_dist_gap', 'cluster_cost_gap', 'msm_its_gap')


def control(s, random_state):
    """The reference in the program's place, one precision down: RMSD
    with TF32 products (float32 otherwise), the MSM's symmetric matrix
    in bfloat16. Returns a job's output."""
    c = s.cfg['cluster']
    sub = Frames(s.X_sub, dtype=torch.float32, tf32=True)
    medoids, cols = _khybrid(s, sub, random_state)
    sub_d, sub_a = cols.min(dim=1)
    del cols
    full = Frames(s.X, dtype=torch.float32, tf32=True)
    g_med = s.sub_idx[torch.as_tensor(medoids, device=s.device)]
    cx, cg = full.x[g_med], full.g[g_med]
    labels, dists = [], []
    rows = max(1, ref_kc.BLOCK_PAIRS // c['n_clusters'])
    from msmbench.reference.qcp import rmsd_block
    for lo in range(0, len(full), rows):
        d, a = rmsd_block(full.x[lo:lo + rows], full.g[lo:lo + rows], cx,
                          cg, tf32=True).min(dim=1)
        labels.append(a.cpu())
        dists.append(d.cpu())
    labels = torch.cat(labels).numpy()
    n_states = int(labels.max()) + 1
    its = np.stack([ref_msm.timescales(
        ref_msm.counts(labels, s.lengths, lag, n_states, s.device), lag,
        s.cfg['msm']['n_times'], dtype=torch.bfloat16)
        for lag in _lags(s.cfg)])
    return dict(random_state=random_state, medoids=medoids,
                sub_labels=sub_a.cpu().numpy(),
                sub_dists=sub_d.double().cpu().numpy(), labels=labels,
                dists=torch.cat(dists).double().numpy(), its=its)
