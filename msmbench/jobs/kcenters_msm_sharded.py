"""Job kind ``kcenters_msm_sharded``: k-centers RMSD clustering in one
process a card over ``torch.distributed`` (NCCL between cards), then
lag counts over the job and the eigensolve on rank 0, through the public
API of ``enspara_tpu_torch``, as enspara's MPI clustering lays it out.

Set-up joins the job (``apps.cluster.join_job``: the launcher sets
``ENSPARA_TPU_COORDINATOR`` and the rank; one card a process gives
NCCL), makes every frame on this process's card from the seed and holds
them in host memory, as each process of the multi-process ``cluster``
CLI holds what it loaded and hands it to ``fit``. A job, with the job's
``random_state``:

1. ``KCenters(metric='rmsd', n_clusters, random_first_center=True,
   random_state, mesh=mesh).fit(X)``;
2. ``assigns_to_counts_sharded`` of the labels cut into trajectories,
   at the configuration's lag;
3. ``transpose_timescales_device(counts, n_eigs, lag_time)`` on rank 0.

The judge, each rank over its quarter of the frames (plain float64
torch on its card, after the window): the program's centers step by step
(each the farthest frame from the earlier ones, ``kcenters_pick_gap``),
every frame's label and distance (``kcenters_label_gap``,
``kcenters_dist_gap``); on rank 0 the first center against the one the
seed draws (``kcenters_first``), the counts from the program's labels
(``msm_counts_gap``, exact) and the implied timescales
(``msm_its_gap``).

The control (:func:`control`, one card) puts the reference in the
program's place: farthest-first with RMSD in TF32 (float32 otherwise),
and the MSM's symmetric matrix in bfloat16.
"""

import numpy as np
import torch

from msmbench.data import basins
from msmbench.reference import kcenters as ref_kc
from msmbench.reference import msm as ref_msm
from msmbench.reference.qcp import Frames, center


class State:
    pass


def setup(ctx):
    cfg = ctx.config
    s = State()
    s.cfg = cfg
    s.device = ctx.device
    s.rank, s.world = ctx.rank, ctx.world
    s.mesh = ctx.mesh
    if s.mesh is None:
        from enspara_tpu_torch.apps.cluster import join_job
        s.mesh = join_job()
    n, A = cfg['n_frames'], cfg['n_atoms']
    s.X = np.empty((n, A, 3), np.float32)
    basins.frames(ctx.seed, n, A, **cfg['assumed']['generator'],
                  device=ctx.device, out=torch.from_numpy(s.X))
    s.lengths = basins.lengths(n, cfg['assumed']['traj_frames'])
    return s


def _padded(labels, lengths):
    """Labels as ``(n_traj, max_len)`` rows and their mask."""
    width = max(lengths)
    a = np.zeros((len(lengths), width), np.int32)
    m = np.zeros((len(lengths), width), bool)
    lo = 0
    for t, n in enumerate(lengths):
        a[t, :n] = labels[lo:lo + n]
        m[t, :n] = True
        lo += n
    return a, m


def run(s, random_state, spans):
    from enspara_tpu_torch.cluster import KCenters
    from enspara_tpu_torch.msm.eigen_device import \
        transpose_timescales_device
    from enspara_tpu_torch.msm.transition_matrices import \
        assigns_to_counts_sharded

    c, m = s.cfg['cluster'], s.cfg['msm']
    with spans('cluster'):
        est = KCenters(metric=c['metric'], n_clusters=c['n_clusters'],
                       random_first_center=True, random_state=random_state,
                       mesh=s.mesh).fit(s.X)
    res = est.result_
    out = dict(random_state=random_state,
               centers=np.asarray(res.center_indices, np.int64),
               labels=np.asarray(res.assignments),
               dists=np.asarray(res.distances))
    with spans('msm'):
        a, mask = _padded(out['labels'], s.lengths)
        C = assigns_to_counts_sharded(a, mask, m['lag_time'],
                                      c['n_clusters'], mesh=s.mesh)
        if s.rank == 0:
            its, w, _ = transpose_timescales_device(
                C, m['n_eigs'], lag_time=m['lag_time'])
            out.update(counts=C.cpu().numpy(), its=its)
    return out


def _stripe(s):
    n = s.cfg['n_frames']
    lo = n * s.rank // s.world
    return lo, n * (s.rank + 1) // s.world


def judge(s, out, ctx):
    """This rank's partial results for one job."""
    k = s.cfg['cluster']['n_clusters']
    centers = np.asarray(out['centers'], np.int64)
    n = s.cfg['n_frames']
    if centers.shape != (k,) or centers.min() < 0 or centers.max() >= n:
        return dict(valid=False)
    lo, hi = _stripe(s)
    frames = Frames(torch.from_numpy(s.X[lo:hi]).to(s.device))
    cx, cg = center(torch.from_numpy(s.X[centers]).to(s.device))
    part = ref_kc.judge_stripe(frames, lo, (centers, cx, cg),
                               out['labels'][lo:hi], out['dists'][lo:hi])
    part['valid'] = True
    del frames
    if s.rank == 0:
        first = np.random.default_rng(out['random_state']).integers(n)
        part['first'] = float(int(centers[0]) != int(first))
        part.update(_msm(s, out))
    return part


def _msm(s, out):
    m = s.cfg['msm']
    k = s.cfg['cluster']['n_clusters']
    C = ref_msm.counts(out['labels'], s.lengths, m['lag_time'], k, s.device)
    gap = float((C.cpu() - torch.as_tensor(out['counts']).long()).abs()
                .sum())
    ref = ref_msm.timescales(C, m['lag_time'], m['n_eigs'] - 1)
    return dict(counts_gap=gap,
                its_gap=ref_msm.relative_gap(out['its'], ref))


NUMBERS = ('kcenters_first', 'kcenters_pick_gap', 'kcenters_label_gap',
           'kcenters_dist_gap', 'msm_counts_gap', 'msm_its_gap')


def numbers(parts):
    if not all(p['valid'] for p in parts):
        return {n: float('inf') for n in NUMBERS}
    j = ref_kc.combine(parts)
    lead = parts[0]
    return {'kcenters_first': lead['first'],
            'kcenters_pick_gap': j['pick_gap'],
            'kcenters_label_gap': j['label_gap'],
            'kcenters_dist_gap': j['dist_gap'],
            'msm_counts_gap': lead['counts_gap'],
            'msm_its_gap': lead['its_gap']}


def control(s, random_state):
    """The reference in the program's place on one card, one precision
    down: farthest-first with TF32 RMSD products (float32 otherwise),
    counts, and the MSM's symmetric matrix in bfloat16."""
    c, m = s.cfg['cluster'], s.cfg['msm']
    n = s.cfg['n_frames']
    frames = Frames(torch.from_numpy(s.X).to(s.device), dtype=torch.float32,
                    tf32=True)
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

