"""K-hybrid clustering: k-centers seeding + k-medoids refinement
(counterpart of ``enspara_tpu/cluster/hybrid.py``)."""

import logging

import numpy as np

from ..citation import cite
from ..exception import ImproperlyConfigured

from . import engine, util
from .engine_kmedoids import kmedoids_sweeps_device
from .kcenters import _kcenters
from .kmedoids import _kmedoids_iterations
from .util import run_timed
from ..parallel.mesh import resolve_placement
from ..util.backend import check_random_state
from ..util.log import trace_region

logger = logging.getLogger(__name__)

__all__ = ['KHybrid', 'hybrid', 'hybrid_device']


class KHybrid(util.MolecularClusterMixin):
    """Sklearn-style estimator: k-centers to place centers, then
    ``kmedoids_updates`` PAM sweeps to refine them (on the card for data
    on a CUDA device). A ``mesh`` of one shard runs on its device; over
    more shards both stages run per shard, the PAM stage as the device
    sweeps on any device type. With neither ``device`` nor ``mesh``,
    :func:`hybrid`'s default placement applies."""

    def __init__(self, metric, n_clusters=None, cluster_radius=None,
                 kmedoids_updates=5, random_first_center=False,
                 random_state=None, device=None, mesh=None):
        if n_clusters is None and cluster_radius is None:
            raise ImproperlyConfigured(
                'Either n_clusters or cluster_radius is required for '
                'KHybrid clustering')
        self.metric = metric
        self.n_clusters = n_clusters
        self.cluster_radius = cluster_radius
        self.kmedoids_updates = kmedoids_updates
        self.random_first_center = random_first_center
        self.random_state = random_state
        self.device = device
        self.mesh = mesh

    def fit(self, X, init_centers=None):
        conf = dict(n_iters=self.kmedoids_updates,
                    n_clusters=self.n_clusters,
                    dist_cutoff=self.cluster_radius,
                    random_first_center=self.random_first_center,
                    random_state=self.random_state,
                    device=self.device, mesh=self.mesh)
        self.result_, self.runtime_ = run_timed(
            hybrid, X, self.metric, init_centers=init_centers, **conf)
        return self


@cite('khybrid')
def hybrid(X, distance_method, n_iters=5, n_clusters=None,
           dist_cutoff=None, random_first_center=False,
           init_centers=None, random_state=None, device=None, mesh=None):
    """K-centers, then ``n_iters`` PAM sweeps from its result. The
    first-center seed is drawn from ``random_state`` before the PAM
    seed, as in the JAX package. ``mesh`` reaches both stages: a mesh of
    one shard runs on its device, more shards run k-centers and the
    device sweeps over them. With neither ``device`` nor ``mesh``, host
    data runs where the JAX function's k-centers stage does: on the
    current card for frames of fewer than ``SMALL_JOB_FEATURES``
    features, over every visible card for more; both stages run there.
    The device sweeps take the frames as the k-centers stage laid them
    out: a fit lays them out once."""
    device, mesh = resolve_placement(X, device, mesh, small_job_rule=True)
    random_state = check_random_state(random_state)

    with trace_region('enspara/khybrid.kcenters'):
        result, prep = _kcenters(
            X, distance_method, n_clusters=n_clusters,
            dist_cutoff=dist_cutoff, init_centers=init_centers,
            random_first_center=random_first_center,
            random_state=(random_state.randint(2 ** 31)
                          if random_first_center else None),
            device=device, mesh=mesh)

    if n_iters <= 0:
        return result

    metric = util._get_distance_method(distance_method)
    with trace_region('enspara/khybrid.pam'):
        return _kmedoids_iterations(
            X, metric, n_iters,
            list(np.asarray(result.center_indices)),
            np.asarray(result.assignments),
            np.asarray(result.distances),
            random_state=random_state, device=device, mesh=mesh, prep=prep)


def hybrid_device(X, metric='rmsd', n_iters=5, n_clusters=None,
                  dist_cutoff=None, seed=0, bucket_factor=8, device=None,
                  mesh=None):
    """K-hybrid with both stages on the device: the k-centers loop seeds
    the device PAM sweeps, from frames prepared once, on ``device`` or
    over the shards of ``mesh`` (the same container serves both stages),
    for any named metric. With neither, host data runs as the JAX
    function's does: on the current card for frames of fewer than
    ``SMALL_JOB_FEATURES`` features, over every visible card for more.

    Returns a ClusterResult (centers gathered host-side at the end).
    """
    device, mesh = resolve_placement(X, device, mesh, small_job_rule=True)
    xyz = X.xyz if hasattr(X, 'xyz') else X
    with trace_region('enspara/khybrid.kcenters'):
        prep = engine.prepare_sharded(xyz, metric, mesh=mesh,
                                      device=device)
        res = engine.kcenters_device(prep, metric, n_clusters=n_clusters,
                                     dist_cutoff=dist_cutoff, mesh=mesh)
    with trace_region('enspara/khybrid.pam'):
        m, d, a = kmedoids_sweeps_device(
            prep, metric, res.assignments, res.distances,
            res.center_indices, n_sweeps=n_iters, seed=seed,
            bucket_factor=bucket_factor, mesh=mesh)
    return util.ClusterResult(center_indices=list(m), assignments=a,
                              distances=d,
                              centers=util.gather_frames(xyz, m))
