"""K-centers (Gonzalez farthest-point) clustering (counterpart of
``enspara_tpu/cluster/kcenters.py``).

Metric 'rmsd' runs in :func:`enspara_tpu_torch.cluster.engine.
kcenters_device_fused` (the tri-skip CUDA kernel on the card); the
feature metrics ('euclidean', 'manhattan', 'hamming') in the torch-op
loop of :func:`~enspara_tpu_torch.cluster.engine.kcenters_device`. A
warm start from ``init_centers`` assigns the frames to them first
(:func:`_warm_start`, on the devices, its state the loop's start). With
``mesh=`` (a :class:`~enspara_tpu_torch.parallel.mesh.FrameMesh`) the
frames are sharded over it and both run per shard; with neither
``device=`` nor ``mesh=``, host input runs where the JAX function's
default mesh puts it: the current card for frames of fewer than
``SMALL_JOB_FEATURES`` features, every visible card for more
(:func:`~enspara_tpu_torch.parallel.mesh.resolve_placement`).
``precision='bf16'``
streams RMSD frames in bfloat16 and ``sort='locality'`` clusters a
locality-sorted layout (:func:`~enspara_tpu_torch.cluster.engine.
prepare_rmsd_frames`). Callable metrics run the host loop with the
reference's semantics.
"""

import logging

import numpy as np

from ..citation import cite
from ..exception import ImproperlyConfigured

from . import engine, util
from .util import run_timed
from ..parallel.mesh import host_fetch, resolve_placement
from ..util.backend import check_random_state
from ..util.log import trace_region

logger = logging.getLogger(__name__)

__all__ = ['KCenters', 'kcenters', 'kcenters_mpi']


class KCenters(util.MolecularClusterMixin):
    """Sklearn-style k-centers estimator.

    Parameters
    ----------
    metric : 'rmsd', 'euclidean', 'manhattan', 'hamming', or a callable
        ``f(X, center) -> distances``
    n_clusters : int, optional
    cluster_radius : float, optional
        Stop adding centers once the max frame-center distance falls to
        this value. At least one of n_clusters/cluster_radius is needed.
    random_first_center : bool
        Seed the search from a uniformly random frame instead of frame
        0; ``random_state`` pins the draw.
    device : torch device, optional
        Where to cluster host (numpy) input; tensors cluster where they
        lie.
    mesh : FrameMesh, optional
        Shard the frames over this mesh instead (not with ``device``).
        With neither, the default mesh of the JAX package: the current
        card for small jobs, every visible card otherwise.
    precision : 'fp32' (default) or 'bf16'
        'bf16' streams the frames in bfloat16 through the k-centers
        kernels (metric 'rmsd'): half the bytes, distances rounded by
        about 4e-3 relative.
    sort : None or 'locality'
        'locality' clusters the frames in the order of their RMSD to
        frame 0 (metric 'rmsd'), so that the tri-skip finds tiles to
        skip in shuffled data: another, as valid, covering. Results come
        back in the caller's order.
    """

    def __init__(self, metric, n_clusters=None, cluster_radius=None,
                 random_first_center=False, random_state=None, device=None,
                 mesh=None, precision='fp32', sort=None):
        if n_clusters is None and cluster_radius is None:
            raise ImproperlyConfigured(
                'Either n_clusters or cluster_radius is required for '
                'KCenters clustering')
        self.metric = metric
        self.n_clusters = n_clusters
        self.cluster_radius = cluster_radius
        self.random_first_center = random_first_center
        self.random_state = random_state
        self.device = device
        self.mesh = mesh
        self.precision = precision
        self.sort = sort

    def fit(self, X, init_centers=None):
        conf = self.get_params()
        conf['distance_method'] = conf.pop('metric')
        conf['dist_cutoff'] = conf.pop('cluster_radius')
        self.result_, self.runtime_ = run_timed(
            kcenters, X, init_centers=init_centers, **conf)
        return self

    def get_params(self, deep=True):
        return {'metric': self.metric, 'n_clusters': self.n_clusters,
                'cluster_radius': self.cluster_radius,
                'random_first_center': self.random_first_center,
                'random_state': self.random_state, 'device': self.device,
                'mesh': self.mesh, 'precision': self.precision,
                'sort': self.sort}

    def set_params(self, **params):
        for k, v in params.items():
            setattr(self, k, v)
        return self


def kcenters(traj, distance_method, n_clusters=None, dist_cutoff=None,
             init_centers=None, random_first_center=False,
             random_state=None, device=None, mesh=None, precision='fp32',
             sort=None):
    """Functional k-centers. ``traj`` is ``(n, n_atoms, 3)`` coordinates
    (numpy, a tensor, or anything with ``.xyz``) or, for the feature
    metrics, ``(n, d)`` feature vectors, clustered on
    ``device`` or, given ``mesh``, sharded over its shards (the results
    do not depend on the shard count).

    ``init_centers`` warm-starts from given structures: every frame is
    assigned to them first, and each must own at least one frame.
    ``random_first_center=True`` seeds the search from a uniformly
    random frame (``random_state`` pins the draw: a ``RandomState``
    draws ``randint(n)``, anything else ``default_rng(random_state)
    .integers(n)``). ``precision`` and ``sort`` are :class:`KCenters`'s;
    they need a built-in metric.

    Returns a :class:`~enspara_tpu_torch.cluster.util.ClusterResult`
    with host arrays: assignments and distances of every frame, the
    center frame indices, and the center coordinates.
    """
    return _kcenters(traj, distance_method, n_clusters=n_clusters,
                     dist_cutoff=dist_cutoff, init_centers=init_centers,
                     random_first_center=random_first_center,
                     random_state=random_state, device=device, mesh=mesh,
                     precision=precision, sort=sort)[0]


@cite('kcenters')
def _kcenters(traj, distance_method, n_clusters=None, dist_cutoff=None,
              init_centers=None, random_first_center=False,
              random_state=None, device=None, mesh=None, precision='fp32',
              sort=None):
    """:func:`kcenters`, and the frames it laid out for a built-in metric
    (None for a callable one), which k-hybrid's PAM stage takes over."""
    if n_clusters is None and dist_cutoff is None:
        raise ImproperlyConfigured(
            "KCenters must specify 'n_clusters' or 'dist_cutoff'")

    metric_name = util._metric_name(distance_method)
    xyz = traj.xyz if hasattr(traj, 'xyz') else traj

    if random_first_center:
        if init_centers is not None and len(init_centers):
            raise ImproperlyConfigured(
                "'random_first_center' and 'init_centers' both pick "
                'the starting center; pass one or the other')
        if isinstance(random_state, np.random.RandomState):
            first = int(check_random_state(random_state).randint(len(xyz)))
        else:
            first = int(np.random.default_rng(random_state)
                        .integers(len(xyz)))
        init_centers = [traj[first] if hasattr(traj, 'xyz')
                        else xyz[first]]

    if metric_name is not None:
        device, mesh = resolve_placement(xyz, device, mesh,
                                         small_job_rule=True)
        return _kcenters_fast(xyz, metric_name, n_clusters, dist_cutoff,
                              init_centers, device, mesh, precision, sort)
    if sort is not None:
        raise ImproperlyConfigured(
            "sort='locality' requires a built-in metric on the device "
            'path (callable metrics run on the host)')
    if precision != 'fp32':
        raise ImproperlyConfigured(
            "precision='bf16' requires a built-in metric on the device "
            "path (callable metrics run on the host)")
    return _kcenters_host(traj, util._get_distance_method(distance_method),
                          n_clusters, dist_cutoff, init_centers), None


def kcenters_mpi(traj, distance_method, **kwargs):
    """Name-compat with the reference's MPI entry point
    (cluster/kcenters.py:103): data parallelism comes from the frame
    mesh instead of MPI ranks, so pass ``mesh=`` to shard the frames."""
    kwargs.pop('mpi_mode', None)
    return kcenters(traj, distance_method, **kwargs)


def _init_center_data(init_centers):
    return [np.asarray(c.xyz[0] if hasattr(c, 'xyz') else
                       (c.cpu() if hasattr(c, 'cpu') else c))
            for c in init_centers]


def _reject_ownerless(n_init, owned):
    """Raise unless every init center ``0..n_init-1`` is among the
    labels ``owned`` (those that own a frame)."""
    missing = sorted(set(range(n_init)) - set(np.asarray(owned).tolist()))
    if missing:
        raise ImproperlyConfigured(
            'init_centers %s own no frames (duplicated centers, or '
            'centers dominated by another init center); remove them '
            'from the warm start' % missing)


def _warm_start(X, prep, centers, metric, mesh):
    """Every frame assigned to the init ``centers`` and each init
    center's frame (its cluster's first minimum-distance frame), as
    ``(distances, assignments, center indices)``.

    The assignment runs per shard on float32 frames in the caller's
    order: on ``prep`` itself, else (bf16 or locality-sorted RMSD
    frames) on such frames prepared from ``X`` alike. Its state stays
    on the devices: the centers' frames come from
    :func:`~enspara_tpu_torch.cluster.engine._first_minima` (one
    collective, one read of ``len(centers)`` indices), and the
    per-shard tensors become the loop's start state as they lie. Only
    where they do not line up with ``prep``'s layout
    (:func:`~enspara_tpu_torch.cluster.engine._lines_up`: a locality
    sort) are they fetched to the host, in the caller's order, and
    counted in ``_kcenters_fast.n_host_warm_starts``."""
    plain = metric != 'rmsd' or (prep.precision == 'fp32'
                                 and prep.perm is None)
    src = prep if plain else engine._prepared(
        X, metric, device=None if mesh is not None else prep.device,
        mesh=mesh)
    assigs, dists = engine._assign_shards(src, centers, metric)
    # the min-distance frame of each init cluster is its center's
    # index; an init center that owns no frames has none
    with trace_region('enspara/kcenters.init_centers'):
        inds = engine._first_minima(src, assigs, dists, len(centers), mesh)
        _reject_ownerless(len(centers), np.flatnonzero(inds < src.n))
    if engine._lines_up(src, prep):
        return dists, assigs, inds
    _kcenters_fast.n_host_warm_starts += 1
    return (host_fetch(dists, mesh)[:src.n], host_fetch(assigs, mesh)[:src.n],
            inds)


def _kcenters_fast(X, metric, n_clusters, dist_cutoff, init_centers,
                   device, mesh=None, precision='fp32', sort=None):
    if metric == 'rmsd':
        prep = engine.prepare_rmsd_frames(X, device=device, mesh=mesh,
                                          precision=precision, sort=sort)
    else:
        prep = engine.prepare_sharded(X, metric, mesh=mesh, device=device)
    _kcenters_fast.n_host_warm_starts = 0
    n_init = 0
    init_distances = init_assignments = init_ctr_inds = None
    init_center_data = []
    if init_centers is not None and len(init_centers):
        init_center_data = _init_center_data(init_centers)
        n_init = len(init_center_data)
        with trace_region('enspara/kcenters.warm_start'):
            init_distances, init_assignments, init_ctr_inds = _warm_start(
                X, prep, np.stack(init_center_data), metric, mesh)

    res = engine.kcenters_device(
        prep, metric, n_clusters=n_clusters, dist_cutoff=dist_cutoff,
        init_distances=init_distances, init_assignments=init_assignments,
        n_init_centers=n_init, init_center_indices=init_ctr_inds,
        mesh=mesh, precision=precision, sort=sort)

    ctr_inds = list(res.center_indices)
    centers = list(init_center_data) + \
        util.gather_frames(X, ctr_inds[n_init:])
    logger.info('Terminated k-centers with n=%s and d=%0.6f',
                res.n_found, res.distances.max(initial=0.0))
    return util.ClusterResult(center_indices=ctr_inds,
                              assignments=res.assignments,
                              distances=res.distances, centers=centers), prep


# the warm starts of the last call whose state went through the host
# (a locality-sorted layout): 0 or 1
_kcenters_fast.n_host_warm_starts = 0


def _kcenters_host(traj, distance_method, n_clusters, dist_cutoff,
                   init_centers):
    """Host loop for callable metrics, with the reference's semantics:
    first-max argmax, strict-``<`` update."""
    n_clusters = np.inf if n_clusters is None else n_clusters
    dist_cutoff = 0 if dist_cutoff is None else dist_cutoff

    if init_centers is None:
        ctr_inds = []
        centers = []
        assignments = np.full(len(traj), -1, dtype=int)
        distances = np.full(len(traj), np.inf, dtype=float)
    else:
        centers = [c for c in init_centers]
        assignments, distances = util.assign_to_nearest_center(
            traj, centers, distance_method)
        ctr_inds = list(util.find_cluster_centers(assignments, distances))
        _reject_ownerless(len(centers), assignments[ctr_inds])

    while (len(ctr_inds) < n_clusters) and (distances.max() > dist_cutoff):
        new_center_index = int(np.argmax(distances))
        ctr_inds.append(new_center_index)
        new_center = traj[new_center_index]
        dist = np.asarray(distance_method(traj, new_center)).reshape(-1)
        inds = dist < distances
        distances[inds] = dist[inds]
        assignments[inds] = len(ctr_inds) - 1
        centers.append(new_center)

    return util.ClusterResult(center_indices=ctr_inds,
                              assignments=assignments,
                              distances=distances, centers=centers)
