"""K-medoids (PAM) clustering (counterpart of
``enspara_tpu/cluster/kmedoids.py``).

Data on a CUDA device runs the PAM sweeps on the card
(:func:`enspara_tpu_torch.cluster.engine_kmedoids.
kmedoids_sweeps_device`: the all-pairs CUDA kernel for 'rmsd', the
distances of ``ops.distances`` for the feature metrics), and so does a
``mesh`` of more than one shard, over its shards, whatever its device
type (the JAX package takes the device sweeps only on a TPU; the host
path has no shards); data on the CPU, explicit proposals and callable
metrics run the host PAM path, which keeps the reference's exact update
(the 3-case mask logic) and its random stream.
"""

import logging

import numpy as np

from ..exception import DataInvalid, ImproperlyConfigured

from . import engine, util
from .util import run_timed
from ..parallel.mesh import resolve_placement
from ..util.backend import check_random_state
from ..util.device import resolve_device

logger = logging.getLogger(__name__)

__all__ = ['KMedoids', 'kmedoids', 'ctr_ids_mpi']


def ctr_ids_mpi(cluster_center_inds, lengths):
    """Center indices in the reference's MPI form ``(owner_rank,
    local_index)`` (reference cluster/kmedoids.py:365; JAX
    ``kmedoids.py:34-69``), with the trajectories striped over the
    processes of the ``torch.distributed`` job round-robin (trajectory
    t on rank t % size, :mod:`enspara_tpu_torch.parallel.io`). A center
    is a global frame index or a ``(trajectory, frame)`` pair. With one
    process every center is rank 0's and its local index is the global
    one."""
    from .. import ra as ra_mod
    from ..parallel import io as pio

    _, size = pio._process_info()
    lengths = np.asarray(lengths)
    global_inds = ra_mod.RaggedArray(
        np.arange(int(lengths.sum())), lengths=lengths)

    out = []
    stripes = {}   # at most `size` distinct stripes; O(n) once each
    for ind in cluster_center_inds:
        if hasattr(ind, '__len__'):
            traj_id, frame_id = int(ind[0]), int(ind[1])
        else:
            traj_id, frame_id = ra_mod.where(global_inds == int(ind))
            traj_id, frame_id = int(traj_id[0]), int(frame_id[0])
        rank = traj_id % size
        if rank not in stripes:
            stripes[rank] = np.concatenate(
                [np.asarray(r).reshape(-1) for r in global_inds[rank::size]])
        target = np.asarray(global_inds[traj_id, frame_id]).reshape(-1)[0]
        out.append((rank, int(np.flatnonzero(stripes[rank] == target)[0])))
    return out


class KMedoids(util.MolecularClusterMixin):
    """Sklearn-style estimator for k-medoids clustering.

    Parameters
    ----------
    metric : 'rmsd', 'euclidean', 'manhattan', 'hamming', or a callable
    n_clusters : int, optional (required unless warm-starting fit())
    n_iters : int, default=5
        Number of PAM sweeps.
    device : torch device, optional
        Where to run host (numpy) input; tensors run where they lie.
    mesh : FrameMesh, optional
        Run over the shards of this mesh instead (not with ``device``):
        a one-shard mesh runs on its device, more shards run the device
        sweeps over them. With neither, host input runs over every
        visible card, the JAX package's default mesh (one card is the
        one-device path), but frames of fewer than
        ``SMALL_JOB_FEATURES`` features on the current card.
    """

    def __init__(self, metric, n_clusters=None, n_iters=5,
                 random_state=None, device=None, mesh=None):
        self.metric = metric
        self.n_clusters = n_clusters
        self.n_iters = n_iters
        self.random_state = random_state
        self.device = device
        self.mesh = mesh

    def fit(self, X, assignments=None, distances=None,
            cluster_center_inds=None):
        conf = dict(distance_method=self.metric,
                    n_clusters=self.n_clusters, n_iters=self.n_iters,
                    random_state=self.random_state, device=self.device,
                    mesh=self.mesh)
        self.result_, self.runtime_ = run_timed(
            kmedoids, X, assignments=assignments, distances=distances,
            cluster_center_inds=cluster_center_inds, **conf)
        return self


def kmedoids(X, distance_method, n_clusters=None, n_iters=5,
             assignments=None, distances=None, cluster_center_inds=None,
             proposals=None, random_state=None, device=None, mesh=None):
    """Functional k-medoids.

    Cold start: picks ``n_clusters`` random frames as medoids. Warm
    start: pass ``assignments`` + ``distances`` (center indices are then
    recovered) and/or ``cluster_center_inds``. A ``mesh`` of one shard
    runs on its device; over more shards the cold start's assignment and
    the sweeps run per shard (the device sweeps, on any device type).
    With neither ``device`` nor ``mesh``, a tensor runs where it lies and
    host input over every visible card (the JAX sweeps' default mesh),
    but on the current card for frames of fewer than
    ``SMALL_JOB_FEATURES`` features (n_frames x features a frame).
    """
    if (cluster_center_inds is None and n_clusters is None
            and (assignments is None or distances is None)):
        raise ImproperlyConfigured(
            'Must provide n_clusters or cluster_center_inds or '
            '(assignments and distances) for KMedoids')
    device, mesh = resolve_placement(X, device, mesh, small_job_rule=True)

    metric = util._get_distance_method(distance_method)
    random_state = check_random_state(random_state)

    assignments, distances, cluster_center_inds = _inputs_tree(
        X, metric, n_clusters, assignments, distances,
        cluster_center_inds, random_state, device, mesh)

    # fp32 kernel self-distance noise scales with the data magnitude
    # (QCP: ~sqrt(G*eps32/n_atoms)), so the gate does too
    gate = max(1e-3, 1e-5 * float(np.max(np.abs(np.asarray(
        distances)))) if np.asarray(distances).size else 1e-3)
    if not np.all(np.asarray(distances)[cluster_center_inds] < gate):
        raise DataInvalid(
            'Warm-start assignments/distances are inconsistent with '
            'centers drawn from X: the recovered center frames sit '
            '%g away from their own cluster centers. Pass '
            'cluster_center_inds explicitly if the centers are not '
            'frames of X.'
            % float(np.asarray(distances)[cluster_center_inds].max()))

    return _kmedoids_iterations(
        X, metric, n_iters, cluster_center_inds, assignments, distances,
        proposals=proposals, random_state=random_state, device=device,
        mesh=mesh)


def _xyz(X):
    return X.xyz if hasattr(X, 'xyz') else X


def _assign_to_inds(X, metric, center_inds, device=None, mesh=None):
    """Assign every frame to the frames at ``center_inds``: the batched
    device assignment for named metrics (per shard over ``mesh``), the
    host loop for callables."""
    name = util._metric_name(metric)
    if name is not None:
        xyz = _xyz(X)
        return engine.assign_device(xyz, xyz[np.asarray(center_inds)], name,
                                    device=device, mesh=mesh)
    return util.assign_to_nearest_center(
        X, [X[i] for i in center_inds], metric)


def _inputs_tree(X, metric, n_clusters, assignments, distances,
                 cluster_center_inds, random_state, device=None, mesh=None):
    """Resolve the three warm-start combinations into a consistent
    ``(assignments, distances, center_inds)`` triple."""
    if (cluster_center_inds is None and assignments is None
            and distances is None):
        cluster_center_inds = random_state.choice(
            len(X), size=n_clusters, replace=False)
        assignments, distances = _assign_to_inds(
            X, metric, cluster_center_inds, device, mesh)
    elif cluster_center_inds is None:
        cluster_center_inds = util.find_cluster_centers(
            assignments, distances)
    elif assignments is None or distances is None:
        assignments, distances = _assign_to_inds(
            X, metric, cluster_center_inds, device, mesh)
    return (np.asarray(assignments), np.asarray(distances),
            list(np.asarray(cluster_center_inds)))


def _kmedoids_iterations(X, metric, n_iters, cluster_center_inds,
                         assignments, distances, proposals=None,
                         random_state=None, backend='auto', device=None,
                         mesh=None, prep=None):
    """``n_iters`` PAM sweeps from a warm start.

    ``backend='auto'`` runs the sweeps on the device when the data is on
    a CUDA device (a CUDA tensor, or host data with a CUDA ``device``)
    or ``mesh`` has more than one shard (on any device type), the metric
    is a named one and no explicit proposals were given; the host path
    runs otherwise (on the mesh's lead device) or with
    ``backend='host'``. The two draw proposals from different
    generators, so they agree in distribution, not bit for bit. The
    device sweeps take ``prep``, ``X``'s frames as k-centers laid them
    out for ``metric``, ``device`` and ``mesh``, in place of laying them
    out again.
    """
    if backend not in ('auto', 'host', 'device'):
        raise DataInvalid("backend must be 'auto', 'host' or "
                          "'device', got %r" % (backend,))
    metric_name = util._metric_name(metric)
    on_device = mesh is not None or \
        resolve_device(_xyz(X), device).type == 'cuda'
    use_device = (backend == 'device'
                  or (backend == 'auto' and proposals is None
                      and metric_name is not None and on_device))
    if use_device and metric_name is not None:
        from .engine_kmedoids import kmedoids_sweeps_device

        rs = check_random_state(random_state)
        m, d, a = kmedoids_sweeps_device(
            _xyz(X) if prep is None else prep, metric_name,
            np.asarray(assignments),
            np.asarray(distances, dtype=np.float64),
            np.asarray(cluster_center_inds),
            n_sweeps=n_iters, seed=int(rs.randint(2 ** 31)), device=device,
            mesh=mesh)
        return util.ClusterResult(
            center_indices=list(m), assignments=a, distances=d,
            centers=util.gather_frames(X, m))
    if mesh is not None:
        device = mesh.lead

    result = util.ClusterResult(
        center_indices=cluster_center_inds,
        assignments=assignments,
        distances=distances,
        centers=util.gather_frames(X, cluster_center_inds))
    for i in range(n_iters):
        cluster_center_inds, distances, assignments, centers = \
            _kmedoids_pam_update(
                X, metric, cluster_center_inds, assignments, distances,
                proposals=proposals, random_state=random_state,
                device=device)
        logger.info('KMedoids update %s', i)
        result = util.ClusterResult(
            center_indices=cluster_center_inds,
            assignments=assignments,
            distances=distances,
            centers=centers)
    return result


def _msq(x):
    return float(np.mean(np.square(x)))


def _propose_new_center_amongst(X, state_inds, random_state):
    proposed_center_ind = random_state.choice(state_inds)
    return X[proposed_center_ind], proposed_center_ind


def _kmedoids_pam_update(X, metric, medoid_inds, assignments, distances,
                         proposals=None, cost=_msq, random_state=None,
                         device=None):
    """One PAM sweep: for every medoid, propose a random member of its
    cluster as the replacement, recompute costs with the 3-case update,
    accept if the mean-square cost drops."""
    assignments = np.asarray(assignments)
    distances = np.asarray(distances, dtype=np.float64)
    assert np.issubdtype(assignments.dtype, np.integer)
    assert len(assignments) == len(X)
    assert len(distances) == len(X)

    random_state = check_random_state(random_state)

    if proposals is not None:
        if len(proposals) != len(medoid_inds):
            raise DataInvalid(
                "Length of 'proposals' didn't match length of "
                "'medoid_inds' ({} != {}).".format(
                    len(proposals), len(medoid_inds)))

    medoid_inds = list(medoid_inds)
    medoid_coords = [X[i] for i in medoid_inds]
    metric_name = util._metric_name(metric)

    acceptances = 0
    old_cost = new_cost = cost(distances)
    for cid in range(len(medoid_inds)):
        state_inds = np.where(assignments == cid)[0]
        if len(state_inds) == 0:
            continue

        if proposals is None:
            proposed_center, proposed_center_ind = \
                _propose_new_center_amongst(X, state_inds, random_state)
        else:
            proposed_center_ind = proposals[cid]
            proposed_center = X[proposed_center_ind]

        new_ctr_dist = np.asarray(
            metric(X, proposed_center)).reshape(-1)

        new_dist = np.full_like(distances, -1.0)
        new_assig = np.full_like(assignments, -1)

        # case 1: the proposal is closer than the current medoid
        # (whichever cluster the frame is in) -> reassign to cid
        dst_dn = distances > new_ctr_dist
        new_assig[dst_dn] = cid
        new_dist[dst_dn] = new_ctr_dist[dst_dn]

        # case 2: farther, and assigned elsewhere -> unchanged
        dst_up_other = (distances <= new_ctr_dist) & (assignments != cid)
        new_assig[dst_up_other] = assignments[dst_up_other]
        new_dist[dst_up_other] = distances[dst_up_other]

        # case 3: farther, but the frame was assigned to cid -> must be
        # re-assigned against ALL medoids (with cid replaced): for a
        # named metric one batched device call over the ambiguous subset
        dst_up_this = (distances <= new_ctr_dist) & (assignments == cid)
        new_medoids = medoid_coords.copy()
        new_medoids[cid] = proposed_center
        if metric_name is not None and np.count_nonzero(dst_up_this):
            subset = X[dst_up_this]
            subset = subset.xyz if hasattr(subset, 'xyz') else \
                np.asarray(subset)
            ambig_assigs, ambig_dists = engine.assign_device(
                subset,
                np.stack([np.asarray(m.xyz[0])
                          if hasattr(m, 'xyz') else np.asarray(m)
                          for m in new_medoids]),
                metric_name, device=device)
        else:
            ambig_assigs, ambig_dists = util.assign_to_nearest_center(
                X[dst_up_this], new_medoids, metric)
        new_assig[dst_up_this] = ambig_assigs
        new_dist[dst_up_this] = ambig_dists

        assert np.all(new_assig >= 0)
        assert np.all(new_dist >= 0)

        old_cost = cost(distances)
        new_cost = cost(new_dist)

        if new_cost < old_cost:
            distances, assignments = new_dist, new_assig
            medoid_coords = new_medoids
            medoid_inds[cid] = proposed_center_ind
            acceptances += 1

    logger.info('Kmedoid sweep reduced cost to %.7f (%.2f%% acceptance)',
                min(old_cost, new_cost),
                acceptances / max(len(medoid_inds), 1) * 100)
    return medoid_inds, distances, assignments, medoid_coords
