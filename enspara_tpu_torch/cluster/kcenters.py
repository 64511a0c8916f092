"""K-centers (Gonzalez farthest-point) clustering by RMSD (counterpart
of ``enspara_tpu/cluster/kcenters.py`` for metric 'rmsd').

The search runs in :func:`enspara_tpu_torch.cluster.engine.
kcenters_device_fused`: on the card, the tri-skip CUDA kernel.
"""

from enspara_tpu.citation import cite
from enspara_tpu.exception import ImproperlyConfigured

from . import engine
from .util import ClusterResult, gather_frames

__all__ = ['KCenters', 'kcenters']

_INIT_CENTERS_TODO = (
    'init_centers needs the all-pairs QCP assignment kernel '
    '(qcp_rmsd_matrix_pallas), which is not ported yet: ROADMAP.md '
    'queue 1 step 5, queue 2 kernel 5')


class KCenters:
    """Sklearn-style k-centers estimator for metric 'rmsd'.

    Parameters
    ----------
    metric : 'rmsd'
    n_clusters : int, optional
    cluster_radius : float, optional
        Stop adding centers once the max frame-center distance falls to
        this value. At least one of n_clusters/cluster_radius is needed.
    device : torch device, optional
        Where to cluster host (numpy) input; tensors cluster where they
        lie.
    """

    def __init__(self, metric, n_clusters=None, cluster_radius=None,
                 device=None):
        if n_clusters is None and cluster_radius is None:
            raise ImproperlyConfigured(
                'Either n_clusters or cluster_radius is required for '
                'KCenters clustering')
        self.metric = metric
        self.n_clusters = n_clusters
        self.cluster_radius = cluster_radius
        self.device = device

    def fit(self, X, init_centers=None):
        self.result_ = kcenters(X, self.metric, n_clusters=self.n_clusters,
                                dist_cutoff=self.cluster_radius,
                                init_centers=init_centers,
                                device=self.device)
        return self

    @property
    def labels_(self):
        return self.result_.assignments

    @property
    def distances_(self):
        return self.result_.distances

    @property
    def center_indices_(self):
        return self.result_.center_indices

    @property
    def centers_(self):
        return self.result_.centers


@cite('kcenters')
def kcenters(traj, distance_method, n_clusters=None, dist_cutoff=None,
             init_centers=None, device=None):
    """Functional k-centers by RMSD. ``traj`` is ``(n, n_atoms, 3)``
    coordinates (numpy, a tensor, or anything with ``.xyz``).

    Returns a :class:`~enspara_tpu_torch.cluster.util.ClusterResult`
    with host arrays: assignments and distances of every frame, the
    center frame indices, and the center coordinates.
    """
    if n_clusters is None and dist_cutoff is None:
        raise ImproperlyConfigured(
            "KCenters must specify 'n_clusters' or 'dist_cutoff'")
    if distance_method != 'rmsd':
        raise NotImplementedError(
            "only distance_method='rmsd' is ported, got %r: the other "
            'metrics are ROADMAP.md queue 1 step 5' % (distance_method,))
    if init_centers is not None and len(init_centers):
        raise NotImplementedError(_INIT_CENTERS_TODO)
    xyz = traj.xyz if hasattr(traj, 'xyz') else traj
    res = engine.kcenters_device_fused(xyz, n_clusters=n_clusters,
                                       dist_cutoff=dist_cutoff,
                                       device=device)
    ctr_inds = list(res.center_indices)
    return ClusterResult(center_indices=ctr_inds,
                         assignments=res.assignments,
                         distances=res.distances,
                         centers=gather_frames(xyz, ctr_inds))
