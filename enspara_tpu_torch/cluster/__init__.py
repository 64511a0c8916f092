"""Clustering by RMSD or by feature distances: k-centers, k-medoids and
k-hybrid."""

from .util import (ClusterResult, assign_to_nearest_center,  # noqa: F401
                   find_cluster_centers)
from .kcenters import KCenters, kcenters  # noqa: F401
from .kmedoids import KMedoids, kmedoids  # noqa: F401
from .hybrid import KHybrid, hybrid, hybrid_device  # noqa: F401
